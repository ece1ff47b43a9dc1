"""Train and eval steps on one device (counterpart of
``sav_tpu/train/steps.py``; mesh sharding, remat and the chained and
pipeline builders wait for later slices, ROADMAP.md Queue 1)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from sav_tpu_torch.nn.regularization import set_stochastic_depth_generator
from sav_tpu_torch.train.state import TrainState
from sav_tpu_torch.utils.metrics import topk_correct


def blended_targets(batch: Dict[str, torch.Tensor], num_classes: int,
                    label_smoothing: float) -> torch.Tensor:
    """One-hot f32 targets with optional mixup/cutmix blending
    (``mix_labels`` and per-example ``ratio``) and label smoothing."""
    y = F.one_hot(batch['labels'].long(), num_classes).float()
    if 'mix_labels' in batch:
        y_mix = F.one_hot(batch['mix_labels'].long(), num_classes).float()
        ratio = batch['ratio'][:, None]
        y = ratio * y + (1.0 - ratio) * y_mix
    if label_smoothing:
        y = (1.0 - label_smoothing) * y + label_smoothing / num_classes
    return y


def softmax_cross_entropy(logits, targets):
    """Per-example ``-sum(targets * log_softmax(logits))``."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(dim=-1)


def loss_and_logits(model, batch, num_classes, label_smoothing):
    """(mean loss, f32 logits) of ``model`` on ``batch``."""
    logits = model(batch['images'].to(model.dtype)).float()
    targets = blended_targets(batch, num_classes, label_smoothing)
    return softmax_cross_entropy(logits, targets).mean(), logits


def _metrics(loss, logits, labels):
    metrics = {'loss': loss.detach()}
    acc = topk_correct(logits.detach(), labels, prefix='train_')
    metrics.update({k: v.mean() for k, v in acc.items()})
    return metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
               num_classes: int, label_smoothing: float, ema_decay=None,
               grad_accum: int = 1,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``state`` (updated in place); returns the
    metrics as 0-d tensors on the device (reading them waits for it).

    Loss: mean softmax cross-entropy of the f32 logits against
    ``blended_targets``. ``grad_accum > 1`` splits the batch into that many
    equal microbatches, sums their gradients, scales the sum by
    ``1/grad_accum`` and applies one update, as the JAX package does.
    ``generator`` (on the model's device) is the stochastic-depth stream,
    the JAX package's ``'stochastic_depth'`` key: each microbatch draws its
    masks from it in turn, so microbatches get different noise. Models
    without stochastic depth never read it. The model runs in training
    mode, so BatchNorm running statistics (module buffers, flax's
    ``batch_stats``) update once per forward: once a step, or once per
    microbatch in order, as the JAX package threads them through its
    ``lax.scan``.
    """
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    set_stochastic_depth_generator(model, generator)
    try:
        metrics = _accumulate(model, batch, num_classes, label_smoothing,
                              grad_accum)
    finally:
        set_stochastic_depth_generator(model, None)
    state.apply_gradients(ema_decay)
    return metrics


def _accumulate(model, batch, num_classes, label_smoothing, grad_accum):
    """Gradients of the batch (or its microbatches) into ``p.grad``;
    returns the metrics."""
    if grad_accum == 1:
        loss, logits = loss_and_logits(model, batch, num_classes,
                                       label_smoothing)
        loss.backward()
        metrics = _metrics(loss, logits, batch['labels'])
    else:
        b = batch['images'].shape[0]
        if b % grad_accum:
            raise ValueError(f'batch {b} not divisible by grad_accum {grad_accum}')
        m = b // grad_accum
        sums = None
        for i in range(grad_accum):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, logits = loss_and_logits(model, mb, num_classes,
                                           label_smoothing)
            loss.backward()
            part = _metrics(loss, logits, mb['labels'])
            sums = part if sums is None else {k: sums[k] + part[k] for k in sums}
        inv = 1.0 / grad_accum
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.mul_(inv)
        metrics = {k: v * inv for k, v in sums.items()}
    return metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
              num_classes: int, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """``eval_sums`` of the state's model; with ``use_ema`` only the
    parameters are swapped for their EMA, and the live running statistics
    are used, as the JAX package's ``variables(use_ema=True)``."""
    params = state.ema_params if use_ema else None
    return eval_sums(state.model, batch, num_classes, params)


@torch.no_grad()
def eval_sums(model, batch: Dict[str, torch.Tensor], num_classes: int,
              params: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """Summed loss and top-k correct counts over the valid examples
    (``mask``-aware, so padded eval batches do not skew the average), and
    ``eval_count``. The model runs in eval mode (BatchNorm on its running
    statistics), on ``params`` (``{name: tensor}``) in place of its own
    where given."""
    model.eval()
    images = batch['images'].to(model.dtype)
    if params is not None:
        from torch.func import functional_call   # heavy import, EMA only
        logits = functional_call(model, params, (images,))
    else:
        logits = model(images)
    logits = logits.float()
    y = F.one_hot(batch['labels'].long(), num_classes).float()
    per_example = softmax_cross_entropy(logits, y)
    mask = batch.get('mask')
    if mask is None:
        mask = torch.ones_like(per_example)
    acc = topk_correct(logits, batch['labels'], mask=mask, prefix='eval_')
    sums = {'eval_loss': (per_example * mask).sum(), 'eval_count': mask.sum()}
    sums.update({k: v.sum() for k, v in acc.items()})
    return sums


def mean_over_batches(sums_of, dataset, num_batches: Optional[int] = None):
    """``(per-example means, examples counted)`` of ``sums_of(batch)``
    (``eval_sums``-shaped) over ``num_batches`` batches of ``dataset``: by
    default every batch of a finite source (its ``num_batches``), 16 of an
    endless one, as in the JAX package; a finite source that ends early
    stops the walk (``StopIteration``). Empty means, count 0, where no
    batch came."""
    if num_batches is None:
        num_batches = getattr(dataset, 'num_batches', None) or 16
    sums = None
    for step in range(num_batches):
        try:
            batch = dataset.batch(step)
        except StopIteration:
            break
        out = sums_of(batch)
        sums = out if sums is None else {k: sums[k] + out[k] for k in sums}
    if sums is None:
        return {}, 0.0
    count = float(sums.pop('eval_count'))
    return ({k: float(v) / max(count, 1.0) for k, v in sums.items()}, count)
