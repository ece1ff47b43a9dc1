"""Train state, optimizer and schedules (counterpart of
``sav_tpu/train/state.py``).

The optimizer is the JAX package's optax chain, written out as one
``torch.optim.Optimizer``: global-norm clip -> Adam scaling ->
additive weight decay -> scale by -lr(count). ``torch.optim.AdamW`` is not
it: AdamW decays by ``lr * wd * p`` before the Adam step and counts its
schedule from 1, where the chain adds ``wd * p`` to the Adam direction and
reads the learning rate at the count *before* the increment (so a warmup
schedule that starts at 0 makes the first update exactly zero).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from sav_tpu_torch.utils.flax_bridge import (flax_to_torch, torch_to_flax,
                                             variables_of)

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


class AdamChain(torch.optim.Optimizer):
    """optax ``chain(clip_by_global_norm(clip_grad), scale_by_adam(b1, b2,
    eps, mu_dtype), add_decayed_weights(weight_decay), scale(-lr))``.

    * The clip scales every gradient by ``max_norm / |g|`` only when the
      global norm ``|g|`` is not below ``max_norm`` (no epsilon, unlike
      ``torch.nn.utils.clip_grad_norm_``).
    * The first moment is stored in ``mu_dtype`` (e.g. bf16) but updated
      and bias-corrected in f32, cast only when stored, as optax does; the
      second moment stays f32.
    * The decay has no mask: every parameter decays, LayerNorm and cls
      included, as in the JAX package.
    """

    def __init__(self, params, learning_rate: Union[float, Callable],
                 weight_decay: float = 1e-4, clip_grad: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype=None):
        super().__init__(params, dict(lr=learning_rate))
        self.weight_decay, self.clip_grad = weight_decay, clip_grad
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = DTYPES[mu_dtype] if isinstance(mu_dtype, str) else mu_dtype
        self.count = 0          # updates applied: optax's shared counter

    def learning_rate(self, count: int) -> float:
        lr = self.param_groups[0]['lr']
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a gradient. The arithmetic is
        written with ``torch._foreach_*`` ops (a few launches for all
        parameters instead of ~17 per parameter), in optax's order."""
        params = [p for group in self.param_groups for p in group['params']
                  if p.grad is not None]
        if not params:
            return
        grads = [p.grad for p in params]
        if self.clip_grad is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm([g.float() for g in grads])))
            # g / |g| * max_norm only when |g| >= max_norm, as optax selects
            keep = norm < self.clip_grad
            grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0, self.clip_grad))
        for p in params:
            if not self.state[p]:
                self.state[p]['mu'] = torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype)
                self.state[p]['nu'] = torch.zeros_like(p)
        mus = [self.state[p]['mu'] for p in params]
        nus = [self.state[p]['nu'] for p in params]
        count = self.count + 1
        # 1 - decay**count in f32, as optax's bias correction
        bc1, bc2 = (1 - torch.tensor([self.b1, self.b2], dtype=torch.float32)
                    ** count).tolist()
        # the decay meets the stored moment in its own dtype (optax's
        # weak-typed python float): b1 is rounded to bf16 for a bf16 mu
        decay = torch.tensor(self.b1, dtype=mus[0].dtype).item()
        mu = torch._foreach_mul(grads, 1 - self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(mus, decay))
        nu = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(nu, 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(nus, self.b2))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, denom)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(u, -self.learning_rate(self.count))
        torch._foreach_add_(params, u)
        for p, m, v in zip(params, mu, nu):
            self.state[p]['mu'] = m.to(self.state[p]['mu'].dtype)
            self.state[p]['nu'] = v
        self.count += 1


def build_optimizer(params, learning_rate: Union[Callable[[int], float], float],
                    weight_decay: float = 1e-4,
                    clip_grad: Optional[float] = None, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8,
                    mu_dtype=None) -> AdamChain:
    """Reference-recipe optimizer: clip | adam | weight decay | -lr.

    ``mu_dtype='bfloat16'`` stores the first Adam moment in bf16 (params and
    the second moment stay f32).
    """
    return AdamChain(params, learning_rate, weight_decay, clip_grad, b1, b2,
                     eps, mu_dtype)


def _linear(init: float, end: float, steps: int, count: float) -> float:
    if steps <= 0:
        return init
    frac = 1 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def warmup_cosine_schedule(base_lr: float, batch_size: int,
                           steps_per_epoch: int, warmup_epochs: int = 5,
                           decay_epochs: int = 30, end_value: float = 1e-5):
    """Linear-scaled warmup-cosine schedule (optax
    ``warmup_cosine_decay_schedule`` with init 0 and peak
    ``base_lr * batch_size / 512``)."""
    peak = base_lr * (batch_size / 512)
    warmup = warmup_epochs * steps_per_epoch
    decay = decay_epochs * steps_per_epoch - warmup
    if decay <= 0:
        raise ValueError(f'decay_epochs {decay_epochs} must exceed '
                         f'warmup_epochs {warmup_epochs}')
    alpha = 0.0 if peak == 0.0 else end_value / peak

    def schedule(count: int) -> float:
        if count < warmup:
            return _linear(0.0, peak, warmup, count)
        t = min(count - warmup, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay))
                       + alpha)

    return schedule


def warmup_stable_decay_schedule(peak_lr: float, total_steps: int,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 1e-5):
    """WSD: linear warmup -> constant plateau -> linear decay to end_value."""
    stable = max(0, total_steps - warmup_steps - decay_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return _linear(0.0, peak_lr, warmup_steps, count)
        if count < warmup_steps + stable:
            return peak_lr
        return _linear(peak_lr, end_value, decay_steps,
                       count - warmup_steps - stable)

    return schedule


class TrainState:
    """What a train step updates: the model's parameters (in the module),
    the optimizer and its moments, the step, and an optional EMA of the
    parameters (f32 copies) for evaluation.

    ``state_tree`` and ``load_state_tree`` carry all of it as the JAX
    TrainState's fields, flax trees of numpy arrays: ``{'step', 'params',
    'batch_stats', 'ema_params', 'opt_state': {'count', 'mu', 'nu'}}``
    (``count`` is optax's shared counter, the one the schedule reads).
    A bf16 ``mu`` is carried widened to f32, which is exact, and narrowed
    back to ``mu_dtype`` on load."""

    def __init__(self, model: torch.nn.Module, optimizer: AdamChain,
                 ema: bool = False):
        self.model, self.optimizer = model, optimizer
        self.step = 0
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in model.named_parameters()}
            if ema else None)

    def apply_gradients(self, ema_decay: Optional[float] = None) -> None:
        """One optimizer update from the parameters' ``.grad``, then the
        EMA ``e * decay + p * (1 - decay)``; clears the gradients."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.ema_params is not None and ema_decay is not None:
            with torch.no_grad():
                named = list(self.model.named_parameters())
                emas = [self.ema_params[name] for name, _ in named]
                torch._foreach_mul_(emas, ema_decay)
                torch._foreach_add_(emas, torch._foreach_mul(
                    [p.to(e.dtype) for (_, p), e in zip(named, emas)],
                    1.0 - ema_decay))
        self.step += 1

    def reset_ema(self) -> None:
        """The EMA restarts from copies of the current parameters (a
        fine-tune start), where it keeps one."""
        if self.ema_params is not None:
            self.ema_params = {n: p.detach().clone()
                               for n, p in self.model.named_parameters()}

    def state_tree(self) -> dict:
        """Host copies of the whole state (class docstring). Moments not
        made yet (before the first update) are zeros, as optax's init."""
        opt = self.optimizer
        named = dict(self.model.named_parameters())
        moments = {key: {n: opt.state[p][key] if opt.state[p]
                         else torch.zeros_like(p) for n, p in named.items()}
                   for key in ('mu', 'nu')}
        variables = variables_of(self.model)
        return {'step': np.asarray(self.step, np.int64),
                'params': variables['params'],
                'batch_stats': variables.get('batch_stats', {}),
                'ema_params': (None if self.ema_params is None
                               else torch_to_flax(self.ema_params)),
                'opt_state': {'count': np.asarray(opt.count, np.int64),
                              'mu': torch_to_flax(moments['mu']),
                              'nu': torch_to_flax(moments['nu'])}}

    def load_state_tree(self, tree: dict) -> None:
        """Sets the whole state from a ``state_tree``-shaped tree. Raises
        on a missing or unexpected leaf, and where the tree holds an EMA
        and this state keeps none, or the other way round."""
        has_ema = tree.get('ema_params') is not None
        if has_ema != (self.ema_params is not None):
            raise ValueError(
                f'the checkpoint {"holds" if has_ema else "holds no"} '
                f'ema_params but this run keeps {"no" if has_ema else "an"} '
                'EMA (ema_decay); train on with the same ema_decay setting')
        variables = {'params': tree['params']}
        if tree.get('batch_stats'):
            variables['batch_stats'] = tree['batch_stats']
        self.model.load_state_dict(flax_to_torch(variables), strict=True)
        named = dict(self.model.named_parameters())

        def named_tree(key, sub):
            flat = flax_to_torch(sub)
            if flat.keys() != named.keys():
                raise ValueError(
                    f'checkpoint {key} does not match the model: missing '
                    f'{sorted(named.keys() - flat.keys())[:5]}, unexpected '
                    f'{sorted(flat.keys() - named.keys())[:5]}')
            return flat

        opt = self.optimizer
        mu = named_tree('opt_state/mu', tree['opt_state']['mu'])
        nu = named_tree('opt_state/nu', tree['opt_state']['nu'])
        for name, p in named.items():
            opt.state[p] = {
                'mu': mu[name].to(p.device, opt.mu_dtype or p.dtype),
                'nu': nu[name].to(p.device, p.dtype)}
        opt.count = int(tree['opt_state']['count'])
        if has_ema:
            ema = named_tree('ema_params', tree['ema_params'])
            self.ema_params = {n: ema[n].to(p.device, self.ema_params[n].dtype)
                               for n, p in named.items()}
        self.step = int(tree['step'])
