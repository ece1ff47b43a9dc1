"""Training orchestration on one device: config, metric logging and the
train loop (counterpart of ``sav_tpu/train/loop.py``).

What runs: the synthetic source and real data (``.npz`` arrays and
shards, JPEG folders and tars through the host loader, augmented on the
device; eval on ``eval_dataset`` or a disjoint ``holdout_fraction`` tail,
without augmentation), the step loop with periodic metrics, evaluation
every ``eval_every_epochs`` and at the end, and checkpoints of the whole
state (``train/checkpoint.py``, with the loader's position) at the
checkpoint cadence, at the end and at the next step boundary after a
SIGTERM; each also rewrites ``params.npz``, the serving export (the flax
params tree, ``/`` keys, and a BatchNorm model's running statistics under
``batch_stats/``). A run restores the latest step in ``checkpoint_dir``,
or else starts from ``finetune_from``'s weights (``train/finetune.py``);
``profile_steps`` writes a ``torch.profiler`` trace. Mesh parallelism,
remat and chained dispatch are refused with their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
import warnings
from typing import Any, Dict, Optional, Union

import torch

from sav_tpu_torch import resolve_device
from sav_tpu_torch.data.pipeline import create_dataset, parse_dataset_spec
from sav_tpu_torch.models import create_model
from sav_tpu_torch.models.factory import resolve_num_classes
from sav_tpu_torch.train import steps as steps_lib
from sav_tpu_torch.train.checkpoint import (PARAMS_FILE, CheckpointManager,
                                            write_params_npz)
from sav_tpu_torch.train.finetune import load_pretrained
from sav_tpu_torch.train.state import (DTYPES, TrainState, build_optimizer,
                                       warmup_cosine_schedule,
                                       warmup_stable_decay_schedule)
from sav_tpu_torch.utils.flax_bridge import flax_to_torch, variables_of

IMAGENET_TRAIN_IMAGES = 1_281_167


@dataclasses.dataclass
class TrainConfig:
    """Typed training configuration; the JAX package's field names."""

    model_name: str = 'vit_b_patch16'
    img_size: int = 224
    num_epochs: int = 300
    batch_size: int = 32
    label_smoothing: float = 0.1
    augmentation: str = 'cutmix_mixup_randaugment_405'
    lr: float = 5e-4
    weight_decay: float = 1e-4
    clip_grad: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    seed: int = 42
    # None: a model.json spec's own head width, else 1000
    num_classes: Optional[int] = None
    dtype: str = 'bfloat16'
    dataset: str = 'synthetic'
    eval_dataset: Optional[str] = None
    holdout_fraction: float = 0.05
    images_per_epoch: int = IMAGENET_TRAIN_IMAGES
    total_steps: Optional[int] = None
    model_parallelism: int = 1
    pipeline_parallelism: int = 1
    pipeline_microbatches: int = 4
    remat: Union[bool, str] = False
    mu_dtype: Optional[str] = None
    ema_decay: Optional[float] = None
    schedule: str = 'cosine'            # 'cosine' | 'wsd'
    finetune_from: Optional[str] = None
    finetune_use_ema: bool = False
    pos_embed: str = 'learned'
    quantized: Union[bool, str] = False
    grad_accum: int = 1
    scan_layers: bool = False
    steps_per_dispatch: int = 1
    prefetch_chunks: int = 2
    data_workers: int = 0
    log_every: int = 100
    eval_every_epochs: int = 5
    checkpoint_every_epochs: int = 10
    eval_batches: Optional[int] = None
    profile_steps: Optional[tuple] = None   # (start_step, stop_step)
    profile_dir: Optional[str] = None       # None: <tmp>/sav_tpu_profile

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.images_per_epoch // self.batch_size)

    @property
    def steps_total(self) -> int:
        if self.total_steps is not None:
            return self.total_steps
        return self.steps_per_epoch * self.num_epochs


# field -> (the only value the port runs, what it waits for)
UNPORTED = {
    'prefetch_chunks': (2, 'chained dispatch over host data: Queue 1 '
                        'item 17'),
    'model_parallelism': (1, 'the parallel tier: Queue 1 item 13'),
    'pipeline_parallelism': (1, 'the parallel tier: Queue 1 item 13'),
    'pipeline_microbatches': (4, 'the parallel tier: Queue 1 item 13'),
    'scan_layers': (False, 'the scan-stacked layout: Queue 1 item 1'),
    'remat': (False, 'remat policies: Queue 1 item 2'),
    'steps_per_dispatch': (1, 'chained dispatch: Queue 1 item 17'),
}


def stochastic_depth_seed(seed: int, step: int) -> int:
    """Seed of step ``step``'s stochastic-depth stream: a function of the
    config seed and the step only, so a step's masks do not depend on what
    ran before it (the JAX package folds the step into its key)."""
    return (seed * 1_000_003 + step) % (2 ** 63)


def check_ported(config: TrainConfig) -> None:
    """Raises NotImplementedError on a field the port does not run yet."""
    for name, (value, item) in UNPORTED.items():
        if getattr(config, name) != value:
            raise NotImplementedError(
                f'{name}={getattr(config, name)!r} is not ported to '
                f'sav_tpu_torch yet ({item}, ROADMAP.md)')
    if config.quantized == 'all':
        raise ValueError(
            "quantized='all' is serving-only: its attention kernels (K10, "
            'K11) have no backward, as in the JAX package, whose train.py '
            "does not offer it; train with quantized='ff', 'ff_sb' or True "
            '(--quantized int8)')
    if config.quantized not in (False, True, 'ff', 'ff_sb'):
        raise ValueError(f"quantized must be False, True, 'ff' or 'ff_sb', "
                         f'got {config.quantized!r}')


class MetricLogger:
    """Scalar logger to stdout; also to wandb when asked and installed."""

    def __init__(self, use_wandb: bool = False, project: str = 'sav_tpu'):
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # optional; not installed in all environments
                wandb.init(project=project)
                self._wandb = wandb
            except ImportError:
                warnings.warn('wandb requested but not installed')

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        print(f'step {step}: ' + ' '.join(f'{k}={v:.5g}'
                                          for k, v in scalars.items()),
              flush=True)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)


class Trainer:
    """Builds the model, optimizer and state on one device and runs the
    training loop."""

    def __init__(self, config: TrainConfig, use_wandb: bool = False,
                 device=None):
        check_ported(config)
        if config.dtype not in DTYPES:
            raise ValueError(f'dtype must be one of {sorted(DTYPES)}, got '
                             f'{config.dtype!r}')
        if config.num_classes is None:
            config = dataclasses.replace(config, num_classes=resolve_num_classes(
                config.model_name, None))
        self.config = config
        self.device = resolve_device(device)
        self.checkpoints = None
        if config.checkpoint_dir:
            self.checkpoints = CheckpointManager(config.checkpoint_dir)
            export = os.path.join(config.checkpoint_dir, PARAMS_FILE)
            if (self.checkpoints.latest_step() is None
                    and os.path.exists(export)):
                raise ValueError(
                    f'{export} exists but {config.checkpoint_dir} holds no '
                    'step checkpoint: a params.npz carries no optimizer '
                    'state to resume from, and training from scratch would '
                    'overwrite it; pass a new -c directory, or this one as '
                    '--finetune_from')
        self._preempted = False
        model_kwargs = {}
        if config.pos_embed != 'learned':
            model_kwargs['pos_embed'] = config.pos_embed
        if config.quantized:
            model_kwargs['quantized'] = config.quantized
        self.model = create_model(config.model_name,
                                  num_classes=config.num_classes,
                                  dtype=DTYPES[config.dtype],
                                  img_size=config.img_size, seed=config.seed,
                                  device=self.device, **model_kwargs)
        if config.schedule == 'wsd':
            peak = config.lr * (config.batch_size / 512)
            self.schedule = warmup_stable_decay_schedule(
                peak, config.steps_total,
                warmup_steps=5 * config.steps_per_epoch,
                decay_steps=max(1, config.steps_total // 10))
        elif config.schedule == 'cosine':
            self.schedule = warmup_cosine_schedule(
                config.lr, config.batch_size, config.steps_per_epoch)
        else:
            raise ValueError(f"schedule must be 'cosine' or 'wsd', got "
                             f'{config.schedule!r}')
        self.optimizer = build_optimizer(self.model.parameters(), self.schedule,
                                         weight_decay=config.weight_decay,
                                         clip_grad=config.clip_grad,
                                         mu_dtype=config.mu_dtype)
        self.state = TrainState(self.model, self.optimizer,
                                ema=config.ema_decay is not None)
        restored_step = (self.checkpoints.latest_step()
                         if self.checkpoints is not None else None)
        if restored_step is not None:
            print(f'restoring checkpoint at step {restored_step}', flush=True)
            self.checkpoints.restore(self.state)
        elif config.finetune_from:
            self._finetune_from(config.finetune_from)
        # the stochastic-depth stream, reseeded from (seed, step) each step
        self.generator = torch.Generator(device=self.device)
        self.logger = MetricLogger(use_wandb=use_wandb)

    @property
    def checkpoint_path(self) -> Optional[str]:
        """The serving export, ``checkpoint_dir/params.npz``."""
        if not self.config.checkpoint_dir:
            return None
        return os.path.join(self.config.checkpoint_dir, PARAMS_FILE)

    def _finetune_from(self, directory: str) -> None:
        """The model's weights from ``directory``'s checkpoint, adapted to
        this geometry (``finetune.load_pretrained``); the optimizer starts
        fresh and the EMA from the adapted weights."""
        variables = variables_of(self.model)
        params, batch_stats, report = load_pretrained(
            directory, variables['params'], variables.get('batch_stats'),
            use_ema=self.config.finetune_use_ema)
        for line in report:
            print(f'finetune: {line}', flush=True)
        print(f'fine-tuning from {directory} ({len(report)} leaves adapted)',
              flush=True)
        loaded = {'params': params}
        if batch_stats:
            loaded['batch_stats'] = batch_stats
        self.model.load_state_dict(flax_to_torch(loaded), strict=True)
        self.state.reset_ema()

    def dataset(self, seed_offset: int = 0, training: bool = True):
        """The train (or eval) dataset on the Trainer's device. Eval data
        goes through ``eval_preprocess`` with no augmentation (the
        reference evaluates a clean split, data/input_pipeline.py:357-377).
        Where train and eval share one real source with no split given,
        eval takes the last ``holdout_fraction`` of its fixed permutation
        and training the rest: disjoint by construction."""
        c = self.config
        name = c.dataset if training else (c.eval_dataset or c.dataset)
        split = None
        base, inline = parse_dataset_spec(name)
        if (name != 'synthetic' and inline is None and c.eval_dataset is None
                and c.holdout_fraction and not base.startswith('tfds:')):
            h = c.holdout_fraction
            split = (('train', 0.0, 1.0 - h) if training
                     else ('holdout', 1.0 - h, 1.0))
            if training:
                print(f'no eval_dataset/split given: holding out the last '
                      f'{100 * h:.1f}% of {base!r} for eval', flush=True)
        return create_dataset(name, batch_size=c.batch_size,
                              image_size=c.img_size,
                              num_classes=c.num_classes,
                              seed=c.seed + seed_offset, device=self.device,
                              augmentation=c.augmentation, training=training,
                              num_workers=c.data_workers, split=split)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        c = self.config
        self.generator.manual_seed(stochastic_depth_seed(c.seed,
                                                         self.state.step))
        return steps_lib.train_step(self.state, batch,
                                    num_classes=c.num_classes,
                                    label_smoothing=c.label_smoothing,
                                    ema_decay=c.ema_decay,
                                    grad_accum=c.grad_accum,
                                    generator=self.generator)

    def evaluate(self, dataset,
                 num_batches: Optional[int] = None) -> Dict[str, float]:
        """Mean eval metrics over ``num_batches`` (``steps.
        mean_over_batches``: by default every batch of a finite source, 16
        of an endless one)."""
        use_ema = self.config.ema_decay is not None
        metrics, _ = steps_lib.mean_over_batches(
            lambda batch: steps_lib.eval_step(
                self.state, batch, num_classes=self.config.num_classes,
                use_ema=use_ema), dataset, num_batches)
        return metrics

    def save_checkpoint(self) -> None:
        """Writes the serving export ``checkpoint_dir/params.npz``: the
        params tree and, for a model with BatchNorm, its running statistics
        beside it under ``batch_stats/`` keys."""
        os.makedirs(self.config.checkpoint_dir, exist_ok=True)
        write_params_npz(self.checkpoint_path, variables_of(self.model))

    def _save(self, train_data) -> None:
        """A checkpoint of the whole state at its step, with the loader's
        position, and the serving export beside it."""
        data_state = (train_data.get_state()
                      if hasattr(train_data, 'get_state') else None)
        self.checkpoints.save(self.state.step, self.state,
                              data_state=data_state)
        self.save_checkpoint()

    def _restore_data_state(self, train_data) -> None:
        """Seeks the loader to its checkpointed position on resume."""
        if (self.checkpoints is None or self.state.step == 0
                or not hasattr(train_data, 'set_state')):
            return
        data_state = self.checkpoints.restore_data_state()
        if data_state is not None:
            train_data.set_state(data_state)

    def run(self) -> Dict[str, float]:
        """Runs the training loop with preemption-safe checkpointing: a
        SIGTERM checkpoints at the next step boundary and returns, so a run
        on the same ``checkpoint_dir`` continues where this one stopped."""
        def on_term(signum, frame):
            self._preempted = True
            print(f'received signal {signum}: checkpointing at the next '
                  'step boundary, then exiting', flush=True)

        old_handler = None
        try:
            old_handler = signal.signal(signal.SIGTERM, on_term)
        except ValueError:      # not the main thread
            pass
        train_data = self.dataset()
        eval_data = self.dataset(seed_offset=1, training=False)
        try:
            self._restore_data_state(train_data)
            return self._loop(train_data, eval_data)
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            for data in (train_data, eval_data):
                if hasattr(data, 'close'):
                    data.close()

    def _loop(self, train_data, eval_data) -> Dict[str, float]:
        c = self.config
        steps_per_eval = c.steps_per_epoch * c.eval_every_epochs
        steps_per_ckpt = c.steps_per_epoch * c.checkpoint_every_epochs
        last_metrics: Dict[str, float] = {}
        window_start = time.perf_counter()
        window_images = 0
        profiler = None
        try:
            for step in range(self.state.step, c.steps_total):
                if c.profile_steps and step == c.profile_steps[0]:
                    profiler = self._start_profile()
                metrics = self.train_step(train_data.batch(step))
                window_images += c.batch_size
                if c.profile_steps and step == c.profile_steps[1]:
                    self._stop_profile(profiler)
                    profiler = None
                if step % c.log_every == 0 or step == c.steps_total - 1:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    elapsed = time.perf_counter() - window_start
                    last_metrics['images_per_sec'] = (window_images
                                                      / max(elapsed, 1e-9))
                    last_metrics['learning_rate'] = float(self.schedule(step))
                    self.logger.log(last_metrics, step)
                    window_start = time.perf_counter()
                    window_images = 0

                next_step = step + 1
                if self.checkpoints is not None and (
                        (steps_per_ckpt and next_step % steps_per_ckpt == 0)
                        or next_step == c.steps_total or self._preempted):
                    self._save(train_data)
                if ((steps_per_eval and next_step % steps_per_eval == 0)
                        or next_step == c.steps_total):
                    eval_metrics = self.evaluate(eval_data, c.eval_batches)
                    self.logger.log(eval_metrics, next_step)
                    last_metrics.update(eval_metrics)
                if self._preempted:
                    break
        finally:
            if profiler is not None:
                profiler.__exit__(None, None, None)
            if self.checkpoints is not None:
                self.checkpoints.wait()
        return last_metrics

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profile(self, profiler) -> None:
        """Ends the window and writes its Chrome trace to ``profile_dir``."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        c = self.config
        directory = c.profile_dir or os.path.join(tempfile.gettempdir(),
                                                  'sav_tpu_profile')
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f'trace_steps_{c.profile_steps[0]}_'
                                       f'{c.profile_steps[1]}.json')
        profiler.export_chrome_trace(path)
        print(f'profile of steps {c.profile_steps[0]}-{c.profile_steps[1]} '
              f'written to {path}', flush=True)
