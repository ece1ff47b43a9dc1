#!/usr/bin/env python3
"""Carries a JAX Trainer's Orbax checkpoint into the torch port's layout
(``sav_tpu_torch/train/checkpoint.py``), so the port resumes, fine-tunes
from or scores it on a host without JAX.

Runs where JAX is (the port never imports this file). The Orbax step is
restored through ``sav_tpu.train.checkpoint.CheckpointManager`` into a
template of the run's TrainState, built from the flags that shape it
(model, image size, classes, clip, weight decay, first-moment dtype,
EMA), and written through the port's ``CheckpointManager``: params,
batch_stats, EMA, Adam's moments, optax's count and the step. Adam's
state is found in the optax chain by its type (its index moves with
``--clip_grad`` and ``--weight_decay``), and the schedule's count must
equal Adam's. A bf16 first moment is stored widened to f32, exactly. The
loader position (Grain's iterator state) is not carried: the port's
loader seeks by step.

    python scripts/convert_orbax_to_torch.py --src /ckpts/orbax \\
        --dst /ckpts/torch -m vit_b_patch16 [--ema] [--clip_grad 1.0]
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sav_tpu.models import create_model  # noqa: E402
from sav_tpu.train.checkpoint import CheckpointManager as OrbaxManager  # noqa: E402
from sav_tpu.train.state import TrainState, build_optimizer  # noqa: E402
from sav_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402


def template_state(model_name: str, img_size: int, num_classes: int,
                   clip_grad=None, weight_decay: float = 1e-4,
                   mu_dtype=None, ema: bool = False, **model_kwargs):
    """The abstract TrainState of a JAX Trainer run with these settings
    (shapes and dtypes only: nothing is initialised)."""
    model = create_model(model_name, num_classes=num_classes, **model_kwargs)
    # only the chain's structure matters: a callable schedule, as the
    # Trainer's, gives it a ScaleByScheduleState
    tx = build_optimizer(lambda count: 0.0, weight_decay=weight_decay,
                         clip_grad=clip_grad, mu_dtype=mu_dtype)

    def create():
        variables = model.init(jax.random.PRNGKey(0),
                               jnp.ones((1, img_size, img_size, 3)),
                               is_training=False)
        return TrainState.create(variables, tx, ema=ema)

    return jax.eval_shape(create)


def _host(tree):
    """numpy f32-or-native copies (bf16 widened: numpy has no bf16)."""
    def leaf(x):
        x = np.asarray(x)
        return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x
    return jax.tree_util.tree_map(leaf, tree)


def torch_tree(state) -> dict:
    """The port's ``TrainState.state_tree`` layout of a restored JAX
    TrainState."""
    chain = state.opt_state
    adams = [s for s in chain if isinstance(s, optax.ScaleByAdamState)]
    if len(adams) != 1:
        raise ValueError(f'expected one ScaleByAdamState in the optax chain, '
                         f'found {len(adams)}: {[type(s) for s in chain]}')
    adam = adams[0]
    count = int(adam.count)
    for s in chain:
        if (isinstance(s, optax.ScaleByScheduleState)
                and int(s.count) != count):
            raise ValueError(f"the schedule's count {int(s.count)} differs "
                             f"from Adam's {count}")
    return {'step': np.asarray(int(state.step), np.int64),
            'params': _host(state.params),
            'batch_stats': _host(state.batch_stats or {}),
            'ema_params': (None if state.ema_params is None
                           else _host(state.ema_params)),
            'opt_state': {'count': np.asarray(count, np.int64),
                          'mu': _host(adam.mu), 'nu': _host(adam.nu)}}


def convert(src: str, dst: str, step=None, **template_kwargs) -> int:
    """Converts step ``step`` (default: the latest) of ``src``; returns it."""
    orbax = OrbaxManager(src)
    try:
        step = orbax.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f'no Orbax checkpoint in {src}')
        state = orbax.restore(template_state(**template_kwargs), step=step)
    finally:
        orbax.close()
    out = CheckpointManager(dst)
    try:
        out.write(step, torch_tree(state))
    finally:
        out.close()
    return step


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--src', required=True, help='Orbax checkpoint directory')
    p.add_argument('--dst', required=True, help="the port's directory")
    p.add_argument('--step', type=int, default=None)
    p.add_argument('-m', '--model_name', required=True)
    p.add_argument('-s', '--img_size', type=int, default=224)
    p.add_argument('--num_classes', type=int, default=1000)
    p.add_argument('--clip_grad', type=float, default=None)
    p.add_argument('--weight_decay', type=float, default=1e-4)
    p.add_argument('--mu_dtype', default=None)
    p.add_argument('--ema', action='store_true',
                   help='the run kept an EMA (--ema_decay)')
    p.add_argument('--pos_embed', default='learned')
    a = p.parse_args(argv)
    kwargs = {} if a.pos_embed == 'learned' else {'pos_embed': a.pos_embed}
    step = convert(a.src, a.dst, a.step, model_name=a.model_name,
                   img_size=a.img_size, num_classes=a.num_classes,
                   clip_grad=a.clip_grad, weight_decay=a.weight_decay,
                   mu_dtype=a.mu_dtype, ema=a.ema, **kwargs)
    print(f'converted step {step} of {a.src} into {a.dst}')


if __name__ == '__main__':
    main()
