"""Checkpoints of the whole train state, with resume (counterpart of
``sav_tpu/train/checkpoint.py``, with the JAX class's names).

The JAX package writes Orbax checkpoints, which need JAX to read. The
port writes a layout of its own, one directory a step:

    <directory>/<step>/state.npz   the TrainState tree (``TrainState.
                                   state_tree``) flattened with ``/`` keys:
                                   ``step``, ``params/...``,
                                   ``batch_stats/...``, ``ema_params/...``,
                                   ``opt_state/{count,mu/...,nu/...}``
    <directory>/<step>/data.bin    the input loader's position, when given

A step is written under a temporary name that starts with ``.`` and
renamed when complete, so a killed save leaves no step that
``latest_step`` returns; steps beyond ``keep`` are pruned, oldest first.
``scripts/convert_orbax_to_torch.py`` carries an Orbax checkpoint into
this layout where JAX is installed. A directory holding only the
``params.npz`` that the Trainer also writes (and that earlier versions of
the port wrote alone) reads as an inference checkpoint: params and
running statistics, no EMA.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np

from sav_tpu_torch.utils.flax_bridge import flatten_tree, unflatten_tree

STATE_FILE = 'state.npz'
DATA_FILE = 'data.bin'
PARAMS_FILE = 'params.npz'


def write_params_npz(path: str, variables: dict) -> None:
    """Writes the serving export: the flax params tree flattened with
    ``/`` keys, a BatchNorm model's running statistics beside it under
    ``batch_stats/``; through a temporary file, renamed when complete."""
    flat = flatten_tree(variables['params'])
    if variables.get('batch_stats'):
        flat.update(flatten_tree(variables['batch_stats'], 'batch_stats'))
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def read_params_npz(path: str) -> dict:
    """``{'params': ..., 'batch_stats': ...}`` of a ``params.npz``
    (``batch_stats`` empty where the file holds none)."""
    with np.load(path) as npz:
        tree = unflatten_tree({k: npz[k] for k in npz.files})
    return {'params': tree, 'batch_stats': tree.pop('batch_stats', {})}


class CheckpointManager:
    """Saves and restores ``TrainState``s in ``directory`` (module
    docstring). ``save`` copies the state to the host before it returns
    and writes it on a background thread; ``wait`` joins that write and
    raises what it raised. The directory is made at the first save."""

    def __init__(self, directory: str, keep: int = 3):
        self._directory = os.path.abspath(directory)
        self._keep = keep
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._directory, str(step))

    def steps(self) -> list:
        """The complete steps in the directory, oldest first."""
        if not os.path.isdir(self._directory):
            return []
        return sorted(int(name) for name in os.listdir(self._directory)
                      if name.isdigit()
                      and os.path.isdir(self._step_dir(int(name))))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, data_state: Optional[bytes] = None):
        """Checkpoints ``state`` (a ``TrainState``) as step ``step``."""
        self.write(step, state.state_tree(), data_state)

    def write(self, step: int, tree: dict, data_state: Optional[bytes] = None):
        """Checkpoints a ``TrainState.state_tree``-shaped tree of host
        arrays (what the converter from Orbax hands over)."""
        self.wait()
        flat = flatten_tree({k: v for k, v in tree.items() if v is not None})
        self._pending = self._executor.submit(self._write, step, flat,
                                              data_state)

    def _write(self, step, flat, data_state):
        os.makedirs(self._directory, exist_ok=True)
        tmp = os.path.join(self._directory, f'.tmp-{step}-{os.getpid()}')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), 'wb') as f:
            np.savez(f, **flat)
        if data_state is not None:
            with open(os.path.join(tmp, DATA_FILE), 'wb') as f:
                f.write(data_state)
        final = self._step_dir(step)
        if os.path.exists(final):       # a step saved again replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self._keep]:
            shutil.rmtree(self._step_dir(old))

    def _read(self, step: int, parts=None) -> dict:
        """Step ``step``'s tree; with ``parts``, only those top-level
        fields are read (the file reads lazily, a field at a time)."""
        path = os.path.join(self._step_dir(step), STATE_FILE)
        with np.load(path) as npz:
            tree = unflatten_tree({k: npz[k] for k in npz.files
                                   if parts is None
                                   or k.split('/', 1)[0] in parts})
        tree.setdefault('batch_stats', {})
        tree.setdefault('ema_params', None)
        return tree

    def restore(self, state, step: Optional[int] = None):
        """Loads step ``step`` (default: the latest) into ``state`` (a
        ``TrainState``) and returns it; with no step saved, ``state`` as
        it is. A partial or unreadable step raises."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        state.load_state_tree(self._read(step))
        return state

    def restore_for_inference(self, step: Optional[int] = None):
        """The serving leaves, ``{'params', 'batch_stats', 'ema_params',
        'step'}``, as flax trees of numpy arrays, with no optimizer
        template. With no step saved: a ``params.npz`` in the directory
        (params and running statistics, ``ema_params`` None, ``step``
        None), else None."""
        step = self.latest_step() if step is None else step
        if step is None:
            legacy = os.path.join(self._directory, PARAMS_FILE)
            if not os.path.exists(legacy):
                return None
            return dict(read_params_npz(legacy), ema_params=None, step=None)
        tree = self._read(step, ('step', 'params', 'batch_stats',
                                 'ema_params'))
        return {'params': tree['params'], 'batch_stats': tree['batch_stats'],
                'ema_params': tree['ema_params'], 'step': int(tree['step'])}

    def restore_data_state(self, step: Optional[int] = None
                           ) -> Optional[bytes]:
        """The loader position saved with the checkpoint, if any."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self._step_dir(step), DATA_FILE)
        if not os.path.exists(path):
            return None
        with open(path, 'rb') as f:
            return f.read()

    def wait(self):
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._executor.shutdown()
