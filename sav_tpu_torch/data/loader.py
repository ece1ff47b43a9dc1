"""The host input pipeline for real datasets (counterpart of
``sav_tpu/data/grain_loader.py``, on ``torch.utils.data`` in place of
Grain).

The host reads raw records and collates uint8 frames; everything random
runs on the device (``sav_tpu_torch.data.pipeline``). ``HostDataset``
keeps ``GrainDataset``'s interface: ``batch(step)`` addressable by step
(a seek: forward or backward, the batch of a step is the same whatever ran
before it), ``num_batches``, and a zero-padded eval tail with a ``mask``.

Sources: ``NpzShardSource`` (``.npz`` shards of uint8 ``images`` and int
``labels``), the JPEG sources of ``jpeg_source``, and ``SubsetSource``,
which slices a fixed permutation of any of them: ``[:90%]`` and ``[90%:]``
select the same example indices as the JAX package's ``SubsetSource``.

Record order: training walks a fresh permutation of the source each epoch
(``torch.randperm`` seeded from ``(seed, epoch)``) as one continuous
stream that batches may straddle; eval walks the source once in order.
The permutations are not Grain's, so the port's train batches hold other
examples than the JAX package's at the same step; the eval batches are
the same. Workers (``num_workers``) are forked from a ``forkserver``
process, so they inherit neither the main process's CUDA state nor its
threads; they decode to numpy only and never touch CUDA. The main process
pins the collated batch, copies it to the card without blocking and
augments it there.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Sequence

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from sav_tpu_torch.data import pipeline, preprocess


class NpzShardSource:
    """Random-access source over ``.npz`` shards (a glob pattern or one
    file). Shards are opened lazily in each process: a loader pickles the
    source into its workers, and open files do not pickle. Only sizes are
    read at construction."""

    def __init__(self, pattern: str):
        self._pattern = pattern
        self._paths: Sequence[str] = sorted(glob.glob(pattern))
        if not self._paths:
            raise FileNotFoundError(f'no shards match {pattern!r}')
        sizes = []
        for path in self._paths:
            with np.load(path) as data:
                sizes.append(data['labels'].shape[0])
        self._offsets = np.cumsum([0] + sizes)
        self._shards = [None] * len(self._paths)

    def __repr__(self) -> str:
        return f'NpzShardSource({self._pattern!r}, n={len(self)})'

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _shard(self, index: int):
        data = self._shards[index]
        if data is None:
            with np.load(self._paths[index]) as npz:
                data = {'images': npz['images'], 'labels': npz['labels']}
            self._shards[index] = data
        return data

    def __getitem__(self, index: int):
        shard = int(np.searchsorted(self._offsets, index, side='right') - 1)
        local = index - self._offsets[shard]
        data = self._shard(shard)
        return {'image': data['images'][local],
                'label': np.int64(data['labels'][local])}

    def __getstate__(self):
        state = dict(self.__dict__)
        state['_shards'] = [None] * len(self._paths)
        return state


class SubsetSource:
    """The ``[lo, hi)`` slice of a fixed permutation of a source's indices
    (``pipeline.split_indices``, seed ``pipeline.PERM_SEED``): disjoint
    ranges are disjoint example sets, class-balanced in expectation. The
    seed is a constant, independent of the training seed, so both sides of
    a split agree on it across processes and runs."""

    def __init__(self, source, lo: float, hi: float):
        if not 0.0 <= lo < hi <= 1.0:
            raise ValueError(f'split range [{lo}:{hi}] must satisfy '
                             f'0 <= lo < hi <= 1')
        self._source = source
        self._lo, self._hi = float(lo), float(hi)
        self._indices = pipeline.split_indices(len(source), lo, hi)
        if hasattr(source, 'class_names'):
            self.class_names = source.class_names

    def indices(self) -> np.ndarray:
        """The source indices this subset holds, in its order."""
        return self._indices

    def __repr__(self) -> str:
        return (f'SubsetSource({self._source!r}, '
                f'[{self._lo:g}:{self._hi:g}])')

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, index: int):
        return self._source[int(self._indices[index])]


def write_npz_shards(images: np.ndarray, labels: np.ndarray,
                     directory: str, shard_size: int = 10000,
                     prefix: str = 'shard') -> list:
    """Exports arrays to the shard format ``NpzShardSource`` reads."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(0, len(labels), shard_size):
        path = os.path.join(directory,
                            f'{prefix}-{i // shard_size:05d}.npz')
        np.savez(path, images=images[i:i + shard_size],
                 labels=labels[i:i + shard_size])
        paths.append(path)
    return paths


class _Timed(Dataset):
    """A source whose records also carry the seconds their read and
    decode took (``decode_s``)."""

    def __init__(self, source):
        self.source = source

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, index: int):
        start = time.perf_counter()
        record = dict(self.source[index])
        record['decode_s'] = time.perf_counter() - start
        return record


def collate(records):
    """Stacks uint8 frames and int64 labels; sums each record's decode
    seconds and native-tier count (records without one count as not
    decoded)."""
    return {
        'image': torch.from_numpy(np.stack([r['image'] for r in records])),
        'label': torch.from_numpy(np.asarray([r['label'] for r in records],
                                             np.int64)),
        'decode_s': float(sum(r['decode_s'] for r in records)),
        'native': int(sum(int(r.get('native', 0)) for r in records)),
        'decoded': int(sum('native' in r for r in records)),
    }


class PositionSampler(Sampler):
    """Record indices from position ``start`` of the stream: training,
    the concatenation of per-epoch permutations (``torch.randperm`` from
    ``pipeline.step_generator(seed, epoch)``), endless; eval, ``0 .. n-1`` once. The loader
    reads ``start`` each time it makes an iterator, which is how
    ``HostDataset`` seeks."""

    def __init__(self, n: int, shuffle: bool, seed: int):
        self.n, self.shuffle, self.seed = n, shuffle, seed
        self.start = 0

    def epoch_order(self, epoch: int) -> torch.Tensor:
        return torch.randperm(self.n, generator=pipeline.step_generator(
            self.seed, epoch))

    def __iter__(self):
        if not self.shuffle:
            yield from range(self.start, self.n)
            return
        epoch, offset = divmod(self.start, self.n)
        while True:
            yield from self.epoch_order(epoch)[offset:].tolist()
            epoch, offset = epoch + 1, 0


class HostDataset:
    """Host loader + on-device transform, addressable by step.

    Training: ``num_batches`` is this source's whole batches an epoch, the
    stream is endless, and ``batch(step)`` augments on the device with a
    generator seeded from ``(seed, step)``. Eval: ``num_batches`` covers
    every example once; the last batch is zero-padded to ``batch_size``
    with ``mask`` 0 on the padding; ``batch(num_batches)`` raises
    StopIteration. ``stats`` counts batches, the host's wait for them, the
    decode seconds summed over records (in the workers) and the records the
    native tier decoded.
    """

    def __init__(self, source, batch_size: int, image_size: int,
                 augmentation: str = 'none', training: bool = True,
                 seed: int = 0, device='cpu', num_workers: int = 0):
        n = len(source)
        if training and n < batch_size:
            raise ValueError(f'{n} training examples make no batch of '
                             f'{batch_size}')
        self.source = source
        self.batch_size = batch_size
        self.image_size = image_size
        self.training = training
        self.seed = seed
        self.device = torch.device(device)
        self.config = pipeline.parse_augment_name(augmentation)
        self.num_batches = (n // batch_size if training
                            else -(-n // batch_size))
        self._sampler = PositionSampler(n, shuffle=training, seed=seed)
        extra = {}
        if num_workers > 0:
            extra = dict(multiprocessing_context='forkserver',
                         persistent_workers=True, prefetch_factor=2)
        self._loader = DataLoader(
            _Timed(source), batch_size=batch_size, sampler=self._sampler,
            drop_last=training, num_workers=num_workers, collate_fn=collate,
            pin_memory=self.device.type == 'cuda', **extra)
        self._iterator = None
        self._next_step = 0
        self.stats = {'batches': 0, 'wait_s': 0.0, 'decode_s': 0.0,
                      'native': 0, 'decoded': 0}

    def _raw(self, step: int):
        """The collated host batch of ``step`` (seeking when ``step`` is not
        the next one)."""
        if self._iterator is None or step != self._next_step:
            self._sampler.start = step * self.batch_size
            self._iterator = iter(self._loader)
        start = time.perf_counter()
        record = next(self._iterator)
        self.stats['wait_s'] += time.perf_counter() - start
        self._next_step = step + 1
        return record

    def batch(self, step: int):
        if not self.training and step >= self.num_batches:
            raise StopIteration
        record = self._raw(step)
        stats = self.stats
        stats['batches'] += 1
        stats['decode_s'] += record['decode_s']
        stats['native'] += record['native']
        stats['decoded'] += record['decoded']
        images = record['image'].to(self.device, non_blocking=True)
        labels = record['label'].to(self.device, non_blocking=True)
        if self.training:
            gen = pipeline.step_generator(self.seed, step)
            draws = pipeline.draw(gen, self.batch_size,
                                  tuple(images.shape[1:3]), self.config,
                                  self.image_size, device=self.device)
            return pipeline.apply(images, labels, draws, self.config,
                                  self.image_size)
        valid = images.shape[0]
        if valid < self.batch_size:
            # pad the ragged eval tail to a static shape; the mask says
            # which rows are real (reference: input_pipeline.py:360-376)
            pad = self.batch_size - valid
            images = torch.cat([images, images.new_zeros(
                (pad,) + tuple(images.shape[1:]))])
            labels = torch.cat([labels, labels.new_zeros(pad)])
        mask = (torch.arange(self.batch_size, device=self.device)
                < valid).to(torch.float32)
        return {'images': preprocess.eval_preprocess(
            images.to(torch.float32), self.image_size),
            'labels': labels, 'mask': mask}

    def __iter__(self):
        step = 0
        while self.training or step < self.num_batches:
            yield self.batch(step)
            step += 1

    def get_state(self) -> bytes:
        """The loader's position, for a checkpoint: the next step, and the
        batch size and source length that give the step its records, as
        JSON."""
        return json.dumps({'next_step': self._next_step,
                           'batch_size': self.batch_size,
                           'examples': len(self.source)}).encode()

    def set_state(self, state: bytes) -> None:
        """Seeks to a ``get_state`` position: the next ``batch`` reads the
        saved step's records (one seek, ``PositionSampler.start``). Raises
        where the batch size or the source length differ, since the same
        step would then hold other records."""
        saved = json.loads(state)
        here = {'batch_size': self.batch_size, 'examples': len(self.source)}
        if {k: saved[k] for k in here} != here:
            raise ValueError(f'loader state {saved} was saved over another '
                             f'source or batch size ({here})')
        self._iterator = None
        self._next_step = saved['next_step']

    def close(self) -> None:
        """Stops the loader's worker processes (kept between iterators:
        ``persistent_workers``)."""
        self._iterator = None
        iterator, self._loader._iterator = self._loader._iterator, None
        shutdown = getattr(iterator, '_shutdown_workers', None)
        if shutdown is not None:
            shutdown()

