"""The train augmentation and the dataset factory (counterpart of
``sav_tpu/data/pipeline.py``).

The augmentation is the JAX package's, batched on the device: random
resized crop + flip, RandAugment, color jitter, normalize, random erasing,
then batch-level mixup/cutmix. It is split in two calls:

- ``draw(generator, batch, frame, config, image_size)`` makes every random
  parameter of a batch from one ``torch.Generator`` (crop windows, flip
  bits, RandAugment ops, levels, signs and apply bits, jitter orders and
  factors, erase boxes and noise, the mix branch and gate, Beta weights,
  the partner permutation and cutmix boxes). The small ones stay on the
  host, which lets ``apply`` group examples by drawn op without a device
  sync; the erase noise is drawn on ``device``.
- ``apply(images, labels, draws, config, image_size)`` is deterministic:
  the same draws give the same batch on any device, and draws taken by the
  JAX package's key tree give its batch.

The augmentation-name grammar (``parse_augment_name``) and the split
grammar (``parse_split_fractions``) are the JAX package's, with the same
results for every string. Datasets: ``synthetic`` (made on the device),
``synthetic_augmented`` and ``.npz`` arrays (``AugmentedArrayDataset``:
uint8 frames resident on the device), and through the host loader
(``loader.HostDataset``) npz shard globs and directories, ``.tar``
archives of JPEGs and ImageFolder trees. ``tfds:`` needs
``tensorflow_datasets`` and raises the JAX package's ImportError without
it.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import numpy as np
import torch

from sav_tpu_torch.data import color, image_ops, mix, preprocess
from sav_tpu_torch.data.randaugment import RandAugment

_SPLIT_FMT = re.compile(
    r'(?P<name>[A-Za-z_]\w*)?'
    r'(?:\[(?P<lo>\d+(?:\.\d+)?)?\s*%?:(?P<hi>\d+(?:\.\d+)?)?\s*%?\])?')

# fixed by contract (the JAX package's ``SubsetSource._PERM_SEED``): the
# permutation that train/eval splits of one source slice
PERM_SEED = 0x5A5F


def parse_split_fractions(spec: str):
    """Parses a TFDS-style split spec into ``(name, lo, hi)`` fractions.

    ``'train[:90%]' -> ('train', 0.0, 0.9)``; ``'train[90%:]' ->
    ('train', 0.9, 1.0)``; ``'validation' -> ('validation', 0.0, 1.0)``;
    a bare range ``'[5%:15%]'`` defaults the name to 'train'. For every
    source but ``tfds:`` the name is cosmetic and the fractions select a
    slice of a fixed permutation (``loader.SubsetSource``).
    """
    m = _SPLIT_FMT.fullmatch(spec.strip())
    if not m or not m.group(0):
        raise ValueError(
            f'bad split spec {spec!r}; expected e.g. train, train[:90%], '
            f'train[90%:], [5%:15%]')
    name = m.group('name') or 'train'
    lo = float(m.group('lo')) / 100.0 if m.group('lo') else 0.0
    hi = float(m.group('hi')) / 100.0 if m.group('hi') else 1.0
    if not 0.0 <= lo < hi <= 1.0:
        raise ValueError(f'split range in {spec!r} is empty or out of order')
    return name, lo, hi


def parse_dataset_spec(name: str):
    """Splits a dataset name from its optional ``?split=`` suffix.

    ``'dir?split=train[:90%]' -> ('dir', ('train', 0.0, 0.9))``;
    no suffix -> ``(name, None)``.
    """
    if '?split=' not in name:
        return name, None
    base, _, spec = name.rpartition('?split=')
    return base, parse_split_fractions(spec)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    use_mix: bool = True
    mix_prob: float = 1.0
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    use_randaugment: bool = True
    magnitude: Optional[float] = 9.0    # RandAugment LEVEL units [0, 10]
    magstd: Optional[float] = 0.5
    num_layers: int = 2
    ra_prob: Optional[float] = 0.5      # per-layer apply probability
    ra_cutout: bool = False             # trailing cutout (ref default: off)
    use_colorjitter: bool = False
    colorjitter_strength: float = 0.3
    erase_prob: float = 0.25


def parse_augment_name(name: str, default=AugmentConfig()) -> AugmentConfig:
    """Parses the reference's augmentation-strategy strings: ``mixup`` /
    ``cutmix`` (``mixup_<p>`` sets the apply probability), ``randaugment``
    (the pipeline defaults: 2 layers, magnitude 9, magstd 0.5, layer
    probability 0.5) or ``randaugment_<L><M>`` (NFNets: L layers at fixed
    magnitude M, no std, no layer probability), ``colorjitter[_<s>]``;
    ``'none'`` or empty turns everything off, erasing included."""
    if not name or name == 'none':
        return AugmentConfig(use_mix=False, use_randaugment=False,
                             use_colorjitter=False, erase_prob=0.0)
    use_mix = 'mixup' in name or 'cutmix' in name
    mix_prob = 1.0
    prob_match = re.search(r'(?:cutmix_)?mixup_(\d*\.\d+)', name)
    if prob_match:
        mix_prob = float(prob_match.group(1))

    use_ra = 'randaugment' in name
    magnitude, magstd = default.magnitude, default.magstd
    num_layers, ra_prob = default.num_layers, default.ra_prob
    ra_match = re.search(r'randaugment_(\d)(\d+)', name)
    if ra_match:
        num_layers = int(ra_match.group(1))
        magnitude = float(int(ra_match.group(2)))
        magstd = None
        ra_prob = None

    use_jitter = 'colorjitter' in name
    strength = default.colorjitter_strength
    jitter_match = re.search(r'colorjitter_(\d*\.\d+)', name)
    if jitter_match:
        strength = float(jitter_match.group(1))

    return AugmentConfig(use_mix=use_mix, mix_prob=mix_prob,
                         use_randaugment=use_ra, magnitude=magnitude,
                         magstd=magstd, num_layers=num_layers,
                         ra_prob=ra_prob, use_colorjitter=use_jitter,
                         colorjitter_strength=strength)


def randaugment_of(config: AugmentConfig, image_size: int):
    """The config's RandAugment, or None."""
    if not config.use_randaugment:
        return None
    return RandAugment(num_layers=config.num_layers,
                       magnitude=config.magnitude, magstd=config.magstd,
                       prob_to_apply=config.ra_prob, cutout=config.ra_cutout,
                       num_levels=10, size=image_size)


def draw(generator: torch.Generator, batch: int, frame, config: AugmentConfig,
         image_size: int, device='cpu'):
    """Every random parameter of one augmented batch (module docstring).
    ``frame`` is the decoded frames' ``(height, width)`` or side."""
    height, width = (frame, frame) if isinstance(frame, int) else frame
    draws = {'crop': preprocess.draw_crop(generator, batch, height, width),
             'flip': preprocess.draw_flip(generator, batch)}
    randaugment = randaugment_of(config, image_size)
    if randaugment is not None:
        draws['ra'] = randaugment.draw(generator, batch)
    if config.use_colorjitter:
        jitter = color.draw_color_jitter(
            generator, batch, strength=config.colorjitter_strength)
        draws['jitter'] = {'order': jitter['order'],
                           'factor': jitter['factor']}
    if config.erase_prob:
        noise_gen = torch.Generator(device=device)
        noise_gen.manual_seed(int(torch.randint(0, 2 ** 62, (1,),
                                                generator=generator)))
        draws['erase'] = image_ops.draw_erasing(
            generator, batch, image_size, image_size,
            erase_prob=config.erase_prob, noise_generator=noise_gen)
    if config.use_mix:
        draws['mix'] = mix.draw_mix(generator, batch, image_size, image_size,
                                    mixup_alpha=config.mixup_alpha,
                                    cutmix_alpha=config.cutmix_alpha,
                                    prob_to_apply=config.mix_prob)
    return draws


def to_device(draws, device):
    """The tensors of a draws tree on ``device``: one pinned, non-blocking
    copy per dtype, the rest (numbers, tensors already there) as they
    are."""
    device = torch.device(device)
    leaves = []

    def collect(tree):
        for value in tree.values():
            if isinstance(value, dict):
                collect(value)
            elif isinstance(value, torch.Tensor) and value.device != device:
                leaves.append(value)

    collect(draws)
    moved = {}
    for dtype in {t.dtype for t in leaves}:
        group = [t for t in leaves if t.dtype == dtype]
        flat = image_ops.on_device(torch.cat([t.reshape(-1) for t in group]),
                                   device)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            moved[id(t)] = part.reshape(t.shape)

    def rebuild(tree):
        return {k: rebuild(v) if isinstance(v, dict)
                else moved.get(id(v), v) if isinstance(v, torch.Tensor) else v
                for k, v in tree.items()}

    return rebuild(draws)


def apply(images: torch.Tensor, labels: torch.Tensor, draws,
          config: AugmentConfig, image_size: int):
    """The augmented batch dict of ``images [B, H, W, C]`` (uint8 or float
    in [0, 255]) and ``labels [B]``, both on one device, from ``draws``."""
    images = images.to(torch.float32)
    host = draws
    dev = to_device(draws, images.device)
    images = preprocess.train_preprocess(images, dev['crop'], dev['flip'],
                                         image_size)
    randaugment = randaugment_of(config, image_size)
    if randaugment is not None:
        # op and apply bits from the host copy: the grouping needs no sync
        ra = dict(dev['ra'], op=host['ra']['op'], apply=host['ra']['apply'])
        images = randaugment.apply(images, ra)
    if config.use_colorjitter:
        # composed after RandAugment, before normalization, matching the
        # reference's order (preprocess.py:161-186)
        images = color.color_jitter(images, host['jitter']['order'],
                                    dev['jitter']['factor'])
    images = preprocess.normalize(images)
    if config.erase_prob:
        images = image_ops.random_erasing(images, **dev['erase'])
    if config.use_mix:
        return mix.mix_augment(images, labels, dev['mix'],
                               mixup_alpha=config.mixup_alpha,
                               cutmix_alpha=config.cutmix_alpha,
                               prob_to_apply=config.mix_prob)
    return {'images': images, 'labels': labels}


def make_train_augment_fn(image_size: int, config: AugmentConfig):
    """``augment(generator, images, labels) -> batch dict``: ``draw`` then
    ``apply`` on the images' device."""

    def augment(generator, images, labels):
        draws = draw(generator, images.shape[0], tuple(images.shape[1:3]),
                     config, image_size, device=images.device)
        return apply(images, labels, draws, config, image_size)

    return augment


def step_generator(seed: int, step: int) -> torch.Generator:
    """The host generator of batch ``step``: a function of ``(seed, step)``
    only, so ``batch(step)`` does not depend on what ran before it. The
    pair is mixed into 32 bits (``SeedSequence``): the CPU generator keeps
    only the low 32 bits of its seed."""
    gen = torch.Generator()
    gen.manual_seed(int(np.random.SeedSequence(
        [seed & 0xffffffff, step & 0xffffffff]).generate_state(1)[0]))
    return gen


def split_indices(n: int, lo: float, hi: float) -> np.ndarray:
    """The ``[lo, hi)`` slice of the fixed permutation of ``n`` indices
    (``PERM_SEED``): disjoint ranges give disjoint example sets, the same
    indices as the JAX package picks."""
    start, stop = int(round(lo * n)), int(round(hi * n))
    if stop <= start:
        raise ValueError(f'split [{lo:g}:{hi:g}] of {n} examples is empty')
    return np.random.RandomState(PERM_SEED).permutation(n)[start:stop]


class AugmentedArrayDataset:
    """In-memory uint8 images + labels, resident on ``device`` ->
    augmented batches made there.

    Training samples uniformly with replacement (infinite stream); eval
    walks the examples once in order, ``num_batches`` batches with a
    masked, padded tail, so eval metrics cover each example exactly once.
    ``split=(name, lo, hi)`` keeps the ``[lo, hi)`` slice of the fixed
    permutation (``split_indices``).
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, image_size: int,
                 augmentation: str = 'cutmix_mixup_randaugment_405',
                 training: bool = True, seed: int = 0, device='cpu',
                 split: Optional[tuple] = None):
        if images.ndim != 4 or images.shape[0] != labels.shape[0]:
            raise ValueError(f'images {images.shape} and labels '
                             f'{labels.shape} do not pair up')
        if split is not None:
            perm = split_indices(images.shape[0], split[1], split[2])
            images, labels = images[perm], np.asarray(labels)[perm]
        self.batch_size = batch_size
        self.image_size = image_size
        self.device = torch.device(device)
        self.seed = seed
        self.training = training
        self._images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        self._labels = torch.from_numpy(
            np.asarray(labels).astype(np.int64)).to(self.device)
        self.config = parse_augment_name(augmentation)
        self.num_examples = images.shape[0]
        self.num_batches = (None if training
                            else -(-self.num_examples // batch_size))

    def batch(self, step: int):
        if self.num_batches is not None and step >= self.num_batches:
            raise StopIteration
        gen = step_generator(self.seed, step)
        if self.training:
            idx = torch.randint(0, self.num_examples, (self.batch_size,),
                                generator=gen)
            idx = image_ops.on_device(idx, self.device)
            draws = draw(gen, self.batch_size, tuple(self._images.shape[1:3]),
                         self.config, self.image_size, device=self.device)
            return apply(self._images.index_select(0, idx),
                         self._labels.index_select(0, idx), draws,
                         self.config, self.image_size)
        idx = step * self.batch_size + torch.arange(self.batch_size,
                                                    device=self.device)
        mask = (idx < self.num_examples).to(torch.float32)
        idx = idx.clamp(max=self.num_examples - 1)
        raw = self._images.index_select(0, idx).to(torch.float32)
        return {'images': preprocess.eval_preprocess(raw, self.image_size),
                'labels': self._labels.index_select(0, idx), 'mask': mask}

    def __iter__(self):
        step = 0
        while self.num_batches is None or step < self.num_batches:
            yield self.batch(step)
            step += 1


def create_dataset(name: str, batch_size: int, image_size: int,
                   num_classes: int = 1000, seed: int = 0, device='cpu',
                   augmentation: str = 'none', training: bool = True,
                   num_workers: int = 0, split: Optional[tuple] = None):
    """Dataset factory: 'synthetic', 'synthetic_augmented', an ``.npz``
    file with uint8 'images' and int 'labels' arrays, an npz-shard glob or
    directory, a ``.tar`` of ``<class>/<file>.jpg`` (or a glob of them), a
    directory of ``.tar`` shards, or an ImageFolder tree of JPEGs.

    Every name may carry a ``?split=`` suffix (``parse_split_fractions``)
    or an explicit ``split=(name, lo, hi)``; for array, JPEG and tar
    sources the fractions partition the single source, disjoint by
    construction.
    """
    from sav_tpu_torch.data.synthetic import SyntheticDataset

    name, inline_split = parse_dataset_spec(name)
    if inline_split is not None:
        if split is not None:
            raise ValueError(
                f'{name!r}: split given both inline (?split=) and as an '
                f'argument')
        split = inline_split

    if name == 'synthetic':
        if split is not None:
            raise ValueError("'synthetic' is an infinite stream; "
                             'splits do not apply')
        return SyntheticDataset(batch_size, image_size,
                                num_classes=num_classes, seed=seed,
                                device=device)
    array_kwargs = dict(augmentation=augmentation, training=training,
                        seed=seed, device=device, split=split)
    if name == 'synthetic_augmented':
        rng = np.random.RandomState(seed)
        images = rng.randint(0, 256, (256, 64, 64, 3), dtype=np.uint8)
        labels = rng.randint(0, num_classes, (256,))
        return AugmentedArrayDataset(images, labels, batch_size, image_size,
                                     **array_kwargs)
    if name.endswith('.npz') and '*' not in name:
        with np.load(name) as arrays:
            images, labels = arrays['images'], arrays['labels']
        return AugmentedArrayDataset(images, labels, batch_size, image_size,
                                     **array_kwargs)
    if name.startswith('tfds:'):
        try:
            import tensorflow_datasets as tfds  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                "dataset 'tfds:...' requires tensorflow_datasets "
                '(not installed in this image)') from exc
        raise NotImplementedError(
            "dataset 'tfds:...': TfdsSource is not ported to sav_tpu_torch "
            'yet (ROADMAP.md Queue 1 item 5)')
    if name.endswith('.npz') or name.endswith('.tar') or os.path.isdir(name):
        import glob as globlib

        from sav_tpu_torch.data import jpeg_source
        from sav_tpu_torch.data.loader import (HostDataset, NpzShardSource,
                                               SubsetSource)

        # JPEG decode to the eval resize-small geometry; the device-side
        # distorted-bbox crop then works from this frame
        decode_size = max(int(round(image_size / 0.875)), image_size)
        if name.endswith('.npz'):
            source = NpzShardSource(name)      # glob pattern
        elif name.endswith('.tar'):
            tars = sorted(globlib.glob(name)) if '*' in name else [name]
            source = jpeg_source.JpegTarSource(tars, decode_size=decode_size)
        elif globlib.glob(os.path.join(name, '*.npz')):
            source = NpzShardSource(os.path.join(name, '*.npz'))
        elif jpeg_source.looks_like_jpeg_folder(name):
            source = jpeg_source.JpegFolderSource(name,
                                                  decode_size=decode_size)
        elif globlib.glob(os.path.join(name, '*.tar')):
            source = jpeg_source.JpegTarSource(
                sorted(globlib.glob(os.path.join(name, '*.tar'))),
                decode_size=decode_size)
        else:
            raise ValueError(
                f'directory {name!r} holds neither .npz shards, '
                f'class-subdirectory JPEGs, nor .tar shards')
        if split is not None and (split[1], split[2]) != (0.0, 1.0):
            source = SubsetSource(source, split[1], split[2])
        return HostDataset(source, batch_size, image_size,
                           augmentation=augmentation, training=training,
                           seed=seed, device=device, num_workers=num_workers)
    raise ValueError(
        f'Unknown dataset {name!r}; use synthetic, synthetic_augmented, an '
        f'.npz path/glob, a .tar of JPEGs, a directory of .npz/.tar shards, '
        f'or an ImageFolder-style JPEG tree (TFDS-backed ImageNet requires '
        f'tensorflow_datasets).')
