"""Batched RandAugment (counterpart of ``sav_tpu/data/randaugment.py``).

The same 16-op ImageNet set in the same order (the index a draw holds names
the same op), the same level->argument mappings, uniform / fixed / gaussian
(``magstd``) level sampling, the same ``translate_const`` table, the
optional per-layer apply probability and the optional trailing cutout.

JAX's ``lax.switch`` under ``vmap`` computes all 16 ops on every image and
selects; here each layer groups the batch by its drawn op on the host and
runs each op once on its group (``image_ops.grouped``). An example whose
apply draw failed joins the Identity group, which is the same output as
JAX's select.

``RandAugment.draw`` makes the random parameters from a ``torch.Generator``;
``RandAugment.apply`` is deterministic. Images are ``[N, H, W, C]`` float32
in [0, 255].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sav_tpu_torch.data import image_ops


def translate_const(size: int) -> int:
    return {224: 100, 128: 40, 96: 30, 32: 10}.get(size, int(0.3 * size))


def _signed(value, sign):
    """``value`` where ``sign`` is set, ``-value`` elsewhere."""
    return torch.where(sign, value, -value)


def _enhance(fn):
    return lambda img, lvl, sign: fn(img, lvl * 1.8 + 0.1)


def op_table(size: int):
    """(name, fn(images, level [n], sign [n])) for the 16-op set; ``level``
    is the strength as a fraction in [0, 1]."""
    tconst = float(translate_const(size))
    return [
        ('AutoContrast', lambda img, lvl, sign: image_ops.autocontrast(img)),
        ('Equalize', lambda img, lvl, sign: image_ops.equalize(img)),
        ('Rotate', lambda img, lvl, sign: image_ops.rotate(
            img, _signed(lvl * 30.0, sign))),
        ('Posterize', lambda img, lvl, sign: image_ops.posterize(
            img, (lvl * 4).to(torch.int32))),
        ('Solarize', lambda img, lvl, sign: image_ops.solarize(
            img, torch.floor(lvl * 256.0))),
        ('Color', _enhance(image_ops.color)),
        ('Contrast', _enhance(image_ops.contrast)),
        ('Brightness', _enhance(image_ops.brightness)),
        ('Sharpness', _enhance(image_ops.sharpness)),
        ('ShearX', lambda img, lvl, sign: image_ops.shear_x(
            img, _signed(lvl * 0.3, sign))),
        ('ShearY', lambda img, lvl, sign: image_ops.shear_y(
            img, _signed(lvl * 0.3, sign))),
        ('TranslateX', lambda img, lvl, sign: image_ops.translate_x(
            img, _signed(lvl * tconst, sign))),
        ('TranslateY', lambda img, lvl, sign: image_ops.translate_y(
            img, _signed(lvl * tconst, sign))),
        ('Identity', lambda img, lvl, sign: img),
        ('SolarizeAdd', lambda img, lvl, sign: image_ops.solarize_add(
            img, torch.floor(lvl * 110.0))),
        ('Invert', lambda img, lvl, sign: image_ops.invert(img)),
    ]


OP_NAMES = tuple(name for name, _ in op_table(224))
IDENTITY = OP_NAMES.index('Identity')


@dataclasses.dataclass(frozen=True)
class RandAugment:
    """Config of one RandAugment: ``draw(generator, batch)`` then
    ``apply(images, draws)``."""

    num_layers: int = 2
    prob_to_apply: Optional[float] = None
    magnitude: Optional[float] = None   # LEVEL units, in [0, num_levels]
    num_levels: Optional[int] = 10
    cutout: bool = True
    magstd: Optional[float] = None
    size: int = 224

    def _sample_level(self, generator, shape):
        """The op strength as a fraction in [0, 1]: ``magnitude``/``magstd``
        are in level units, divided by ``num_levels`` once, here."""
        f32 = torch.float32
        if self.magstd:
            if self.magnitude is None:
                raise ValueError('magstd requires magnitude')
            level = self.magnitude + self.magstd * torch.randn(
                shape, generator=generator, dtype=f32)
            level = level.clamp(0.0, self.num_levels)
        elif self.magnitude is not None:
            level = torch.full(shape, self.magnitude, dtype=f32)
        elif self.num_levels is None:
            return torch.rand(shape, generator=generator, dtype=f32)
        else:
            level = torch.randint(0, self.num_levels + 1, shape,
                                  generator=generator).to(f32)
        return level / self.num_levels

    def draw(self, generator: torch.Generator, batch: int):
        """Per layer and example: ``op`` (index into ``OP_NAMES``),
        ``level`` (fraction), ``sign`` (True: the op's argument keeps its
        sign) and ``apply`` bits (all True without ``prob_to_apply``), each
        ``[num_layers, N]``; ``cut_y``/``cut_x`` ``[N]`` for the trailing
        cutout."""
        shape = (self.num_layers, batch)
        op = torch.randint(0, len(OP_NAMES), shape, generator=generator)
        level = self._sample_level(generator, shape)
        sign = torch.rand(shape, generator=generator) < 0.5
        if self.prob_to_apply is not None:
            apply = torch.rand(shape, generator=generator) < self.prob_to_apply
        else:
            apply = torch.ones(shape, dtype=torch.bool)
        draws = {'op': op, 'level': level, 'sign': sign, 'apply': apply}
        if self.cutout:
            draws['cut_y'], draws['cut_x'] = image_ops.draw_cutout(
                generator, batch, self.size, self.size)
        return draws

    def apply(self, images: torch.Tensor, draws) -> torch.Tensor:
        """The layers in order, each op run once on the examples that drew
        it; then the trailing cutout (a box of half the image side)."""
        fns = [fn for _, fn in op_table(self.size)]
        op = torch.where(torch.as_tensor(draws['apply']).cpu(),
                         torch.as_tensor(draws['op']).cpu(), IDENTITY)
        for layer in range(op.shape[0]):
            images = image_ops.grouped(
                images, op[layer], fns,
                [draws['level'][layer], draws['sign'][layer]])
        if self.cutout:
            images = image_ops.cutout(images, draws['cut_y'], draws['cut_x'],
                                      pad_size=images.shape[1] // 4)
        return images
