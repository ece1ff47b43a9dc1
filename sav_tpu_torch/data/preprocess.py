"""Batched on-device preprocessing (counterpart of
``sav_tpu/data/preprocess.py``): the eval transform (``normalize``,
``central_crop_resize``, ``eval_preprocess``) and the train half
(``random_resized_crop``, ``random_flip``, ``train_preprocess``,
``train_cifar_preprocess``), whose random parameters come from the
``draw_*`` functions so a caller may supply its own.

Images are ``[N, H, W, C]`` float32 in [0, 255], on any device. The crop +
resize reproduces ``jax.image.scale_and_translate(method='bilinear')`` with
JAX's default ``antialias=True``: per-axis weight matrices built as
``jax._src.image.scale.compute_weight_mat`` builds them (triangle kernel
widened by the downscale factor, columns normalised, samples outside the
input zeroed), applied as two small products. ``F.interpolate`` samples at
other centres and has no translation, so it is not used.

The eval weight matrices and channel statistics are made once per shape
and device and kept there: a copy from pageable host memory would make the
host wait for all queued device work on every batch. The train crop's
windows differ per example, so its weights are built on the device,
batched (``image_ops.resize_windows``), from the drawn windows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sav_tpu_torch.data import constants, image_ops


@functools.lru_cache(maxsize=16)
def _on_device(values: tuple, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype).to(device)


def normalize(images: torch.Tensor, mean=constants.IMAGENET_1K_MEAN,
              std=constants.IMAGENET_1K_STD) -> torch.Tensor:
    """[0, 255] -> standardized float using dataset statistics."""
    mean = _on_device(tuple(mean), images.dtype, images.device) * 255.0
    std = _on_device(tuple(std), images.dtype, images.device) * 255.0
    return (images - mean) / std


def _weight_mat(in_size: int, out_size: int, scale, translation) -> np.ndarray:
    """[in_size, out_size] float32 bilinear antialiased resampling weights."""
    f32 = np.float32
    scale, translation = f32(scale), f32(translation)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - translation * inv_scale - f32(0.5))
    x = (np.abs(sample_f[np.newaxis, :]
                - np.arange(in_size, dtype=f32)[:, np.newaxis])
         / kernel_scale)
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = np.logical_and(sample_f >= -0.5, sample_f <= in_size - 0.5)
    return np.where(inside[np.newaxis, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=16)
def _window_weights(height: int, width: int, y0, x0, crop_h, crop_w,
                    out_size: int, dtype, device):
    """Per-axis weights of the window [y0:y0+crop_h, x0:x0+crop_w]."""
    f32 = np.float32
    scale_h = f32(out_size) / f32(crop_h)
    scale_w = f32(out_size) / f32(crop_w)
    wh = _weight_mat(height, out_size, scale_h, -f32(y0) * scale_h)
    ww = _weight_mat(width, out_size, scale_w, -f32(x0) * scale_w)
    return (torch.from_numpy(wh).to(dtype).to(device),
            torch.from_numpy(ww).to(dtype).to(device))


def _resize_window(images, y0, x0, crop_h, crop_w, out_size: int):
    """Resizes the window [y0:y0+crop_h, x0:x0+crop_w] of every image."""
    wh, ww = _window_weights(images.shape[1], images.shape[2], y0, x0, crop_h,
                             crop_w, out_size, images.dtype, images.device)
    rows = torch.einsum('nhwc,ho->nowc', images, wh)
    return torch.einsum('nowc,wp->nopc', rows, ww)


def central_crop_resize(images: torch.Tensor, out_size: int,
                        crop_fraction: float = constants.DEFAULT_CROP_FRACTION):
    """Keep-aspect resize-small to ``out_size / crop_fraction`` then central
    crop, for a batch ``[N, H, W, C]``."""
    height, width = images.shape[1], images.shape[2]
    crop = min(height, width) * crop_fraction
    return _resize_window(images, (height - crop) / 2.0, (width - crop) / 2.0,
                          crop, crop, out_size)


def eval_preprocess(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """The eval transform of a batch: crop + resize, then normalize."""
    return normalize(central_crop_resize(images, out_size))


def draw_crop(generator: torch.Generator, batch: int, height: int, width: int,
              area_range=(0.05, 1.0), ratio_range=(3 / 4, 4 / 3)):
    """``[N, 4]`` float32 windows ``(y0, x0, crop_h, crop_w)`` of the
    Inception-style distorted-bbox crop: one sample per example (no retry
    loop), clipped to the frame, as the JAX function draws them."""
    f32 = torch.float32

    def uniform(lo, hi):
        u = torch.rand(batch, generator=generator, dtype=f32)
        return u * (hi - lo) + lo

    area = uniform(area_range[0], area_range[1]) * height * width
    lo = torch.log(torch.tensor(ratio_range[0], dtype=f32))
    hi = torch.log(torch.tensor(ratio_range[1], dtype=f32))
    ratio = torch.exp(uniform(lo, hi))
    crop_w = torch.sqrt(area * ratio).clamp(1.0, width)
    crop_h = torch.sqrt(area / ratio).clamp(1.0, height)
    y0 = torch.rand(batch, generator=generator, dtype=f32) * (height - crop_h)
    x0 = torch.rand(batch, generator=generator, dtype=f32) * (width - crop_w)
    return torch.stack([y0, x0, crop_h, crop_w], dim=1)


def random_resized_crop(images: torch.Tensor, crop: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """Each example's window ``crop[n] = (y0, x0, crop_h, crop_w)`` resized
    to ``out_size``^2, as ``jax.image.scale_and_translate(bilinear,
    antialias=True)`` resizes it."""
    crop = image_ops.on_device(crop, images.device, torch.float32)
    y0, x0, crop_h, crop_w = crop.unbind(1)
    side = image_ops.const(out_size, crop)
    scale_h = side / crop_h
    scale_w = side / crop_w
    return image_ops.resize_windows(images, scale_h, -y0 * scale_h, scale_w,
                                    -x0 * scale_w, out_size, out_size)


def draw_flip(generator: torch.Generator, batch: int) -> torch.Tensor:
    """``[N]`` bool, True with probability 1/2."""
    return torch.rand(batch, generator=generator) < 0.5


def random_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirrors the examples whose ``flip`` bit is set (left-right)."""
    flip = image_ops.on_device(flip, images.device).reshape(-1, 1, 1, 1)
    return torch.where(flip, images.flip(2), images)


def train_preprocess(images: torch.Tensor, crop, flip,
                     out_size: int) -> torch.Tensor:
    """Random resized crop + flip (reference: preprocess.py:80-93)."""
    return random_flip(random_resized_crop(images, crop, out_size), flip)


def draw_cifar(generator: torch.Generator, batch: int):
    """``(y0, x0, flip)`` of ``train_cifar_preprocess``: offsets uniform in
    [0, 9), flip bits."""
    y0 = torch.randint(0, 9, (batch,), generator=generator)
    x0 = torch.randint(0, 9, (batch,), generator=generator)
    return y0, x0, draw_flip(generator, batch)


def train_cifar_preprocess(images: torch.Tensor, y0, x0, flip) -> torch.Tensor:
    """CIFAR-style train transform: pad to 36, each example's 32x32 crop at
    ``(y0, x0)``, flip (reference: data/preprocess/preprocess.py:96-108)."""
    n = images.shape[0]
    padded = torch.nn.functional.pad(images, (0, 0, 4, 4, 4, 4))
    device = images.device
    span = torch.arange(32, device=device)
    rows = image_ops.on_device(y0, device).reshape(n, 1) + span
    cols = image_ops.on_device(x0, device).reshape(n, 1) + span
    batch = torch.arange(n, device=device).reshape(n, 1, 1)
    cropped = padded[batch, rows[:, :, None], cols[:, None, :]]
    return random_flip(cropped, flip)
