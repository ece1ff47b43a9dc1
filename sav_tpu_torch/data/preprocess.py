"""Batched on-device eval preprocessing (counterpart of
``sav_tpu/data/preprocess.py``: ``normalize``, ``central_crop_resize``,
``eval_preprocess``).

Images are ``[N, H, W, C]`` float32 in [0, 255], on any device. The crop +
resize reproduces ``jax.image.scale_and_translate(method='bilinear')`` with
JAX's default ``antialias=True``: per-axis weight matrices built as
``jax._src.image.scale.compute_weight_mat`` builds them (triangle kernel
widened by the downscale factor, columns normalised, samples outside the
input zeroed), applied as two small products. ``F.interpolate`` samples at
other centres and has no translation, so it is not used.

The weight matrices and channel statistics are made once per shape and
device and kept there: a copy from pageable host memory would make the
host wait for all queued device work on every batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sav_tpu_torch.data import constants


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
