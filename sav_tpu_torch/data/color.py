"""Batched SimCLR-style color jitter (counterpart of
``sav_tpu/data/color.py``).

Multiplicative brightness, contrast about each channel's mean, saturation
blending and HSV hue rotation, applied in a per-example random order, plus
optional random grayscale; and the random-sigma gaussian blur. Images are
``[N, H, W, C]`` float32 in [0, 255]; every factor is per example. The
``draw_*`` functions make the random parameters from a ``torch.Generator``
with the JAX functions' distributions; the ops themselves are
deterministic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sav_tpu_torch.data import image_ops
from sav_tpu_torch.data.image_ops import on_device, per_example


def rgb_to_hsv(rgb):
    """[..., 3] in [0,1] -> HSV in [0,1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    value = maxc
    delta = maxc - minc
    safe = torch.where(delta > 0, delta, torch.ones_like(delta))

    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    hue = torch.where(r == maxc, bc - gc,
                      torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    hue = (hue / image_ops.const(6.0, hue)) % 1.0
    hue = torch.where(delta > 0, hue, torch.zeros_like(hue))
    saturation = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-8),
                             torch.zeros_like(maxc))
    return torch.stack([hue, saturation, value], dim=-1)


def hsv_to_rgb(hsv):
    """[..., 3] HSV in [0,1] -> RGB in [0,1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.to(torch.int64) % 6).clamp(0, 5)[..., None]

    def choose(*options):
        return torch.stack(options, dim=-1).gather(-1, i)[..., 0]

    r = choose(v, q, p, p, t, v)
    g = choose(t, v, v, q, p, p)
    b = choose(p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


def brightness(images, factor):
    """Multiplicative brightness (SimCLR v2 style)."""
    return torch.clamp(images * per_example(factor, images), 0.0, 255.0)


def contrast(images, factor):
    mean = image_ops.xla_mean(images, (1, 2)).reshape(-1, 1, 1,
                                                      images.shape[-1])
    return torch.clamp((images - mean) * per_example(factor, images) + mean,
                       0.0, 255.0)


def saturation(images, factor):
    gray = image_ops.grayscale(images)
    return torch.clamp(gray + (images - gray) * per_example(factor, images),
                       0.0, 255.0)


def hue(images, delta):
    hsv = rgb_to_hsv(images / image_ops.const(255.0, images))
    delta = per_example(delta, images)
    if isinstance(delta, torch.Tensor):
        delta = delta[..., 0]
    shifted = (hsv[..., 0] + delta) % 1.0
    rgb = hsv_to_rgb(torch.stack([shifted, hsv[..., 1], hsv[..., 2]], dim=-1))
    return torch.clamp(rgb * 255.0, 0.0, 255.0)


def to_grayscale(images):
    return image_ops.grayscale(images)


# the four jitter ops in the JAX function's order (the index an order
# draw holds names the same op)
JITTER_OPS = (brightness, contrast, saturation, hue)


def jitter_ranges(strength: float = 1.0):
    """(lo, hi) of each jitter op's factor at ``strength``: brightness,
    contrast and saturation 0.8s about 1 (floored at 0), hue +-0.2s."""
    b = c = s = 0.8 * strength
    h = 0.2 * strength
    return ((1.0 - b, 1.0 + b), (max(0.0, 1 - c), 1 + c),
            (max(0.0, 1 - s), 1 + s), (-h, h))


def draw_color_jitter(generator: torch.Generator, batch: int,
                      strength: float = 1.0, random_order: bool = True,
                      grayscale_prob: float = 0.0):
    """``order [N, 4]`` (which op runs at each slot), ``factor [N, 4]``
    (the factor of the op at each slot, from that op's range) and ``gray
    [N]`` bits."""
    if random_order:
        order = torch.argsort(torch.rand(batch, 4, generator=generator),
                              dim=1)
    else:
        order = torch.arange(4).expand(batch, 4).clone()
    bounds = torch.tensor(jitter_ranges(strength), dtype=torch.float32)
    lo, hi = bounds[order, 0], bounds[order, 1]
    u = torch.rand(batch, 4, generator=generator, dtype=torch.float32)
    factor = u * (hi - lo) + lo
    gray = torch.rand(batch, generator=generator) < grayscale_prob
    return {'order': order, 'factor': factor, 'gray': gray}


def color_jitter(images, order, factor, gray=None):
    """SimCLR color jitter: at each of the 4 slots, every example runs the
    op its ``order`` names with its ``factor``; then grayscale where
    ``gray`` is set."""
    factor = on_device(factor, images.device)
    for slot in range(4):
        images = image_ops.grouped(images, order[:, slot], JITTER_OPS,
                                   [factor[:, slot]])
    if gray is not None:
        take = on_device(gray, images.device).reshape(-1, 1, 1, 1)
        images = torch.where(take, to_grayscale(images), images)
    return images


def draw_gaussian_blur(generator: torch.Generator, batch: int,
                       sigma_range=(0.1, 2.0), apply_prob: float = 1.0):
    """``sigma [N]`` uniform in ``sigma_range`` and ``apply [N]`` bits."""
    u = torch.rand(batch, generator=generator, dtype=torch.float32)
    sigma = u * (sigma_range[1] - sigma_range[0]) + sigma_range[0]
    apply = torch.rand(batch, generator=generator) < apply_prob
    return sigma, apply


def gaussian_blur(images, sigma, apply=None, kernel_size: int = None):
    """Separable gaussian blur with per-example sigma (reference:
    color_util.py:340-383), 'SAME' zero padding; examples whose ``apply``
    bit is clear keep their image."""
    n, height = images.shape[:2]
    if kernel_size is None:
        kernel_size = max(3, (height // 10) | 1)
    radius = kernel_size // 2
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=images.device)
    sigma = on_device(sigma, images.device, torch.float32).reshape(n, 1)
    kernel = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    kernel = kernel / kernel.sum(dim=1, keepdim=True)           # [N, k]
    # 'SAME' zero padding, then the separable sums as shifted slices
    padded = F.pad(images, (0, 0, radius, radius, radius, radius))
    cols = None
    for i in range(kernel_size):
        term = padded[:, i:i + height] * kernel[:, i].reshape(n, 1, 1, 1)
        cols = term if cols is None else cols + term
    blurred = None
    for j in range(kernel_size):
        term = (cols[:, :, j:j + images.shape[2]]
                * kernel[:, j].reshape(n, 1, 1, 1))
        blurred = term if blurred is None else blurred + term
    if apply is not None:
        take = on_device(apply, images.device).reshape(-1, 1, 1, 1)
        blurred = torch.where(take, blurred, images)
    return blurred
