"""Batched image ops of the train augmentation (counterpart of
``sav_tpu/data/image_ops.py``, ``NAME_TO_FUNC`` included).

Images are ``[N, H, W, C]`` float32 in [0, 255] on any device. Every
parameter is per example: a ``[N]`` tensor (or a Python number, the same
for every example), so one call serves a batch whose examples drew
different angles, levels or boxes. The arithmetic follows the JAX
functions operation for operation (the same float32 expressions in the
same order), so elementwise and integer ops give the same bits; the
convolutions and reductions sum in another order.

Geometric ops share one inverse-affine resampler (the tfa convention);
``rescale`` and the train crop share one batched antialiased bilinear
resampler (``resize_windows``), which builds its weights on the device.
Sums run in one order on every device (shifted slices for the filters,
float64 products for the resampler), so the card and the CPU give the
same batch from the same draws.
"""

from __future__ import annotations

import torch

GRAY = 128.0  # replace/fill value used by the reference ops


def on_device(value, device, dtype=None):
    """``value`` as a tensor on ``device``. A host tensor goes to the card
    through pinned memory without blocking: a copy from pageable memory
    would make the host wait for all work queued on the card first."""
    t = torch.as_tensor(value, dtype=dtype)
    device = torch.device(device)
    if t.device == device:
        return t
    if device.type == 'cuda' and t.device.type == 'cpu':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def per_example(value, images: torch.Tensor, dtype=torch.float32):
    """``value`` broadcastable against ``images [N, H, W, C]``: a number
    stays a number, a 0-d or ``[N]`` tensor becomes ``[N, 1, 1, 1]`` on the
    images' device."""
    if isinstance(value, (int, float)):
        return value
    return on_device(value, images.device, dtype).reshape(-1, 1, 1, 1)


def _vec(value, n: int, device, dtype=torch.float32) -> torch.Tensor:
    """``value`` as a ``[n]`` tensor on ``device``."""
    if isinstance(value, (int, float)):
        return torch.full((n,), value, dtype=dtype, device=device)
    t = on_device(value, device, dtype)
    return t.expand(n) if t.dim() == 0 else t.reshape(n)


def const(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``value`` on ``like``'s device. Dividing by it is an
    IEEE division on every device; dividing a CUDA tensor by a Python
    number multiplies by its reciprocal, which rounds differently."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA computes a contracted
    multiply-add (its dots, and the fused code of a jitted function):
    the product is exact in float64 and the sum rounds to float32."""
    return (a.double() * b + c.double()).float()


def xla_mean(x: torch.Tensor, dim, count: int = None) -> torch.Tensor:
    """``jnp.mean`` as XLA computes it: the float32 sum times the float32
    reciprocal of the count (its simplifier turns the division by a
    constant into that product). ``count`` defaults to the reduced
    elements."""
    if count is None:
        count = x.numel() // x.sum(dim=dim).numel()
    inv = torch.tensor(1.0, dtype=torch.float32) / count
    return x.sum(dim=dim) * const(float(inv), x)


def _clip(images):
    return images.clamp(0.0, 255.0)


def blend(image1, image2, factor):
    """Interpolates/extrapolates from image2 toward image1 by ``factor``
    (0 -> image2, 1 -> image1), clipped to valid range."""
    return _clip(image2 + per_example(factor, image1) * (image1 - image2))


# ---------------------------------------------------------------------------
# Color / intensity ops
# ---------------------------------------------------------------------------

def invert(images):
    return 255.0 - images


def solarize(images, threshold=128.0):
    return torch.where(images < per_example(threshold, images), images,
                       255.0 - images)


def solarize_add(images, addition=0.0, threshold=128.0):
    return torch.where(images < per_example(threshold, images),
                       _clip(images + per_example(addition, images)), images)


def posterize(images, bits):
    """Keeps the top ``bits`` bits of each channel value (truncation to
    uint8 first, as ``astype(uint8)``)."""
    shift = 8 - _vec(bits, images.shape[0], images.device, torch.int32)
    shift = shift.to(torch.uint8).reshape(-1, 1, 1, 1)
    quantized = torch.bitwise_right_shift(images.to(torch.uint8), shift)
    return torch.bitwise_left_shift(quantized, shift).to(images.dtype)


_LUMA = torch.tensor([0.2989, 0.5870, 0.1140], dtype=torch.float32).tolist()


def _gray(images):
    """``[N, H, W]`` luma r*0.2989 + g*0.5870 + b*0.1140 (the float32
    weights), summed as XLA's dot sums it: fma(b, wb, fma(g, wg, r*wr))."""
    acc = images[..., 0] * _LUMA[0]
    acc = fma(images[..., 1], _LUMA[1], acc)
    return fma(images[..., 2], _LUMA[2], acc)


def grayscale(images):
    return _gray(images)[..., None].expand(images.shape)


def brightness(images, factor):
    return blend(images, torch.zeros_like(images), factor)


def contrast(images, factor):
    # degenerate image: the mean of the rounded grayscale, like PIL
    # the mean over the gray image broadcast to every channel
    gray = torch.round(_gray(images)) * images.shape[-1]
    mean = xla_mean(gray, (1, 2), gray[0].numel() * images.shape[-1])
    mean = mean.reshape(-1, 1, 1, 1)
    return blend(images, mean.expand(images.shape), factor)


def color(images, factor):
    return blend(images, torch.round(grayscale(images)), factor)


def correlate_valid(images, kernel) -> torch.Tensor:
    """Depthwise 'VALID' correlation of ``images [N, H, W, C]`` with a
    ``[k, k]`` kernel (nested lists of numbers), as a sum of shifted
    slices: float32 on every device, in one order (a cuDNN convolution may
    run in TF32 on the card)."""
    k = len(kernel)
    h, w = images.shape[1] - k + 1, images.shape[2] - k + 1
    out = None
    for i in range(k):
        for j in range(k):
            if kernel[i][j]:
                term = images[:, i:i + h, j:j + w, :] * kernel[i][j]
                out = term if out is None else out + term
    return out


def _kernel_blend(images, kernel, factor):
    """Blend toward a depthwise-filtered image; border pixels (where the
    kernel would read outside the frame) stay original."""
    pad = len(kernel) // 2
    soft = _clip(correlate_valid(images, kernel))
    degenerate = images.clone()
    degenerate[:, pad:-pad, pad:-pad, :] = soft
    return blend(images, degenerate, factor)


def _kernel(rows, divisor):
    """The float32 values of ``rows / divisor``, as nested lists."""
    return (torch.tensor(rows, dtype=torch.float32) / divisor).tolist()


_SMOOTH = _kernel([[1., 1., 1.], [1., 5., 1.], [1., 1., 1.]], 13.0)
_BLUR = _kernel([[1., 1., 1., 1., 1.],
                 [1., 0., 0., 0., 1.],
                 [1., 0., 0., 0., 1.],
                 [1., 0., 0., 0., 1.],
                 [1., 1., 1., 1., 1.]], 16.0)


def sharpness(images, factor):
    """Blend toward a 3x3 smoothed image; border pixels stay original."""
    return _kernel_blend(images, _SMOOTH, factor)


def smooth(images, factor):
    """Blend toward the PIL ImageFilter.SMOOTH kernel (3x3 [1..5..1]/13)."""
    return _kernel_blend(images, _SMOOTH, factor)


def blur(images, factor):
    """Blend toward the PIL ImageFilter.BLUR kernel (5x5 ring of ones /
    16)."""
    return _kernel_blend(images, _BLUR, factor)


def autocontrast(images):
    """Per-image, per-channel linear stretch to the full [0, 255] range."""
    lo = images.amin(dim=(1, 2), keepdim=True)
    hi = images.amax(dim=(1, 2), keepdim=True)
    scale = const(255.0, images) / torch.clamp(hi - lo, min=1e-6)
    stretched = _clip((images - lo) * scale)
    return torch.where(hi > lo, stretched, images)


def equalize(images):
    """Per-image, per-channel histogram equalization with a 256-bin LUT:
    step = (pixels - last bin's count) // 255, lut = (cumsum + step // 2)
    // step, in integers as the JAX function (int32 there, int64 here: the
    same values). Histograms by ``scatter_add_`` (no host sync)."""
    n, h, w, c = images.shape
    values = images.to(torch.int32).to(torch.int64)          # truncation
    chan = values.permute(0, 3, 1, 2).reshape(n * c, h * w)   # [NC, HW]
    offsets = torch.arange(n * c, device=images.device)[:, None] * 256
    histo = torch.zeros(n * c * 256, dtype=torch.int64, device=images.device)
    histo.scatter_add_(0, (chan + offsets).reshape(-1),
                       torch.ones_like(chan).reshape(-1))
    histo = histo.reshape(n * c, 256)
    bins = torch.arange(256, device=images.device)
    last_idx = torch.where(histo > 0, bins, -1).amax(dim=1, keepdim=True)
    last = histo.gather(1, last_idx.clamp(min=0))
    step = torch.div(histo.sum(dim=1, keepdim=True) - last, 255,
                     rounding_mode='floor')
    lut = torch.div(histo.cumsum(dim=1) + torch.div(step, 2,
                                                    rounding_mode='floor'),
                    step.clamp(min=1), rounding_mode='floor')
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]],
                    dim=1).clamp(0, 255)
    mapped = lut.gather(1, chan)
    result = torch.where(step == 0, chan, mapped)
    return result.reshape(n, c, h, w).permute(0, 2, 3, 1).to(torch.float32)


def grouped(images, keys, fns, params):
    """Runs ``fns[k](images[i], *[p[i] for p in params])`` once per key
    ``k`` on the examples ``i`` whose ``keys[i] == k``, and puts the
    results back in batch order. ``keys`` is a ``[N]`` host tensor (the
    grouping needs no device sync); ``params`` are ``[N]`` tensors on the
    images' device or the host."""
    keys = torch.as_tensor(keys).cpu()
    order = torch.argsort(keys, stable=True)
    counts = torch.bincount(keys, minlength=len(fns)).tolist()
    order_dev = on_device(order, images.device)
    src = images.index_select(0, order_dev)
    sorted_params = [on_device(p, images.device).index_select(0, order_dev)
                     for p in params]
    out = torch.empty_like(images)
    start = 0
    for k, count in enumerate(counts):
        if count:
            stop = start + count
            out[start:stop] = fns[k](src[start:stop],
                                     *[p[start:stop] for p in sorted_params])
            start = stop
    return torch.empty_like(out).index_copy_(0, order_dev, out)


# ---------------------------------------------------------------------------
# Geometric ops (single inverse-affine resampler)
# ---------------------------------------------------------------------------

def affine_transform(images, matrix, fill=GRAY, interpolation='nearest'):
    """Applies per-example inverse affine maps ``matrix [N, 6] = [a, b, tx,
    c, d, ty]``: output(y, x) = input(c*x + d*y + ty, a*x + b*y + tx), the
    tfa.transform convention, with constant fill outside the frame."""
    n, height, width, channels = images.shape
    m = on_device(matrix, images.device, torch.float32).reshape(-1, 6)
    m = m.expand(n, 6)
    a, b, tx, c, d, ty = (m[:, i].reshape(-1, 1, 1) for i in range(6))
    out_y = torch.arange(height, dtype=torch.float32,
                         device=images.device).reshape(1, height, 1)
    out_x = torch.arange(width, dtype=torch.float32,
                         device=images.device).reshape(1, 1, width)
    src_x = a * out_x + b * out_y + tx
    src_y = c * out_x + d * out_y + ty
    flat = images.reshape(n, height * width, channels)

    def sample(ix, iy):
        valid = ((ix >= 0) & (ix <= width - 1) &
                 (iy >= 0) & (iy <= height - 1))
        ix_c = ix.clamp(0, width - 1).to(torch.int64)
        iy_c = iy.clamp(0, height - 1).to(torch.int64)
        index = (iy_c * width + ix_c).reshape(n, height * width, 1)
        pixels = flat.gather(1, index.expand(-1, -1, channels))
        pixels = pixels.reshape(n, height, width, channels)
        return torch.where(valid[..., None], pixels, fill)

    if interpolation == 'nearest':
        return sample(torch.round(src_x), torch.round(src_y))

    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx, wy = (src_x - x0)[..., None], (src_y - y0)[..., None]
    top = sample(x0, y0) * (1 - wx) + sample(x0 + 1, y0) * wx
    bottom = sample(x0, y0 + 1) * (1 - wx) + sample(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bottom * wy


def _matrix(n, device, **entries):
    """``[n, 6]`` identity maps with the named entries set (each a number or
    ``[n]`` tensor)."""
    order = ('a', 'b', 'tx', 'c', 'd', 'ty')
    base = dict(a=1.0, b=0.0, tx=0.0, c=0.0, d=1.0, ty=0.0)
    base.update(entries)
    return torch.stack([_vec(base[k], n, device) for k in order], dim=1)


def rotate(images, degrees, fill=GRAY):
    """Rotation about the image center, per-example angles."""
    n = images.shape[0]
    radians = torch.deg2rad(_vec(degrees, n, images.device))
    # in float64, rounded once: the same values on every device
    cos = torch.cos(radians.double()).float()
    sin = torch.sin(radians.double()).float()
    cy = (images.shape[1] - 1) / 2.0
    cx = (images.shape[2] - 1) / 2.0
    # inverse map of a rotation by +degrees
    matrix = torch.stack([cos, -sin, cx - cos * cx + sin * cy,
                          sin, cos, cy - sin * cx - cos * cy], dim=1)
    return affine_transform(images, matrix, fill)


def shear_x(images, level, fill=GRAY):
    return affine_transform(
        images, _matrix(images.shape[0], images.device, b=level), fill)


def shear_y(images, level, fill=GRAY):
    return affine_transform(
        images, _matrix(images.shape[0], images.device, c=level), fill)


def translate_x(images, pixels, fill=GRAY):
    return affine_transform(
        images, _matrix(images.shape[0], images.device, tx=pixels), fill)


def translate_y(images, pixels, fill=GRAY):
    return affine_transform(
        images, _matrix(images.shape[0], images.device, ty=pixels), fill)


# ---------------------------------------------------------------------------
# Masking ops
# ---------------------------------------------------------------------------

def box_mask(height: int, width: int, center_y, center_x, half_h, half_w,
             device):
    """Boolean ``[N, H, W]`` masks, True inside each (clipped) box; the
    box parameters are ``[N]`` integer tensors."""
    def col(t):
        if isinstance(t, int):
            return t
        return on_device(t, device).reshape(-1, 1, 1)
    yy = torch.arange(height, device=device).reshape(1, height, 1)
    xx = torch.arange(width, device=device).reshape(1, 1, width)
    cy, cx, hh, hw = col(center_y), col(center_x), col(half_h), col(half_w)
    return ((yy >= cy - hh) & (yy < cy + hh) &
            (xx >= cx - hw) & (xx < cx + hw))


def draw_cutout(generator: torch.Generator, batch: int, height: int,
                width: int):
    """Box centers of ``cutout``: ``[N]`` uniform ints in [0, H), [0, W)."""
    cy = torch.randint(0, height, (batch,), generator=generator)
    cx = torch.randint(0, width, (batch,), generator=generator)
    return cy, cx


def cutout(images, center_y, center_x, pad_size: int, replace=GRAY):
    """Sets a 2*pad_size square about each example's center to
    ``replace``."""
    mask = box_mask(images.shape[1], images.shape[2], center_y, center_x,
                    pad_size, pad_size, images.device)
    return torch.where(mask[..., None], replace, images)


def draw_erasing(generator: torch.Generator, batch: int, height: int,
                 width: int, channels: int = 3, erase_prob=0.25,
                 min_area=0.02, max_area=1 / 3, min_aspect=0.3,
                 noise_generator=None):
    """Draws of ``random_erasing`` for a batch: apply bits, the box
    (center, half sizes; one attempt, as the JAX function) and the gaussian
    noise (from ``noise_generator`` on its device, else ``generator``)."""
    f32 = torch.float32
    apply = torch.rand(batch, generator=generator) < erase_prob
    area = height * width
    target = (torch.rand(batch, generator=generator, dtype=f32)
              * (max_area - min_area) + min_area) * area
    lo = torch.log(torch.tensor(min_aspect, dtype=f32))
    hi = torch.log(torch.tensor(1.0 / min_aspect, dtype=f32))
    ratio = torch.exp(torch.rand(batch, generator=generator, dtype=f32)
                      * (hi - lo) + lo)
    half_h = torch.div(torch.sqrt(target * ratio).to(torch.int64), 2,
                       rounding_mode='floor').clamp(1, height // 2)
    half_w = torch.div(torch.sqrt(target / ratio).to(torch.int64), 2,
                       rounding_mode='floor').clamp(1, width // 2)
    cy = torch.randint(0, height, (batch,), generator=generator)
    cx = torch.randint(0, width, (batch,), generator=generator)
    gen = noise_generator if noise_generator is not None else generator
    noise = torch.randn((batch, height, width, channels), generator=gen,
                        device=gen.device)
    return {'apply': apply, 'box': torch.stack([cy, cx, half_h, half_w], 1),
            'noise': noise}


def random_erasing(images, apply, box, noise):
    """Fills each applied example's box with its gaussian noise (reference
    augment_ops.py:184-255); ``box`` is ``[N, 4]`` (cy, cx, half_h,
    half_w)."""
    box = on_device(box, images.device)
    mask = box_mask(images.shape[1], images.shape[2], box[:, 0], box[:, 1],
                    box[:, 2], box[:, 3], images.device)
    apply = on_device(apply, images.device).reshape(-1, 1, 1)
    return torch.where((mask & apply)[..., None], noise.to(images.dtype),
                       images)


# ---------------------------------------------------------------------------
# Antialiased bilinear resampling of per-example windows
# ---------------------------------------------------------------------------

def weight_mats(in_size: int, out_size: int, scale, translation):
    """``[N, in_size, out_size]`` float32 weights of
    ``jax.image.scale_and_translate(method='bilinear', antialias=True)``
    along one axis, one matrix per example (``scale`` and ``translation``
    are ``[N]`` float32 tensors), built where they lie: ``compute_weight_mat``
    operation for operation."""
    f32 = torch.float32
    device = scale.device
    scale = scale.to(f32).reshape(-1, 1, 1)
    translation = translation.to(f32).reshape(-1, 1, 1)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out = torch.arange(out_size, dtype=f32, device=device).reshape(1, 1, -1)
    # jax.image.scale_and_translate is jitted: XLA contracts the first
    # product and the difference into one multiply-add
    sample_f = fma(out + 0.5, inv_scale.double(),
                   -(translation * inv_scale)) - 0.5
    pos = torch.arange(in_size, dtype=f32, device=device).reshape(1, -1, 1)
    x = torch.abs(sample_f - pos) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(torch.finfo(f32).eps)
    weights = torch.where(torch.abs(total) > eps,
                          weights / torch.where(total != 0, total,
                                                torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def resize_windows(images, scale_h, trans_h, scale_w, trans_w,
                   out_h: int, out_w: int):
    """Per-example scale-and-translate of ``images [N, H, W, C]`` to
    ``[N, out_h, out_w, C]``: the weights ``[N, H, out_h]`` and ``[N, W,
    out_w]`` are built on the images' device and applied by two batched
    products."""
    wh = weight_mats(images.shape[1], out_h, scale_h, trans_h).double()
    ww = weight_mats(images.shape[2], out_w, scale_w, trans_w).double()
    # float64 products, rounded once: the same values on every device
    rows = torch.einsum('nhwc,nho->nowc', images.double(), wh)
    return torch.einsum('nowc,nwp->nopc', rows, ww).to(images.dtype)


def rescale(images, level):
    """Zoom toward the center by up to 50% (reference augment_ops.py
    'rescale'): crop the central (1 - level/2) fraction and resize back,
    per-example levels."""
    n, size = images.shape[0], images.shape[1]
    level = _vec(level, n, images.device)
    scale = 1.0 - 0.5 * level
    crop = size * scale
    offset = (size - crop) / 2.0
    scale_xy = const(size, crop) / crop
    translation = -offset * scale_xy
    return _clip(resize_windows(images, scale_xy, translation, scale_xy,
                                translation, size, images.shape[2]))


# Registry mirroring the reference's NAME_TO_FUNC surface (reference:
# augment_ops.py:674-697). Cutout takes its drawn centers and pad size.
NAME_TO_FUNC = {
    'AutoContrast': autocontrast,
    'Equalize': equalize,
    'Invert': invert,
    'Rotate': rotate,
    'Posterize': posterize,
    'Solarize': solarize,
    'SolarizeAdd': solarize_add,
    'Color': color,
    'Contrast': contrast,
    'Brightness': brightness,
    'Sharpness': sharpness,
    'ShearX': shear_x,
    'ShearY': shear_y,
    'TranslateX': translate_x,
    'TranslateY': translate_y,
    'Identity': lambda images, *a: images,
    'Cutout': cutout,
    'Blur': blur,
    'Smooth': smooth,
    'Rescale': rescale,
}
