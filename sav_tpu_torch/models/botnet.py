"""BoTNet: Bottleneck Transformers (counterpart of
``sav_tpu/models/botnet.py``).

A ResNet-50-style backbone (7 x 7 stem, BatchNorm, swish, max-pool,
bottleneck blocks with squeeze-excite) whose last stage replaces the 3 x 3
conv with all-to-all multi-head self-attention over the 2-D grid, with
decomposed 2-D relative-position logits. The module tree carries the flax
names (``Conv_0``, ``BatchNorm_0``, ``BottleneckResNetBlock_i`` with
``Conv_0..3``, ``BatchNorm_0..3`` and ``SqueezeExciteBlock_0``,
``BoTBlock_j`` with ``Conv_0..2``, ``BatchNorm_0..3`` and ``BoTMHSA_0``
(``query``/``key``/``value`` kernels ``[1, 1, C, C]``,
``RelativeLogits_0.rel_pos_emb_{h,w}`` ``[2G-1, d]``), the head
``Dense_0``), and the BatchNorms' running statistics are buffers, so a
flax ``{'params', 'batch_stats'}`` tree loads through
``utils.flax_bridge``. Shapes flax infers at init (the grid of each
RelativeLogits, whether a block projects its residual) come from
``img_size``; a forward on another grid raises.

``use_kernel`` takes the JAX package's values for BoTNet:
  * ``'auto'`` and ``False``: the per-op path, on the card too, as the JAX
    package (its dispatch never picks the fused core at BoTNet's sizes):
    the relative logits expanded to ``[B, h, L, L]`` and
    ``ops.attention.multi_head_attention(..., bias=...)``, whose dispatch
    refuses a bias to the flash kernels.
  * ``'botnet_fused'``: the attention core on ``ops.botnet_attention``
    (K9a forward, K9b backward on the card; a grid the kernels do not take
    raises there, as JAX asserts; the plain twins on the CPU).
Every route reads the same parameters. ``scan_layers`` and dropout do not
exist for BoTNet.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from sav_tpu_torch.nn.layers import Conv, Dense, avg_pool, he_uniform_, max_pool
from sav_tpu_torch.nn.normalization import BatchNorm
from sav_tpu_torch.nn.squeeze_excite import SqueezeExciteBlock
from sav_tpu_torch.ops import attention as attention_ops
from sav_tpu_torch.ops import botnet_attention

USE_KERNEL = ('auto', False, 'botnet_fused')


def _check_use_kernel(use_kernel) -> None:
    if use_kernel not in USE_KERNEL:
        raise NotImplementedError(
            f'use_kernel={use_kernel!r} is not a BoTNet mode (the port takes '
            f'{USE_KERNEL}; ROADMAP.md)')


def swish(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.swish``, ``x * sigmoid(x)``, rounded where it rounds."""
    return x * torch.sigmoid(x)


def _down(size: int, stride: int) -> int:
    """Grid side after a 'SAME' window of stride ``stride``."""
    return -(-size // stride)


class BottleneckResNetBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck with BN, swish and
    squeeze-excite; the residual projected (1x1 conv, BN, swish) when its
    shape differs from the branch's."""

    def __init__(self, in_ch: int, filters: int, strides: int, size: int,
                 se_ratio: float, projection_factor: int, norm, dtype):
        super().__init__()
        out_ch = filters * projection_factor
        self.Conv_0 = Conv(in_ch, filters, (1, 1), dtype=dtype)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), (strides, strides),
                           dtype=dtype)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = Conv(filters, out_ch, (1, 1), dtype=dtype)
        self.BatchNorm_2 = norm(out_ch, zero_scale=True)
        self.SqueezeExciteBlock_0 = SqueezeExciteBlock(out_ch, se_ratio,
                                                       swish, dtype)
        self.project = _down(size, strides) != size or in_ch != out_ch
        if self.project:
            self.Conv_3 = Conv(in_ch, out_ch, (1, 1), (strides, strides),
                               dtype=dtype)
            self.BatchNorm_3 = norm(out_ch)

    def forward(self, inputs):
        y = swish(self.BatchNorm_0(self.Conv_0(inputs)))
        y = swish(self.BatchNorm_1(self.Conv_1(y)))
        y = self.SqueezeExciteBlock_0(self.BatchNorm_2(self.Conv_2(y)))
        residual = inputs
        if self.project:
            residual = swish(self.BatchNorm_3(self.Conv_3(inputs)))
        return swish(residual + y)


class RelativeLogits(nn.Module):
    """The learned per-axis relative embeddings ``rel_pos_emb_h`` and
    ``rel_pos_emb_w`` ``[2G-1, d]`` (normal, std d^-0.5) of a G x G grid;
    the logits are ``ops.botnet_attention.decomposed_rel_logits``."""

    def __init__(self, grid: int, head_ch: int):
        super().__init__()
        self.head_ch = head_ch
        self.rel_pos_emb_w = nn.Parameter(torch.empty(2 * grid - 1, head_ch))
        self.rel_pos_emb_h = nn.Parameter(torch.empty(2 * grid - 1, head_ch))

    def init_params(self, generator: torch.Generator) -> None:
        for emb in (self.rel_pos_emb_w, self.rel_pos_emb_h):
            nn.init.normal_(emb, std=self.head_ch ** -0.5, generator=generator)


class BoTMHSA(nn.Module):
    """All-pairs MHSA over a G x G grid with relative-position logits, no
    output projection. ``core`` ('kernel' or 'plain') picks
    ``bot_core``'s kernels or its twins on the ``'botnet_fused'`` route
    (``set_attention_core``; the card's gradient check); it is not a
    ``use_kernel`` mode."""

    def __init__(self, in_ch: int, num_heads: int, grid: int,
                 dtype=torch.float32, use_kernel='auto'):
        super().__init__()
        if in_ch % num_heads:
            raise ValueError(f'{in_ch} channels are not divisible by '
                             f'{num_heads} heads')
        _check_use_kernel(use_kernel)
        self.num_heads, self.head_ch = num_heads, in_ch // num_heads
        self.grid, self.dtype, self.use_kernel = grid, dtype, use_kernel
        self.core = 'kernel'
        self.query = Conv(in_ch, in_ch, (1, 1), dtype=dtype)
        self.key = Conv(in_ch, in_ch, (1, 1), dtype=dtype)
        self.value = Conv(in_ch, in_ch, (1, 1), dtype=dtype)
        self.RelativeLogits_0 = RelativeLogits(grid, self.head_ch)

    def forward(self, inputs):
        b, height, width, c = inputs.shape
        g, h, d = self.grid, self.num_heads, self.head_ch
        if height != g or width != g:
            raise ValueError(
                f'BoTMHSA was built for a {g} x {g} grid (from img_size); '
                f'got {height} x {width}')
        length = g * g
        query_b = self.query(inputs)
        key_b, value_b = self.key(inputs), self.value(inputs)
        # sqrt(d) rounded to the compute dtype, as both JAX routes divide
        scale = torch.tensor(float(d)).sqrt().to(query_b.dtype).item()
        emb = self.RelativeLogits_0
        if self.use_kernel == 'botnet_fused':
            if (inputs.device.type == 'cuda'
                    and not botnet_attention.supported(g, h, d, inputs.device)):
                raise NotImplementedError(
                    f'the BoTNet attention kernels do not take a {g} x {g} '
                    f'grid of {h} heads of width {d} (ROADMAP.md Queue 2, '
                    'K9); use_kernel=False runs the per-op path')
            bands = lambda a: a.reshape(b, length, c)
            out = botnet_attention.botnet_mhsa(
                bands(query_b) / scale, bands(key_b), bands(value_b),
                emb.rel_pos_emb_h, emb.rel_pos_emb_w, h, g, self.core)
            return out.reshape(b, g, g, c)
        heads = lambda a: a.reshape(b, length, h, d)
        rel_h, rel_w = botnet_attention.decomposed_rel_logits(
            query_b.reshape(b, length, c) / scale, emb.rel_pos_emb_h,
            emb.rel_pos_emb_w, h, g)
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
            b, h, length, length)
        # the unscaled query: multi_head_attention divides it itself
        out = attention_ops.multi_head_attention(
            heads(query_b), heads(key_b), heads(value_b), bias=bias)
        return out.reshape(b, g, g, c)


class BoTBlock(nn.Module):
    """Bottleneck block with MHSA in place of the 3x3 conv (an avg-pool
    after it where the block strides)."""

    def __init__(self, in_ch: int, filters: int, strides: int, size: int,
                 num_heads: int, projection_factor: int, norm, dtype,
                 use_kernel):
        super().__init__()
        out_ch = filters * projection_factor
        self.strides = strides
        self.Conv_0 = Conv(in_ch, filters, (1, 1), dtype=dtype)
        self.BatchNorm_0 = norm(filters)
        self.BoTMHSA_0 = BoTMHSA(filters, num_heads, size, dtype, use_kernel)
        self.BatchNorm_1 = norm(filters)
        self.Conv_1 = Conv(filters, out_ch, (1, 1), dtype=dtype)
        self.BatchNorm_2 = norm(out_ch, zero_scale=True)
        self.project = (strides == 2 or _down(size, strides) != size
                        or in_ch != out_ch)
        if self.project:
            self.Conv_2 = Conv(in_ch, out_ch, (1, 1), (strides, strides),
                               dtype=dtype)
            self.BatchNorm_3 = norm(out_ch)

    def forward(self, inputs):
        y = swish(self.BatchNorm_0(self.Conv_0(inputs)))
        y = self.BoTMHSA_0(y)
        if self.strides == 2:
            y = avg_pool(y, (2, 2), (2, 2), 'SAME')
        y = swish(self.BatchNorm_1(y))
        y = self.BatchNorm_2(self.Conv_1(y))
        residual = inputs
        if self.project:
            residual = swish(self.BatchNorm_3(self.Conv_2(inputs)))
        return swish(residual + y)


class _Head(Dense):
    """The classifier: he-uniform kernel, bias normal with std 1e-6."""

    def init_params(self, generator: torch.Generator) -> None:
        he_uniform_(self.kernel, self.kernel.shape[0], generator)
        nn.init.normal_(self.bias, std=1e-6, generator=generator)


class BoTNet(nn.Module):
    """BoTNet classifier over NHWC images of ``img_size``: conv stem,
    ``len(stage_sizes) - 1`` ResNet stages, one BoT stage."""

    def __init__(self, num_classes: int, stage_sizes: Tuple[int, ...],
                 img_size: int = 224, stride_one: bool = True,
                 se_ratio: float = 0.0625, num_heads: int = 4,
                 initial_filters: int = 64, projection_factor: int = 4,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype=torch.float32, use_kernel: Union[str, bool] = 'auto'):
        super().__init__()
        _check_use_kernel(use_kernel)
        self.dtype, self.img_size = dtype, img_size
        norm = lambda features, zero_scale=False: BatchNorm(
            features, bn_momentum, bn_epsilon, dtype, zero_scale)
        self.Conv_0 = Conv(3, initial_filters, (7, 7), (2, 2),
                           padding=((3, 3), (3, 3)), dtype=dtype)
        self.BatchNorm_0 = norm(initial_filters)
        size = _down((img_size + 6 - 7) // 2 + 1, 2)     # stem conv, max-pool
        in_ch = initial_filters
        self.blocks = []
        index = 0
        for i, stage_size in enumerate(stage_sizes[:-1]):
            for j in range(stage_size):
                strides = 2 if i > 0 and j == 0 else 1
                filters = initial_filters * 2 ** i
                self._add(f'BottleneckResNetBlock_{index}',
                          BottleneckResNetBlock(in_ch, filters, strides, size,
                                                se_ratio, projection_factor,
                                                norm, dtype))
                index += 1
                in_ch, size = filters * projection_factor, _down(size, strides)
        last = len(stage_sizes) - 1
        for j in range(stage_sizes[-1]):
            strides = 2 if j == 0 and not stride_one else 1
            filters = initial_filters * 2 ** last
            self._add(f'BoTBlock_{j}',
                      BoTBlock(in_ch, filters, strides, size, num_heads,
                               projection_factor, norm, dtype, use_kernel))
            in_ch, size = filters * projection_factor, _down(size, strides)
        self.Dense_0 = _Head(in_ch, num_classes, dtype=dtype)

    def _add(self, name: str, block: nn.Module) -> None:
        self.add_module(name, block)
        self.blocks.append(name)

    def forward(self, inputs):
        y = swish(self.BatchNorm_0(self.Conv_0(inputs)))
        y = max_pool(y, (3, 3), (2, 2), 'SAME')
        for name in self.blocks:
            y = getattr(self, name)(y)
        y = y.float().mean(dim=(1, 2)).to(y.dtype)
        return self.Dense_0(y).to(self.dtype)


def set_use_kernel(model: nn.Module, use_kernel: Union[str, bool]) -> None:
    """Re-routes every BoTMHSA of a built BoTNet (same weights)."""
    _check_use_kernel(use_kernel)
    for sub in model.modules():
        if isinstance(sub, BoTMHSA):
            sub.use_kernel = use_kernel


def set_attention_core(model: nn.Module, core: str) -> None:
    """``'kernel'`` or ``'plain'``: what ``bot_core`` runs on the
    ``'botnet_fused'`` route (the plain twins on the same autograd
    boundary, the reference of the card's gradient check)."""
    if core not in botnet_attention.CORES:
        raise ValueError(f'core must be one of {botnet_attention.CORES}, '
                         f'got {core!r}')
    for sub in model.modules():
        if isinstance(sub, BoTMHSA):
            sub.core = core
