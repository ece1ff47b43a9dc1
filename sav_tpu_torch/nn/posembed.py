"""Positional embeddings: learned absolute, fixed sinusoidal, rotary
(counterpart of ``sav_tpu/nn/posembed.py``, its whole API)."""

from __future__ import annotations

import torch
from torch import nn


class AddAbsPosEmbed(nn.Module):
    """Adds a learned absolute positional embedding ``pos_embed [1, L, D]``."""

    def __init__(self, seq_len: int, dim: int):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.empty(1, seq_len, dim))

    def init_params(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)

    def forward(self, inputs):
        return inputs + self.pos_embed


def sincos_frequencies(seq_len: int, dim: int, dtype=torch.float32,
                       base: float = 10000.0, device=None) -> torch.Tensor:
    """Standard sinusoidal frequency table ``[seq_len, dim // 2]``."""
    exponent = torch.arange(0, dim, 2, dtype=dtype, device=device) / dim
    inv_freq = 1.0 / (base ** exponent)
    positions = torch.arange(seq_len, dtype=dtype, device=device)
    return torch.outer(positions, inv_freq)


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...) on the last axis."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def apply_rotary_pos_emb(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of ``[..., seq, dim]`` by a ``[seq, dim // 2]``
    angle table: each pair (x_2i, x_2i+1) rotated by its position's
    angle."""
    sin = torch.sin(freqs).repeat_interleave(2, dim=-1).to(x.dtype)
    cos = torch.cos(freqs).repeat_interleave(2, dim=-1).to(x.dtype)
    return x * cos + rotate_every_two(x) * sin


def apply_rotary_heads(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotary embedding for per-head projections ``[..., seq, heads, dim]``
    by a ``[seq, dim // 2]`` angle table broadcast over the heads axis (the
    rotation of ``apply_rotary_pos_emb``)."""
    sin = torch.sin(freqs).repeat_interleave(2, dim=-1)[:, None, :].to(x.dtype)
    cos = torch.cos(freqs).repeat_interleave(2, dim=-1)[:, None, :].to(x.dtype)
    return x * cos + rotate_every_two(x) * sin


class FixedPositionalEmbedding(nn.Module):
    """Fixed sinusoidal positional embedding added to ``[..., seq, dim]``
    (the sequence on ``seq_axis``)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype

    def forward(self, inputs, seq_axis: int = -2):
        seq_len, dim = inputs.shape[seq_axis], inputs.shape[-1]
        freqs = sincos_frequencies(seq_len, dim, device=inputs.device)
        table = torch.cat([torch.sin(freqs), torch.cos(freqs)], dim=-1)
        return inputs + table.to(self.dtype)


class RotaryPositionalEmbedding(nn.Module):
    """Rotary positional embedding of a ``[..., seq, dim]`` input (the
    sequence on ``seq_axis``); parameter-free, in the input's dtype."""

    def forward(self, inputs, seq_axis: int = -2):
        seq_len, dim = inputs.shape[seq_axis], inputs.shape[-1]
        freqs = sincos_frequencies(seq_len, dim, device=inputs.device)
        return apply_rotary_pos_emb(inputs, freqs)
