"""Linear patch embedding (counterpart of ``sav_tpu/nn/stems.py``): a
patchify rearrange + Dense, not a conv, so the kernel keeps the checkpoint
layout ``[ph*pw*C, embed_dim]``."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from sav_tpu_torch.nn.layers import Dense


def patchify(images: torch.Tensor, patch_shape: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B, num_patches, ph*pw*C] (row-major patch order)."""
    ph, pw = patch_shape
    b, h, w, c = images.shape
    x = images.reshape(b, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // ph) * (w // pw), ph * pw * c)


class PatchEmbedBlock(nn.Module):
    """Non-overlapping patch extraction followed by a linear embedding."""

    def __init__(self, patch_shape: Tuple[int, int], embed_dim: int,
                 in_ch: int = 3, use_bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.patch_shape = tuple(patch_shape)
        self.Dense_0 = Dense(patch_shape[0] * patch_shape[1] * in_ch,
                             embed_dim, use_bias=use_bias, dtype=dtype)

    def forward(self, inputs):
        return self.Dense_0(patchify(inputs, self.patch_shape))
