"""Classification metrics (counterpart of ``sav_tpu/utils/metrics.py``),
computed on the logits' device."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, prefix: str = '',
                 topk: Tuple[int, ...] = (1, 5)) -> Dict[str, torch.Tensor]:
    """Per-example 0/1 correctness (f32) for each k in ``topk``.

    Args:
      logits: ``[batch, num_classes]``.
      labels: ``[batch]`` integer labels.
      mask: optional ``[batch]`` validity mask.
    """
    num_classes = logits.shape[-1]
    max_k = min(max(topk), num_classes)   # k may exceed tiny class counts
    pred = torch.topk(logits, max_k, dim=-1).indices      # best first
    hits = pred == labels[..., None].to(pred.dtype)
    metrics = {}
    for k in topk:
        correct = hits[..., :min(k, num_classes)].any(dim=-1).float()
        if mask is not None:
            correct = correct * mask
        metrics[f'{prefix}top_{k}_acc'] = correct
    return metrics
