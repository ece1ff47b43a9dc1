"""Fine-tuning: pretrained weights into another model geometry
(counterpart of ``sav_tpu/train/finetune.py``, the same adaptations,
refusals and report lines).

- **Head re-initialisation** when ``num_classes`` changes: the
  classifier Dense keeps the target's init (zeros in every model).
- **Learned position-embedding interpolation** when the token grid
  changes: bilinear over the 2-D patch grid, the cls prefix token, when
  present, carried through unchanged. BoTNet's 1-D relative-position
  tables are resampled along their position axis.

Everything else must match exactly. Both resamples are
``F.interpolate(mode='bilinear', align_corners=False, antialias=True)``
in f32: that is ``jax.image.resize``'s ``'bilinear'`` and ``'linear'``,
which antialias when they shrink (without ``antialias`` a shrink differs
by O(1); ``mode='linear'`` differs from JAX's 1-D resample when it
shrinks, so the table is resized as a ``[1, 1, L, d]`` image whose second
axis keeps its size).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sav_tpu_torch.models import create_model
from sav_tpu_torch.train.checkpoint import CheckpointManager
from sav_tpu_torch.utils.flax_bridge import (flatten_tree, torch_to_flax,
                                             unflatten_tree)

# Param names produced by AddAbsPosEmbed / BoTNet's relative attention.
_POS_EMBED = 'pos_embed'
_REL_POS = ('rel_pos_emb_w', 'rel_pos_emb_h')


def _square_grid(n: int) -> Optional[int]:
    root = math.isqrt(n) if n > 0 else 0
    return root if root and root * root == n else None


def _split_prefix(src_len: int, dst_len: int) -> Tuple[int, int, int]:
    """Finds (prefix, src_grid, dst_grid) such that both token counts are
    ``prefix + grid**2`` for the same prefix (0 = no cls token, 1 = cls
    prepended before the embedding, as in ViT/TNT outer)."""
    for prefix in (0, 1):
        src_g = _square_grid(src_len - prefix)
        dst_g = _square_grid(dst_len - prefix)
        if src_g and dst_g:
            return prefix, src_g, dst_g
    raise ValueError(
        f'cannot infer square token grids for pos-embed interpolation '
        f'({src_len} -> {dst_len} tokens; neither a bare nor a '
        f'cls-prefixed length is a perfect square for both)')


def _resize(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``[1, C, H, W]`` f32 -> ``[1, C, *size]``, bilinear, antialiased
    when shrinking (``jax.image.resize``'s bilinear)."""
    out = F.interpolate(torch.from_numpy(np.ascontiguousarray(image)),
                        size=size, mode='bilinear', align_corners=False,
                        antialias=True)
    return out.numpy()


def interpolate_pos_embed(pos_embed: np.ndarray,
                          target_len: int) -> np.ndarray:
    """Resizes a learned ``[1, L, D]`` embedding to ``[1, target_len, D]``.

    Bilinear interpolation over the square patch grid in float32; an
    optional single prefix (cls) token is preserved verbatim.
    """
    pos_embed = np.asarray(pos_embed)
    if pos_embed.ndim != 3 or pos_embed.shape[0] != 1:
        raise ValueError(f'pos-embed must be [1, L, D], got {pos_embed.shape}')
    src_len, dim = pos_embed.shape[1], pos_embed.shape[2]
    if src_len == target_len:
        return pos_embed
    prefix, src_g, dst_g = _split_prefix(src_len, target_len)
    head = pos_embed[:, :prefix].astype(np.float32)
    grid = pos_embed[0, prefix:].astype(np.float32)            # [g*g, D]
    grid = grid.T.reshape(1, dim, src_g, src_g)
    grid = _resize(grid, (dst_g, dst_g)).reshape(dim, dst_g * dst_g).T
    return np.concatenate([head, grid[None]], axis=1).astype(pos_embed.dtype)


def interpolate_rel_pos_embed(table: np.ndarray,
                              target_len: int) -> np.ndarray:
    """Linearly resamples a ``[2W-1, d]`` relative-position table along its
    position axis (BoTNet, models/botnet.py rel_pos_emb_{w,h})."""
    table = np.asarray(table)
    if table.ndim != 2:
        raise ValueError(f'rel-pos table must be [L, d], got {table.shape}')
    if table.shape[0] == target_len:
        return table
    out = _resize(table.astype(np.float32)[None, None],
                  (target_len, table.shape[1]))
    return out[0, 0].astype(table.dtype)


def _unflatten(flat: Dict[Tuple[str, ...], Any]) -> dict:
    return unflatten_tree({'/'.join(k): v for k, v in flat.items()})


def _flatten(tree) -> Dict[Tuple[str, ...], Any]:
    return {tuple(k.split('/')): v for k, v in flatten_tree(tree or {}).items()}


def adapt_tree(restored: Any, target: Any,
               collection: str = 'params',
               allow_head_reinit: bool = True) -> Tuple[Any, List[str]]:
    """Fills the target-shaped tree (flax tree of numpy arrays) from
    restored leaves.

    Returns ``(tree, report)`` where report lists every adapted leaf.
    Raises ValueError on structural mismatch or unadaptable shape changes.
    ``allow_head_reinit=False`` (the inference mode) additionally refuses
    classifier-width changes — re-initialising a head is a fine-tune
    start, not something eval/serving can recover from.
    """
    rflat, tflat = _flatten(restored), _flatten(target)
    if rflat.keys() != tflat.keys():
        missing = sorted('/'.join(k) for k in tflat.keys() - rflat.keys())
        extra = sorted('/'.join(k) for k in rflat.keys() - tflat.keys())
        raise ValueError(
            f'checkpoint {collection} tree does not match the model: '
            f'missing {missing[:5]}, unexpected {extra[:5]} '
            f'(same model family / scan_layers layout required)')
    out: Dict[Tuple[str, ...], Any] = {}
    report: List[str] = []
    for key, tleaf in tflat.items():
        rleaf = rflat[key]
        path = '/'.join(key)
        if tuple(rleaf.shape) == tuple(tleaf.shape):
            out[key] = np.asarray(rleaf, dtype=tleaf.dtype)
            continue
        if (key[-1] == _POS_EMBED and rleaf.ndim == 3
                and rleaf.shape[2] == tleaf.shape[2]):
            out[key] = interpolate_pos_embed(rleaf, tleaf.shape[1])
            report.append(f'{path}: pos-embed interpolated '
                          f'{rleaf.shape[1]} -> {tleaf.shape[1]} tokens')
            continue
        if (key[-1] in _REL_POS and rleaf.ndim == 2
                and rleaf.shape[1] == tleaf.shape[1]):
            out[key] = interpolate_rel_pos_embed(rleaf, tleaf.shape[0])
            report.append(f'{path}: rel-pos table resampled '
                          f'{rleaf.shape[0]} -> {tleaf.shape[0]}')
            continue
        if (rleaf.shape[:-1] == tleaf.shape[:-1]
                and key[-1] in ('kernel', 'bias')
                and len(key) == 2 and key[-2].startswith('Dense')):
            if not allow_head_reinit:
                raise ValueError(
                    f'checkpoint head is {rleaf.shape[-1]}-way but the '
                    f'model was built for {tleaf.shape[-1]} classes; pass '
                    f'the matching --num_classes (head re-init is a '
                    f'--finetune_from workflow, not an eval/serving one)')
            # classifier head with a new label count (every model's head is
            # a root-level Dense; depth-2 only, so an interior FF Dense can
            # never be silently re-initialised): keep the target init
            out[key] = np.array(tleaf)
            report.append(f'{path}: head re-initialised for '
                          f'{tleaf.shape[-1]} classes')
            continue
        raise ValueError(
            f'cannot adapt {collection} leaf {path}: checkpoint shape '
            f'{tuple(rleaf.shape)} vs model {tuple(tleaf.shape)} — only '
            f'pos-embed grids, BoTNet rel-pos tables, and the classifier '
            f'head may differ (is this a resolution-bound layer, e.g. '
            f"MLP-Mixer's token-mixing Dense?)")
    return _unflatten(out), report


def model_shapes(model_name: str, img_size: int, **model_kwargs) -> dict:
    """The flax variables of ``model_name`` built at ``img_size`` on the
    ``meta`` device: ``{'params': ..., 'batch_stats': ...}`` of zero-stride
    arrays with the leaves' shapes, no weights drawn or kept."""
    model = create_model(model_name, img_size=img_size, device='meta',
                         **model_kwargs)
    buffers = [name for name, _ in model.named_buffers()]
    variables = torch_to_flax(model.state_dict(), buffers)
    return variables if buffers else {'params': variables}


def adapt_restored_for_inference(model_name: str, restored: Dict[str, Any],
                                 img_size: int, **model_kwargs
                                 ) -> Tuple[Dict[str, Any], List[str]]:
    """Resolution-adapts a template-free inference restore
    (``CheckpointManager.restore_for_inference``) to the serving geometry
    (``predict -s`` / ``evaluate`` at a resolution other than the
    checkpoint's): pos-embed grids and BoTNet rel-pos tables interpolate,
    everything else — including the classifier head — must match exactly.

    Target shapes come from ``model_shapes`` (``model_kwargs``: what
    ``create_model`` takes, ``num_classes`` among them); when every shape
    already matches, the restore is returned untouched. Returns
    ``(restored, report)``.
    """
    target = model_shapes(model_name, img_size, **model_kwargs)

    def shapes(tree):
        return [tuple(v.shape) for v in flatten_tree(tree).values()]

    report: List[str] = []
    out = dict(restored)
    for collection, key in (('params', 'params'),
                            ('params', 'ema_params'),
                            ('batch_stats', 'batch_stats')):
        source = restored.get(key)
        if not source or collection not in target:
            continue
        if shapes(source) == shapes(target[collection]):
            continue
        adapted, rep = adapt_tree(source, target[collection], collection,
                                  allow_head_reinit=False)
        out[key] = adapted
        report += [f'{key}/{line}' for line in rep]
    return out, report


def load_pretrained(checkpoint_dir: str, target_params: Any,
                    target_batch_stats: Any = None,
                    step: Optional[int] = None,
                    use_ema: bool = False) -> Tuple[Any, Any, List[str]]:
    """Loads a checkpoint and adapts it to the target geometry.

    Returns ``(params, batch_stats, report)``. ``use_ema=True`` prefers the
    checkpoint's EMA parameters (the eval-grade weights) when present.
    """
    ckpt = CheckpointManager(checkpoint_dir)
    try:
        restored = ckpt.restore_for_inference(step=step)
    finally:
        ckpt.close()
    if restored is None:
        raise ValueError(f'no checkpoint found in {checkpoint_dir}')
    source = restored['params']
    if use_ema and restored.get('ema_params') is not None:
        source = restored['ema_params']
    params, report = adapt_tree(source, target_params, 'params')
    batch_stats = target_batch_stats
    if target_batch_stats:
        batch_stats, bs_report = adapt_tree(restored.get('batch_stats') or {},
                                            target_batch_stats, 'batch_stats')
        report += bs_report
    return params, batch_stats, report
