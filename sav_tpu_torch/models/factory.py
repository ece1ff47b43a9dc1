"""String-keyed model factory (counterpart of
``sav_tpu/models/factory.py``): every name of the JAX factory, the ViT,
CaiT, MLP-Mixer, TNT, BoTNet, CeiT and CvT families (all 34), and the
``model.json`` specs that the checkpoint importers write
(``sav_tpu_torch.import_checkpoint``, the JAX package's
``scripts/import_*.py``), which build an architecture outside the
registry."""

from __future__ import annotations

import inspect
import json
import os
from typing import Any, Dict, Optional

import torch

from sav_tpu_torch import resolve_device
from sav_tpu_torch.models import botnet, cait, ceit, cvt, mlp_mixer, tnt, vit
from sav_tpu_torch.models.botnet import BoTNet
from sav_tpu_torch.models.cait import CaiT
from sav_tpu_torch.models.ceit import CeiT
from sav_tpu_torch.models.cvt import CvT
from sav_tpu_torch.models.mlp_mixer import MLPMixer
from sav_tpu_torch.models.tnt import TNT
from sav_tpu_torch.models.vit import ViT
from sav_tpu_torch.nn.feedforward import ACTIVATIONS
from sav_tpu_torch.nn.layers import init_all


def _vit(num_layers, num_heads, embed_dim, patch):
    return ViT, dict(num_layers=num_layers, num_heads=num_heads,
                     embed_dim=embed_dim, patch_shape=(patch, patch))


def _cait(num_layers, num_heads, embed_dim, stoch_depth_rate, layerscale_eps):
    return CaiT, dict(num_layers=num_layers, num_layers_token_only=2,
                      num_heads=num_heads, embed_dim=embed_dim,
                      patch_shape=(16, 16),
                      stoch_depth_rate=stoch_depth_rate,
                      layerscale_eps=layerscale_eps)


def _mixer(num_layers, embed_dim, patch):
    return MLPMixer, dict(num_layers=num_layers, embed_dim=embed_dim,
                          patch_shape=(patch, patch))


MODEL_CONFIGS: Dict[str, Any] = {
    'vit_ti_patch16': _vit(12, 3, 192, 16),
    'vit_s_patch32': _vit(12, 6, 384, 32),
    'vit_s_patch16': _vit(12, 6, 384, 16),
    'vit_b_patch32': _vit(12, 12, 768, 32),
    'vit_b_patch16': _vit(12, 12, 768, 16),
    'vit_l_patch32': _vit(24, 16, 1024, 32),
    'vit_l_patch16': _vit(24, 16, 1024, 16),
    'cait_xxs_24': _cait(24, 4, 192, 0.05, 1e-5),
    'cait_xxs_36': _cait(36, 4, 192, 0.1, 1e-6),
    'cait_xs_24': _cait(24, 6, 288, 0.05, 1e-5),
    'cait_xs_36': _cait(36, 6, 288, 0.1, 1e-6),
    'cait_s_24': _cait(24, 8, 384, 0.1, 1e-6),
    'cait_s_36': _cait(36, 8, 384, 0.2, 1e-6),
    'cait_s_48': _cait(48, 8, 384, 0.3, 1e-6),
    'cait_m_24': _cait(24, 16, 768, 0.2, 1e-5),
    'cait_m_36': _cait(36, 16, 768, 0.3, 1e-6),
    'cait_m_48': _cait(48, 16, 768, 0.4, 1e-6),
    'mixer_s_patch32': _mixer(8, 512, 32),
    'mixer_s_patch16': _mixer(8, 512, 16),
    'mixer_b_patch32': _mixer(12, 768, 32),
    'mixer_b_patch16': _mixer(12, 768, 16),
    'mixer_l_patch32': _mixer(24, 1024, 32),
    'mixer_l_patch16': _mixer(32, 1024, 16),
    'botnet_t3': (BoTNet, dict(stage_sizes=(3, 4, 6, 6))),
    'botnet_t4': (BoTNet, dict(stage_sizes=(3, 4, 23, 6))),
    'botnet_t5': (BoTNet, dict(stage_sizes=(3, 4, 23, 12))),
    'tnt_s_patch16': (TNT, dict(num_layers=12, inner_num_heads=4,
                                outer_num_heads=6, inner_embed_dim=24,
                                outer_embed_dim=384)),
    'tnt_b_patch16': (TNT, dict(num_layers=12, inner_num_heads=4,
                                outer_num_heads=10, inner_embed_dim=40,
                                outer_embed_dim=640)),
    'ceit_t': (CeiT, dict(num_layers=12, num_heads=3, embed_dim=192)),
    'ceit_s': (CeiT, dict(num_layers=12, num_heads=6, embed_dim=384)),
    'ceit_b': (CeiT, dict(num_layers=12, num_heads=12, embed_dim=768)),
    'cvt-13': (CvT, dict(stage_sizes=(1, 2, 10), num_heads=(1, 3, 6),
                         embed_dim=(64, 192, 384))),
    'cvt-21': (CvT, dict(stage_sizes=(1, 4, 16), num_heads=(1, 3, 6),
                         embed_dim=(64, 192, 384))),
    'cvt-w24': (CvT, dict(stage_sizes=(2, 2, 20), num_heads=(3, 12, 16),
                          embed_dim=(192, 768, 1024))),
}


def available_models():
    """All model names ``create_model`` accepts."""
    return sorted(MODEL_CONFIGS)


# a spec's "model" -> its class (sav_tpu/models/factory.py:_SPEC_CLASSES)
SPEC_CLASSES = {'vit': ViT, 'cait': CaiT, 'ceit': CeiT, 'cvt': CvT,
                'tnt': TNT, 'botnet': BoTNet, 'mixer': MLPMixer}


def spec_path(model_name: str) -> Optional[str]:
    """The ``model.json`` that ``model_name`` names: a path ending in
    ``.json``, or a directory (written with a path separator, so no
    registry name is taken for one) that holds ``model.json``; else
    None."""
    if model_name.endswith('.json'):
        return model_name
    if (os.path.sep in model_name
            and os.path.isfile(os.path.join(model_name, 'model.json'))):
        return os.path.join(model_name, 'model.json')
    return None


def _spec_activation(name: str) -> str:
    if name not in ACTIVATIONS:
        raise RuntimeError(f'unknown activation {name!r} in model spec; '
                           f'known: {", ".join(sorted(ACTIVATIONS))}')
    return name


def read_spec(path: str):
    """``(model class, constructor kwargs)`` of a ``model.json``:
    ``{"model": "vit", "kwargs": {...}}``, lists as tuples, ``activation``
    (gelu | gelu_exact | relu) decoded into ``activation_fn``. A spec of
    the scan-stacked layout, or with an activation on a family other than
    ViT, raises NotImplementedError naming its ROADMAP.md item."""
    with open(path) as f:
        spec = json.load(f)
    try:
        model_cls = SPEC_CLASSES[spec['model']]
    except KeyError:
        raise RuntimeError(
            f'model spec {path!r} names unknown model '
            f'{spec.get("model")!r}; known: '
            f'{", ".join(sorted(SPEC_CLASSES))}') from None
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in spec.get('kwargs', {}).items()}
    if kwargs.pop('scan_layers', False):
        raise NotImplementedError(
            f'model spec {path!r} is of the scan-stacked layout '
            '(scan_layers), which is not ported to sav_tpu_torch yet (the '
            'scan-stacked layout: Queue 1 item 1, ROADMAP.md)')
    if 'activation' in kwargs:
        if model_cls is not ViT:
            raise NotImplementedError(
                f'model spec {path!r} sets activation on {spec["model"]!r}: '
                'only ViT takes another activation than the tanh gelu in '
                'sav_tpu_torch so far (Queue 1 item 19, ROADMAP.md)')
        kwargs['activation_fn'] = _spec_activation(kwargs.pop('activation'))
    return model_cls, kwargs


def resolve_num_classes(model_name: str, num_classes: Optional[int]) -> int:
    """The head width ``create_model(model_name, num_classes)`` builds:
    ``num_classes`` where given; else a spec's own, else 1000."""
    if num_classes is not None:
        return num_classes
    path = spec_path(model_name)
    if path is not None:
        return read_spec(path)[1].get('num_classes', 1000)
    return 1000


def create_model(model_name: str, num_classes: Optional[int] = None,
                 dtype=torch.float32, img_size: int = 224, seed: int = 0,
                 device=None, **overrides) -> torch.nn.Module:
    """Builds a model from its registry name or a ``model.json`` spec
    (``spec_path``), randomly initialised from ``seed`` (flax's
    initialisers, torch's random stream), on ``device`` (the card unless
    ``'cpu'`` is asked for).

    ``device='meta'`` builds the modules with shapes only (no weights),
    for what needs a model's tree but none of its values.

    ``num_classes`` None is the spec's own head width (a checkpoint's, not
    negotiable when serving it), else 1000; a width given wins, as a
    fine-tune's new head does. ``img_size`` is not part of a spec.

    Extra keyword arguments override config fields (``use_kernel=False``
    forces the plain attention path, ``num_layers=2`` or, for BoTNet and
    CvT, ``stage_sizes`` cuts depth, ``quantized`` picks an int8 route of
    the ViT, CaiT, Mixer and CvT families and raises for the others); on
    the spec path one the model does not take raises, listing those it
    does.
    """
    path = spec_path(model_name)
    if path is not None:
        model_cls, config = read_spec(path)
        spec_classes = config.pop('num_classes', 1000)
        num_classes = spec_classes if num_classes is None else num_classes
    else:
        try:
            model_cls, config = MODEL_CONFIGS[model_name]
        except KeyError:
            raise RuntimeError(
                f'Model not found: {model_name!r}. The torch port has '
                f'{", ".join(available_models())}') from None
        num_classes = 1000 if num_classes is None else num_classes
    if ('quantized' in overrides
            and model_cls not in (ViT, CaiT, MLPMixer, CvT)):
        if overrides.pop('quantized'):
            raise RuntimeError(
                f'{model_cls.__name__} does not support quantized (--quantized '
                'is honored by the ViT, CaiT, Mixer and CvT families; this '
                'family has no int8 path, as in the JAX package)')
    if path is not None:
        supported = set(inspect.signature(model_cls).parameters) - {
            'num_classes', 'dtype', 'img_size'}
        unknown = sorted(k for k in overrides if k not in supported)
        if unknown:
            raise RuntimeError(
                f'{model_cls.__name__} does not support {", ".join(unknown)}; '
                f'supported overrides: {", ".join(sorted(supported))}')
    device = resolve_device(device)
    kwargs = dict(num_classes=num_classes, dtype=dtype, img_size=img_size,
                  **{**config, **overrides})
    if device.type == 'meta':           # shapes only: no weights drawn
        with device:
            return model_cls(**kwargs)
    model = model_cls(**kwargs)
    init_all(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def set_int8_core(model: torch.nn.Module, core: str) -> None:
    """``'kernel'`` or ``'plain'``: what every int8 block of a built model
    runs, the kernels (K10-K14) or their twins on the same autograd
    boundaries (the card's reference for them), on the same weights."""
    from sav_tpu_torch.ops.int8_ff import CORES
    if core not in CORES:
        raise ValueError(f'core must be one of {CORES}, got {core!r}')
    for sub in model.modules():
        if hasattr(sub, 'int8_core'):
            sub.int8_core = core


def set_use_kernel(model: torch.nn.Module, use_kernel) -> None:
    """Re-routes every kernel-routed block of a built model, of any family,
    on the same weights (``use_kernel=False``: the plain per-op path)."""
    if isinstance(model, CaiT):
        cait.set_use_kernel(model, use_kernel)
    elif isinstance(model, MLPMixer):
        mlp_mixer.set_use_kernel(model, use_kernel)
    elif isinstance(model, TNT):
        tnt.set_use_kernel(model, use_kernel)
    elif isinstance(model, BoTNet):
        botnet.set_use_kernel(model, use_kernel)
    elif isinstance(model, CeiT):
        ceit.set_use_kernel(model, use_kernel)
    elif isinstance(model, CvT):
        cvt.set_use_kernel(model, use_kernel)
    else:
        vit.set_use_kernel(model, use_kernel)
