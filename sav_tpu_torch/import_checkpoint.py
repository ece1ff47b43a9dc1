"""Public ViT checkpoints into the port's layout (counterpart of the JAX
package's ``scripts/import_hf_checkpoint.py``, ``import_timm_checkpoint.py``
and ``import_vit_npz.py``).

    python -m sav_tpu_torch.import_checkpoint hf   HF_DIR    OUT [--ema]
    python -m sav_tpu_torch.import_checkpoint timm CKPT.pth  OUT [--num-heads N]
    python -m sav_tpu_torch.import_checkpoint npz  CKPT.npz  OUT

``hf`` reads a local ``save_pretrained`` directory (``config.json`` and
``model.safetensors``, its sharded index or ``pytorch_model.bin``; no
``transformers`` needed), ``timm`` a VisionTransformer state dict
(``torch.load`` with ``weights_only=True``), ``npz`` a google-research
``vision_transformer`` (AugReg) file. A checkpoint without a usable head
(a headless ``ViTModel``, a timm trunk, an in21k ``pre_logits`` npz) gets a
zero head of ``--num-classes``.

OUT receives a step-0 Trainer checkpoint (``train/checkpoint.py``: the
params, zero Adam moments, an EMA of the params with ``--ema``), the
serving export ``params.npz`` and ``model.json``, the architecture's spec.
Every CLI takes ``-m OUT`` or ``-m OUT/model.json`` with ``-c OUT``:
``predict``, ``evaluate``, and ``train --finetune_from OUT`` (a new
``--num_classes`` and ``-s`` re-initialise the head and resample the
pos-embed). The port's restore reads the moments at any optimizer
setting, so none is asked for here.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Tuple

import numpy as np

SOURCES = ('hf', 'timm', 'npz')


def convert(source: str, path: str, num_classes: int = 1000,
            num_heads=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(params, model_kwargs)`` of the checkpoint at ``path`` of kind
    ``source`` (one of ``SOURCES``)."""
    if source == 'hf':
        from sav_tpu_torch.utils.hf_import import convert_hf_vit, read_hf_dir
        state_dict, config = read_hf_dir(path)
        return convert_hf_vit(state_dict, config, num_classes=num_classes)
    if source == 'timm':
        from sav_tpu_torch.utils.timm_import import (convert_timm_vit,
                                                     read_timm_file)
        return convert_timm_vit(read_timm_file(path), num_heads=num_heads,
                                num_classes=num_classes)
    if source == 'npz':
        from sav_tpu_torch.utils.npz_import import convert_vit_npz
        with np.load(path) as npz:
            return convert_vit_npz(npz, num_classes=num_classes)
    raise ValueError(f'source must be one of {SOURCES}, got {source!r}')


def native_size(params: Dict[str, Any], model_kwargs: Dict[str, Any]) -> int:
    """The image size the checkpoint's pos-embed grid was trained at."""
    tokens = params['Encoder_0']['AddAbsPosEmbed_0']['pos_embed'].shape[1]
    return int(round((tokens - 1) ** 0.5)) * model_kwargs['patch_shape'][0]


def write_imported(out_dir: str, params: Dict[str, Any],
                   model_kwargs: Dict[str, Any], ema: bool = False) -> str:
    """Writes ``out_dir``: the spec, the step-0 checkpoint and
    ``params.npz`` (module docstring), after holding the tree against the
    spec's model built on the ``meta`` device (the same leaves and
    shapes). Returns the spec's path."""
    from sav_tpu_torch.models import create_model
    from sav_tpu_torch.train.checkpoint import (PARAMS_FILE, CheckpointManager,
                                                write_params_npz)
    from sav_tpu_torch.utils.flax_bridge import (flatten_tree, torch_to_flax,
                                                 unflatten_tree)
    from sav_tpu_torch.utils.hf_import import model_spec

    os.makedirs(out_dir, exist_ok=True)
    spec_path = os.path.join(out_dir, 'model.json')
    with open(spec_path, 'w') as f:
        json.dump(model_spec(model_kwargs), f, indent=1)
    model = create_model(spec_path, img_size=native_size(params, model_kwargs),
                         device='meta')
    want = {k: v.shape for k, v in
            flatten_tree(torch_to_flax(model.state_dict())).items()}
    got = {k: np.shape(v) for k, v in flatten_tree(params).items()}
    if got != want:
        bad = sorted(k for k in want.keys() | got.keys()
                     if want.get(k) != got.get(k))
        raise ValueError(f'the converted tree does not fit its spec at '
                         f'{bad[:5]}')
    flat = flatten_tree(params)
    zeros = {k: np.zeros(v.shape, np.float32) for k, v in flat.items()}
    tree = {'step': np.asarray(0, np.int64),
            'params': params,
            'ema_params': params if ema else None,
            'opt_state': {'count': np.asarray(0, np.int64),
                          'mu': unflatten_tree(zeros),
                          'nu': unflatten_tree(zeros)}}
    manager = CheckpointManager(out_dir)
    try:
        manager.write(0, tree)
    finally:
        manager.close()
    write_params_npz(os.path.join(out_dir, PARAMS_FILE), {'params': params})
    return spec_path


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('source', choices=SOURCES)
    p.add_argument('src', help='HF directory, timm .pth/.bin or AugReg .npz')
    p.add_argument('out_dir')
    p.add_argument('--num-classes', type=int, default=1000,
                   help='head width of a checkpoint without a usable head '
                        '(zero-initialised)')
    p.add_argument('--num-heads', type=int, default=None,
                   help='timm: head count (default: embed_dim // 64)')
    p.add_argument('--ema', action='store_true',
                   help='also store the params as the EMA (for a run with '
                        '--ema_decay that resumes from OUT)')
    p.add_argument('--scan-layers', action='store_true',
                   help='the scan-stacked layout (not ported)')
    return p


def main(argv=None) -> str:
    a = _parser().parse_args(argv)
    if a.scan_layers:
        raise NotImplementedError(
            '--scan-layers (the scan-stacked layout) is not ported to '
            'sav_tpu_torch yet (Queue 1 item 1, ROADMAP.md)')
    if a.num_heads is not None and a.source != 'timm':
        raise SystemExit('error: --num-heads is for timm checkpoints only '
                         '(the others carry their head count)')
    params, model_kwargs = convert(a.source, a.src, a.num_classes,
                                   a.num_heads)
    spec_path = write_imported(a.out_dir, params, model_kwargs, a.ema)
    img = native_size(params, model_kwargs)
    print(f'wrote a step-0 checkpoint and params.npz to {a.out_dir}')
    print(f'wrote the model spec to {spec_path} (native image size {img}, '
          f'{model_kwargs["num_classes"]} classes)')
    print('use it with any CLI, e.g.')
    print(f'  python -m sav_tpu_torch.predict -m {spec_path} -c {a.out_dir} '
          f'-s {img} --images <glob>')
    print(f'  python -m sav_tpu_torch.train -m {spec_path} --finetune_from '
          f'{a.out_dir} -c <new dir> --data_dir <data> --num_classes <n>')
    return spec_path


if __name__ == '__main__':
    main()
