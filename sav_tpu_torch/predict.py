"""Batched inference CLI of the torch port (counterpart of ``predict.py``).

Decodes JPEGs on the host (PIL), runs the eval transform (resize-small ->
central crop -> normalize) and the model forward on the device, and prints
one JSON line per image with the top-k classes. ``-c`` names a Trainer
checkpoint directory (``train/checkpoint.py``): the latest step's weights
load, its EMA with ``--ema`` where it keeps one; with no step there, its
``params.npz`` (the flax params tree flattened with ``/`` keys, and for
BatchNorm models the running statistics under ``batch_stats/``); with
neither, the model predicts from random init, with a warning. At an
``-s`` other than the checkpoint's, pos-embed grids and BoTNet's rel-pos
tables are interpolated (``train/finetune.adapt_restored_for_inference``);
another head width raises.

Example:
    python -m sav_tpu_torch.predict -m vit_b_patch16 -c /tmp/ckpt \
        --images '/data/val/**/*.jpg' --top_k 5
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from sav_tpu_torch import resolve_device
from sav_tpu_torch.data.jpeg_source import decode_jpeg_fixed
from sav_tpu_torch.data.preprocess import eval_preprocess
from sav_tpu_torch.models import create_model
from sav_tpu_torch.train.checkpoint import CheckpointManager, read_params_npz
from sav_tpu_torch.train.finetune import adapt_restored_for_inference
from sav_tpu_torch.utils.flax_bridge import flax_to_torch

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def decode_size_for(img_size: int) -> int:
    """Host decode frame edge for an eval size (256 for 224, 439 for 384)."""
    return max(img_size, int(round(img_size * 256 / 224)))


@torch.inference_mode()
def serve(model, frames_uint8, img_size: int, top_k: int):
    """uint8 frames ``[N, S, S, 3]`` -> (top-k probabilities, class ids),
    both ``[N, top_k]`` on the model's device. Nothing here waits for the
    device: frames go up from pinned memory, so the host can queue the next
    batch while the card works on this one."""
    device = next(model.parameters()).device
    raw = torch.as_tensor(frames_uint8)
    if device.type == 'cuda':
        raw = raw.pin_memory()
    raw = raw.to(device, non_blocking=True)
    x = eval_preprocess(raw.float(), img_size)
    logits = model(x.to(model.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.topk(probs, top_k, dim=-1)


def load_variables(model, params, batch_stats, source: str) -> None:
    """Loads a flax params tree into ``model``, and ``batch_stats`` into the
    BatchNorms' buffers. A model with running statistics raises where
    ``source`` has none rather than serve on the initial mean 0 and var
    1."""
    variables = {'params': params}
    if batch_stats:
        variables['batch_stats'] = batch_stats
    elif next(model.buffers(), None) is not None:
        raise ValueError(
            f'{source} holds no batch_stats, but {type(model).__name__} '
            'normalises by running statistics (BatchNorm); its Trainer '
            'checkpoint writes them under batch_stats/')
    model.load_state_dict(flax_to_torch(variables), strict=True)


def load_params_npz(model, path: str) -> None:
    """Loads a ``/``-keyed flat npz of the flax params tree into ``model``,
    and the running statistics under its ``batch_stats/`` keys into the
    BatchNorms' buffers (``load_variables``)."""
    tree = read_params_npz(path)
    load_variables(model, tree['params'], tree['batch_stats'], path)


def restore_weights(model, model_name: str, checkpoint_dir: str,
                    img_size: int, use_ema: bool, step=None,
                    **model_kwargs):
    """Loads ``checkpoint_dir``'s weights into ``model`` (built as
    ``create_model(model_name, img_size=img_size, **model_kwargs)``):
    step ``step`` (default: the latest, else the directory's
    ``params.npz``), its EMA where ``use_ema`` and the checkpoint keeps one,
    adapted to ``img_size``. Prints what it loaded to stderr and returns
    the restore (``CheckpointManager.restore_for_inference``), or None
    where the directory holds no checkpoint."""
    ckpt = CheckpointManager(checkpoint_dir)
    try:
        restored = ckpt.restore_for_inference(step=step)
    finally:
        ckpt.close()
    if restored is None:
        return None
    restored, report = adapt_restored_for_inference(model_name, restored,
                                                    img_size, **model_kwargs)
    ema = use_ema and restored['ema_params'] is not None
    load_variables(model, restored['ema_params' if ema else 'params'],
                   restored['batch_stats'], checkpoint_dir)
    where = ('params.npz' if restored['step'] is None
             else f'the checkpoint at step {restored["step"]}')
    print(f'loaded {where} from {checkpoint_dir} '
          f'({"EMA" if ema else "raw"} params)', file=sys.stderr)
    for line in report:     # e.g. pos-embed interpolated for -s
        print(f'  {line}', file=sys.stderr)
    return restored


def _list_images(pattern: str):
    if os.path.isdir(pattern):
        found = sorted(
            p for p in glob.glob(os.path.join(pattern, '**', '*'),
                                 recursive=True)
            if p.lower().endswith(('.jpg', '.jpeg', '.png')))
    else:
        found = sorted(glob.glob(pattern, recursive=True))
    if not found:
        raise SystemExit(f'error: no images match {pattern!r}')
    return found


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('-m', '--model_name', required=True)
    p.add_argument('-c', '--checkpoint_dir', required=True,
                   help='Trainer checkpoint directory (its latest step, '
                        'else its params.npz)')
    p.add_argument('--images', required=True,
                   help='image directory or glob pattern')
    p.add_argument('-s', '--img_size', type=int, default=224)
    p.add_argument('-b', '--batch_size', type=int, default=32)
    p.add_argument('--top_k', type=int, default=5)
    p.add_argument('--num_classes', type=int, default=1000)
    p.add_argument('--dtype', default='bfloat16', choices=sorted(DTYPES))
    p.add_argument('--ema', dest='ema', action='store_true', default=True,
                   help='use the EMA params when the checkpoint carries '
                        'them (a step saved with --ema_decay)')
    p.add_argument('--no-ema', dest='ema', action='store_false')
    p.add_argument('--class_names', default=None,
                   help='optional text file, one class name per line')
    p.add_argument('--quantized', default='none',
                   choices=['none', 'int8', 'ff', 'all'],
                   help="int8 serving: 'ff' runs each FF sublayer as one "
                        "int8 kernel (K13 for ViT and CvT's stages at least "
                        "256 wide, K12 for the Mixer's and CaiT's FF "
                        "blocks); 'all' adds int8 attention projections "
                        "(K10 for ViT, K11 for CaiT's talking-heads span; "
                        "CvT quantizes its FF only); 'int8' quantizes every "
                        'FF product through the library int8 path. Weights '
                        'quantize on the fly, per call')
    p.add_argument('--device', default=None,
                   help='cuda (default) or cpu')
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    q = False if args.quantized == 'none' else (
        True if args.quantized == 'int8' else args.quantized)   # train's mapping
    device = resolve_device(args.device)
    model_kwargs = {'num_classes': args.num_classes,
                    **({'quantized': q} if q else {})}
    model = create_model(args.model_name, dtype=DTYPES[args.dtype],
                         img_size=args.img_size, device=device,
                         **model_kwargs)
    if restore_weights(model, args.model_name, args.checkpoint_dir,
                       args.img_size, args.ema, **model_kwargs) is None:
        print(f'WARNING: no checkpoint in {args.checkpoint_dir}; '
              'predicting from random init', file=sys.stderr)
    model.eval()

    names = None
    if args.class_names:
        with open(args.class_names) as f:
            names = [line.strip() for line in f if line.strip()]

    paths = _list_images(args.images)
    decode_size = decode_size_for(args.img_size)
    start = time.perf_counter()
    for lo in range(0, len(paths), args.batch_size):
        chunk = paths[lo:lo + args.batch_size]
        raw = np.stack([decode_jpeg_fixed(p, decode_size) for p in chunk])
        probs, idx = serve(model, raw, args.img_size, args.top_k)
        probs, idx = probs.cpu().numpy(), idx.cpu().numpy()
        for row, path in enumerate(chunk):
            classes = [
                {'class': (names[i] if names and i < len(names) else int(i)),
                 'prob': round(float(p), 5)}
                for i, p in zip(idx[row], probs[row])]
            print(json.dumps({'path': path, 'top_k': classes}))
    elapsed = time.perf_counter() - start
    print(f'{len(paths)} images in {elapsed:.2f}s '
          f'({len(paths) / elapsed:.1f} img/s incl. host decode, {device})',
          file=sys.stderr)


if __name__ == '__main__':
    main()
