"""The safetensors format, read and written with ``numpy`` and ``json``
(the port imports no ``safetensors`` package: the card's host has none).

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``"__metadata__"`` of strings; offsets count from the first byte
after the header), then the raw tensors, little-endian and row-major. A
sharded checkpoint has an index, ``model.safetensors.index.json``, whose
``weight_map`` names each tensor's file.

F32, F16 and BF16 are read (BF16, which numpy lacks, widened to f32
exactly through a ``uint16`` view and torch). The writer, for the tests
and ``chip_smoke.py``, takes numpy arrays and torch tensors (a bf16
tensor is stored as BF16).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# safetensors dtype -> numpy dtype of its stored bytes
_DTYPES = {'F32': np.float32, 'F16': np.float16, 'BF16': np.uint16}
_NAMES = {np.dtype(np.float32): 'F32', np.dtype(np.float16): 'F16'}


def _widen_bf16(raw: np.ndarray) -> np.ndarray:
    """BF16 bits in a ``uint16`` array -> the same values in f32."""
    bits = torch.from_numpy(raw.astype(np.int16, copy=False))
    return bits.view(torch.bfloat16).float().numpy()


def read_header(path: str) -> dict:
    """The JSON header of a safetensors file (``__metadata__`` included)."""
    with open(path, 'rb') as f:
        (size,) = struct.unpack('<Q', f.read(8))
        return json.loads(f.read(size))


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file as a numpy array (BF16 as f32)."""
    with open(path, 'rb') as f:
        (size,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(size))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        kind = info['dtype']
        if kind not in _DTYPES:
            raise ValueError(f'{path}: tensor {name!r} has dtype {kind}, which '
                             f'this reader does not take ({sorted(_DTYPES)})')
        begin, end = info['data_offsets']
        dtype = np.dtype(_DTYPES[kind]).newbyteorder('<')
        array = np.frombuffer(data, dtype, (end - begin) // dtype.itemsize,
                              begin).reshape(info['shape'])
        out[name] = (_widen_bf16(array) if kind == 'BF16'
                     else array.astype(dtype.newbyteorder('='), copy=True))
    return out


def load_sharded(index_path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a sharded checkpoint by its index
    (``model.safetensors.index.json``)."""
    with open(index_path) as f:
        weight_map = json.load(f)['weight_map']
    root = os.path.dirname(index_path)
    out = {}
    for shard in sorted(set(weight_map.values())):
        tensors = load_file(os.path.join(root, shard))
        out.update({k: v for k, v in tensors.items()
                    if weight_map.get(k) == shard})
    missing = sorted(set(weight_map) - set(out))
    if missing:
        raise ValueError(f'{index_path}: tensors missing from their shards: '
                         f'{missing[:5]}')
    return out


def load_torch_bin(path: str) -> Dict[str, np.ndarray]:
    """A ``pytorch_model.bin`` state dict (``torch.load`` with
    ``weights_only=True``: tensors only, no code) as numpy arrays, bf16
    widened to f32."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in state.items() if isinstance(v, torch.Tensor)}


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Writes ``tensors`` (numpy arrays or torch tensors) as one
    safetensors file, in name order, through a temporary file renamed when
    complete."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        value = tensors[name]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            if value.dtype == torch.bfloat16:
                kind, raw = 'BF16', value.view(torch.int16).numpy()
            else:
                raw = value.numpy()
                kind = _NAMES.get(raw.dtype)
        else:
            raw = np.asarray(value)
            kind = _NAMES.get(raw.dtype)
        if kind is None:
            raise ValueError(f'{name}: dtype {raw.dtype} is not one this '
                             f'writer takes (f32, f16, bf16)')
        blob = np.ascontiguousarray(raw).astype(raw.dtype.newbyteorder('<'),
                                                copy=False).tobytes()
        header[name] = {'dtype': kind, 'shape': list(raw.shape),
                        'data_offsets': [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    if metadata:
        header['__metadata__'] = dict(metadata)
    text = json.dumps(header, separators=(',', ':')).encode()
    text += b' ' * (-len(text) % 8)         # the data starts 8-aligned
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
        f.write(struct.pack('<Q', len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)


def save_sharded(tensors: Mapping[str, object], directory: str,
                 shards: int) -> str:
    """Writes ``tensors`` over ``shards`` files ``model-0000i-of-0000n.
    safetensors`` in ``directory`` and their index ``model.safetensors.
    index.json`` (as transformers' ``save_pretrained`` shards); returns the
    index's path."""
    names = sorted(tensors)
    weight_map = {}
    for i in range(shards):
        shard = f'model-{i + 1:05d}-of-{shards:05d}.safetensors'
        part = names[i::shards]
        save_file({k: tensors[k] for k in part},
                  os.path.join(directory, shard))
        weight_map.update({k: shard for k in part})
    index = os.path.join(directory, 'model.safetensors.index.json')
    with open(index, 'w') as f:
        json.dump({'metadata': {}, 'weight_map': weight_map}, f, indent=1)
    return index
