"""sav_tpu_torch: the PyTorch/CUDA port of sav_tpu for NVIDIA Hopper.

The ViT, CaiT, MLP-Mixer, TNT, BoTNet, CeiT and CvT families (``models``),
served by ``python -m sav_tpu_torch.predict`` and trained by ``python -m
sav_tpu_torch.train`` on one card, with every TPU kernel on their paths
ported to hand-written CUDA (``csrc/``, wrapped in ``ops``; ROADMAP.md
lists the slices and what is still to come). Imports torch, numpy and the
standard library only; never JAX or sav_tpu.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise.

    ``None`` means ``'cuda'``; with no card that raises instead of falling
    back to the CPU. Pass ``'cpu'`` explicitly to run there.
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" (CLI: '
            '--device cpu) to run on the CPU')
    return device
