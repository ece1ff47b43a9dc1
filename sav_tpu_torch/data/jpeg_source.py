"""Host JPEG decode to a fixed-shape uint8 frame (counterpart of
``sav_tpu/data/jpeg_source.py``, PIL tier only).

The host does only the decode and the keep-aspect resize-small + center
crop to ``decode_size``; the eval transform runs batched on the device
(``sav_tpu_torch.data.preprocess``). PIL is imported where a JPEG is
decoded, so the package imports without it.
"""

from __future__ import annotations

import numpy as np


def decode_jpeg_fixed(path_or_file, decode_size: int) -> np.ndarray:
    """Decodes a JPEG to a ``[decode_size, decode_size, 3]`` uint8 frame.

    ``Image.draft`` lets libjpeg decode at 1/2, 1/4 or 1/8 DCT scale when
    the stored photo is much larger than the target.
    """
    from PIL import Image

    with Image.open(path_or_file) as img:
        # draft may overshoot (it only does power-of-two scales); ask for 2x
        # the target so the bilinear resize below still has headroom.
        img.draft('RGB', (decode_size * 2, decode_size * 2))
        return _resize_center_crop(img.convert('RGB'), decode_size)


def _resize_center_crop(img, decode_size: int) -> np.ndarray:
    """Keep-aspect resize-small + center crop of a PIL image -> uint8."""
    from PIL import Image

    width, height = img.size
    scale = decode_size / min(width, height)
    new_w = max(decode_size, int(round(width * scale)))
    new_h = max(decode_size, int(round(height * scale)))
    img = img.resize((new_w, new_h), Image.BILINEAR)
    x0 = (new_w - decode_size) // 2
    y0 = (new_h - decode_size) // 2
    img = img.crop((x0, y0, x0 + decode_size, y0 + decode_size))
    return np.asarray(img, dtype=np.uint8)
