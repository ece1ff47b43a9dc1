"""Random-access JPEG sources for the host loader (counterpart of
``sav_tpu/data/jpeg_source.py``).

The host does only the decode to a fixed ``[S, S, 3]`` uint8 frame
(keep-aspect resize-small + center crop, DCT-domain draft scaling so large
photos never decode at full resolution); every random transform runs
batched on the device (``sav_tpu_torch.data.pipeline``). The decode goes
to the native libjpeg tier (``sav_tpu_torch.native``) and to PIL where the
native tier declines; ``decode_jpeg_tier`` says which served, and the
sources put it in every record (``'native'``: 1 or 0) for the loader to
count. PIL is imported where a JPEG is decoded, so the package imports
without it.

Layout: ImageFolder, ``root/<class_name>/*.jpg``, class indices in sorted
class-directory order; or tar archives of ``<class>/<file>.jpg``.
"""

from __future__ import annotations

import io
import os
from typing import Sequence, Tuple

import numpy as np


def _list_jpegs(root: str) -> Tuple[Sequence[str], Sequence[int],
                                    Sequence[str]]:
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f'no class directories under {root!r}')
    paths, labels = [], []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(('.jpg', '.jpeg')):
                paths.append(os.path.join(cdir, fname))
                labels.append(idx)
    if not paths:
        raise FileNotFoundError(f'no .jpg/.jpeg files under {root!r}')
    return paths, labels, classes


def decode_jpeg_tier(path_or_file, decode_size: int, *,
                     allow_native: bool = True):
    """``(frame, tier)``: the ``[decode_size, decode_size, 3]`` uint8 frame
    and ``'native'`` or ``'pil'``, the tier that decoded it.

    Keep-aspect resize-small to ``decode_size`` then center crop, the
    geometry of the reference's eval transform (preprocess.py:26-58). The
    native tier handles the common case; PIL takes what it declines (CMYK,
    corrupt streams, no toolchain; ``SAV_TPU_NO_NATIVE=1`` turns it off).
    """
    from PIL import Image

    if allow_native:
        from sav_tpu_torch import native

        if isinstance(path_or_file, (str, os.PathLike)):
            with open(path_or_file, 'rb') as f:
                data = f.read()
        else:
            data = path_or_file.read()
        frame = native.decode_jpeg_fixed_native(data, decode_size)
        if frame is not None:
            return frame, 'native'
        path_or_file = io.BytesIO(data)   # rewound copy for PIL

    with Image.open(path_or_file) as img:
        # draft may overshoot (it only does power-of-two scales); ask for 2x
        # the target so the bilinear resize below still has headroom.
        img.draft('RGB', (decode_size * 2, decode_size * 2))
        return _resize_center_crop(img.convert('RGB'), decode_size), 'pil'


def decode_jpeg_fixed(path_or_file, decode_size: int, *,
                      allow_native: bool = True) -> np.ndarray:
    """The frame of ``decode_jpeg_tier``."""
    return decode_jpeg_tier(path_or_file, decode_size,
                            allow_native=allow_native)[0]


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


def resize_center_crop_array(array: np.ndarray,
                             decode_size: int) -> np.ndarray:
    """The same geometry for an already-decoded uint8 array. Grayscale
    ``(H, W)`` / ``(H, W, 1)`` and RGBA records become RGB, so the frame is
    always ``[decode_size, decode_size, 3]``."""
    from PIL import Image

    array = np.asarray(array)
    if array.ndim == 3 and array.shape[-1] == 1:
        array = array[..., 0]       # PIL wants 2-D for grayscale
    if (array.ndim == 3 and array.shape[-1] == 3
            and array.shape[:2] == (decode_size, decode_size)):
        return np.asarray(array, dtype=np.uint8)
    return _resize_center_crop(Image.fromarray(array).convert('RGB'),
                               decode_size)


def _record(frame_tier, label):
    frame, tier = frame_tier
    return {'image': frame, 'label': np.int64(label),
            'native': np.int64(tier == 'native')}


def _build_native() -> None:
    """Builds the native tier here, in the process that makes the source,
    so the loader's workers find it built."""
    from sav_tpu_torch import native
    native.available()


class JpegFolderSource:
    """Random-access source over ``root/<class>/*.jpg`` trees; records are
    ``{'image': uint8 [S, S, 3], 'label': int64, 'native': 0 or 1}``,
    decoded in the calling process (a loader worker)."""

    def __init__(self, root: str, decode_size: int = 256):
        self._root = os.path.abspath(root)
        self._decode_size = int(decode_size)
        self._paths, self._labels, self.class_names = _list_jpegs(self._root)
        _build_native()

    def __repr__(self) -> str:
        return (f'JpegFolderSource({self._root!r}, n={len(self)}, '
                f'decode={self._decode_size})')

    def __len__(self) -> int:
        return len(self._paths)

    def __getitem__(self, index: int):
        return _record(decode_jpeg_tier(self._paths[index],
                                        self._decode_size),
                       self._labels[index])


class JpegTarSource:
    """Random-access source over tar archives of ``<class>/<file>.jpg``
    entries (the ImageNet-21k-P layout).

    A one-time member index per tar keeps access O(1) a record. Reads use
    ``os.pread`` (offset and read in one call), so threads sharing the
    source cannot interleave a seek and a read. Flat archives without class
    directories are refused up front: their labels would mean nothing. The
    source pickles (file descriptors are reopened in each process).
    """

    def __init__(self, tar_paths: Sequence[str], decode_size: int = 256):
        import tarfile

        if isinstance(tar_paths, str):
            tar_paths = [tar_paths]
        self._tar_paths = [os.path.abspath(p) for p in sorted(tar_paths)]
        self._decode_size = int(decode_size)
        class_names = set()
        per_tar_members = []
        for path in self._tar_paths:
            members = []
            with tarfile.open(path) as tar:
                for member in tar:
                    if not member.isfile():
                        continue
                    if not member.name.lower().endswith(('.jpg', '.jpeg')):
                        continue
                    # normalize `tar -C root .`-style ./ prefixes
                    name = member.name
                    while name.startswith('./'):
                        name = name[2:]
                    if '/' not in name:
                        raise ValueError(
                            f'{path!r}: entry {member.name!r} has no class '
                            f'directory; JpegTarSource derives labels from '
                            f'<class>/<file>.jpg paths')
                    cls = name.split('/')[0]
                    class_names.add(cls)
                    members.append((member.offset_data, member.size, cls))
            per_tar_members.append(members)
        self.class_names = sorted(class_names)
        cls_to_idx = {c: i for i, c in enumerate(self.class_names)}
        entries = []
        for tar_idx, members in enumerate(per_tar_members):
            for offset, size, cls in members:
                entries.append((tar_idx, offset, size, cls_to_idx[cls]))
        if not entries:
            raise FileNotFoundError(f'no jpegs in tars {self._tar_paths!r}')
        self._entries = entries
        self._fds = [None] * len(self._tar_paths)
        _build_native()

    def __repr__(self) -> str:
        return (f'JpegTarSource({self._tar_paths!r}, n={len(self)}, '
                f'decode={self._decode_size})')

    def __len__(self) -> int:
        return len(self._entries)

    def _fd(self, tar_idx: int) -> int:
        fd = self._fds[tar_idx]
        if fd is None:
            # two threads may both open; reads are positioned either way
            fd = os.open(self._tar_paths[tar_idx], os.O_RDONLY)
            self._fds[tar_idx] = fd
        return fd

    def __getitem__(self, index: int):
        tar_idx, offset, size, label = self._entries[index]
        payload = io.BytesIO(os.pread(self._fd(tar_idx), size, offset))
        return _record(decode_jpeg_tier(payload, self._decode_size), label)

    def close(self) -> None:
        """Closes the descriptors this process opened."""
        for i, fd in enumerate(self._fds):
            if fd is not None:
                os.close(fd)
                self._fds[i] = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state['_fds'] = [None] * len(self._tar_paths)  # fds don't pickle
        return state


def looks_like_jpeg_folder(path: str) -> bool:
    """True if ``path`` is an ImageFolder-style tree of JPEGs."""
    if not os.path.isdir(path):
        return False
    for entry in sorted(os.listdir(path)):
        sub = os.path.join(path, entry)
        if os.path.isdir(sub):
            for fname in os.listdir(sub):
                if fname.lower().endswith(('.jpg', '.jpeg')):
                    return True
    return False
