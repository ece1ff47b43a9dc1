"""ImageNet-21k-P (winter release) constants and the tar -> ``.npz`` shard
converter (counterpart of ``sav_tpu/data/imagenet21k.py``).

The processed winter-21 release has 10,450 classes, 11,060,223 train and
522,500 validation images, stored as 224x224 JPEGs in per-split tars
(reference: data/custom_datasets/imagenet_21k_p_winter.py:26-100).
``prepare_npz_shards`` decodes a tar once, offline, into shards that
``loader.NpzShardSource`` reads; ``jpeg_source.JpegTarSource`` reads the
tars directly. The TFDS builder of the JAX package needs
``tensorflow_datasets`` and is not ported (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import io
import os
import tarfile

import numpy as np

NUM_CLASSES = 10_450
TRAIN_IMAGES = 11_060_223
VALIDATION_IMAGES = 522_500
IMAGE_SIZE = 224


def iter_tar_images(archive_path: str):
    """Streams (member_name, fileobj) for every jpeg in a tar archive."""
    with tarfile.open(archive_path) as archive:
        for member in archive:
            if not member.isfile():
                continue
            if not member.name.lower().endswith(('.jpg', '.jpeg')):
                continue
            yield member.name, archive.extractfile(member)


def prepare_npz_shards(archive_path: str, out_dir: str,
                       shard_size: int = 10_000,
                       class_names=None) -> list:
    """Converts a winter-21 tar into ``.npz`` shards of ``shard_size``
    224x224 uint8 images and int64 labels (the class directory's index in
    ``class_names``, else in order of first appearance); returns the shard
    paths."""
    from PIL import Image

    label_of = {}
    images, labels, paths = [], [], []
    os.makedirs(out_dir, exist_ok=True)

    def flush():
        if not images:
            return
        path = os.path.join(out_dir, f'shard-{len(paths):05d}.npz')
        np.savez(path, images=np.stack(images),
                 labels=np.asarray(labels, np.int64))
        paths.append(path)
        images.clear()
        labels.clear()

    for name, handle in iter_tar_images(archive_path):
        class_name = name.split('/')[-2]
        if class_names is not None:
            label = class_names.index(class_name)
        else:
            label = label_of.setdefault(class_name, len(label_of))
        with Image.open(io.BytesIO(handle.read())) as img:
            img = img.convert('RGB').resize((IMAGE_SIZE, IMAGE_SIZE))
            images.append(np.asarray(img, np.uint8))
        labels.append(label)
        if len(images) >= shard_size:
            flush()
    flush()
    return paths
