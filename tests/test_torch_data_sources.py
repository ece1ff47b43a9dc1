"""Torch port, the host side of the input pipeline: the JPEG, tar and npz
sources against the JAX package's (``sav_tpu/data/jpeg_source.py``,
``grain_loader.py``) frame for frame, the native decode tier against PIL,
the split indices, and ``HostDataset`` (``data/loader.py``) against
``GrainDataset``'s eval batches, with its determinism by step.

Tolerances: frames, labels, split indices and masks exact (the same
decoder sources, the same permutation). The native tier against PIL: the
bounds ``tests/test_native.py`` holds the JAX package's tier to (mean
difference < 2, 95th percentile <= 16: another resampling filter). Eval
batches: 1e-4 after ``normalize`` (the eval crop's weights, built on the
host in float32 by both packages, applied in another order).
"""

import io
import os
import sys
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from sav_tpu.data import grain_loader as jloader
from sav_tpu.data import jpeg_source as jjpeg
from sav_tpu_torch import native
from sav_tpu_torch.data import jpeg_source as tjpeg
from sav_tpu_torch.data import loader as tloader
from sav_tpu_torch.data import pipeline as tpipe

torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
from make_jpeg_dataset import synth_image  # noqa: E402

CLASSES, PER_CLASS, DECODE = 3, 5, 36


@pytest.fixture(scope='module')
def jpeg_tree(tmp_path_factory):
    """An ImageFolder tree of ``make_jpeg_dataset.synth_image`` JPEGs at
    varied sizes (one grayscale, one CMYK) and a tar of it."""
    root = tmp_path_factory.mktemp('jpegs')
    rng = np.random.RandomState(0)
    for cls in range(CLASSES):
        cdir = root / f'class_{cls:04d}'
        cdir.mkdir()
        for i in range(PER_CLASS):
            h, w = rng.randint(40, 90, 2)
            img = Image.fromarray(synth_image(rng, cls, CLASSES, h, w))
            if (cls, i) == (1, 2):
                img = img.convert('L')
            if (cls, i) == (2, 3):
                img = img.convert('CMYK')
            img.save(cdir / f'img_{i:05d}.jpg', quality=85)
    tar_path = root.parent / 'shards.tar'
    with tarfile.open(tar_path, 'w') as tar:
        for cls in range(CLASSES):
            cname = f'class_{cls:04d}'
            for fname in sorted(os.listdir(root / cname)):
                tar.add(root / cname / fname, arcname=f'{cname}/{fname}')
    return str(root), str(tar_path)


def _records_equal(port, jax_source):
    assert len(port) == len(jax_source) == CLASSES * PER_CLASS
    tiers = []
    for i in range(len(port)):
        got, want = port[i], jax_source[i]
        np.testing.assert_array_equal(got['image'], want['image'])
        assert got['image'].dtype == np.uint8
        assert got['label'] == want['label']
        tiers.append(int(got['native']))
    return tiers


def test_jpeg_folder_source_matches_jax(jpeg_tree):
    root, _ = jpeg_tree
    port = tjpeg.JpegFolderSource(root, decode_size=DECODE)
    tiers = _records_equal(port, jjpeg.JpegFolderSource(root, DECODE))
    assert port.class_names == [f'class_{c:04d}' for c in range(CLASSES)]
    # the CMYK stream is declined to PIL and says so; with no native tier
    # every record says PIL
    native_records = len(tiers) - 1 if native.available() else 0
    assert sum(tiers) == native_records


def test_jpeg_tar_source_matches_jax_and_pickles(jpeg_tree):
    import pickle
    _, tar_path = jpeg_tree
    port = tjpeg.JpegTarSource([tar_path], decode_size=DECODE)
    _records_equal(port, jjpeg.JpegTarSource([tar_path], DECODE))
    clone = pickle.loads(pickle.dumps(port))
    np.testing.assert_array_equal(clone[4]['image'], port[4]['image'])
    port.close()


def test_jpeg_tar_source_refuses_flat_archives(tmp_path):
    path = tmp_path / 'flat.tar'
    buf = io.BytesIO()
    Image.new('RGB', (8, 8)).save(buf, 'JPEG')
    with tarfile.open(path, 'w') as tar:
        info = tarfile.TarInfo('a.jpg')
        info.size = len(buf.getvalue())
        tar.addfile(info, io.BytesIO(buf.getvalue()))
    with pytest.raises(ValueError, match='class directory'):
        tjpeg.JpegTarSource([str(path)])


def test_looks_like_jpeg_folder(jpeg_tree, tmp_path):
    root, tar_path = jpeg_tree
    assert tjpeg.looks_like_jpeg_folder(root)
    assert not tjpeg.looks_like_jpeg_folder(str(tmp_path))
    assert not tjpeg.looks_like_jpeg_folder(tar_path)


def _jpeg_bytes(h=96, w=128, mode='RGB'):
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([(xx * 255 // w), (yy * 255 // h), (xx + yy) % 256],
                   axis=-1).astype(np.uint8)
    img = Image.fromarray(arr)
    if mode != 'RGB':
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, 'JPEG', quality=92)
    return buf.getvalue()


@pytest.fixture
def native_tier():
    """Skips where the native tier cannot be built here (decided in the
    test, not while the module is imported)."""
    if not native.available():
        pytest.skip(f'native decoder unavailable: {native.status()}')


@pytest.mark.usefixtures('native_tier')
def test_native_tier_matches_pil_and_the_jax_tier():
    from sav_tpu import native as jnative
    data = _jpeg_bytes(300, 460)
    nat = native.decode_jpeg_fixed_native(data, 64)
    pil, tier = tjpeg.decode_jpeg_tier(io.BytesIO(data), 64,
                                       allow_native=False)
    assert tier == 'pil' and nat.shape == pil.shape == (64, 64, 3)
    diff = np.abs(nat.astype(np.int16) - pil.astype(np.int16))
    assert diff.mean() < 2.0 and np.percentile(diff, 95) <= 16
    np.testing.assert_array_equal(nat,
                                  jnative.decode_jpeg_fixed_native(data, 64))
    frame, tier = tjpeg.decode_jpeg_tier(io.BytesIO(data), 64)
    assert tier == 'native'
    np.testing.assert_array_equal(frame, nat)
    assert native.lib_path().startswith(native.BUILD_DIR)
    assert native.status() == 'native'


@pytest.mark.usefixtures('native_tier')
@pytest.mark.parametrize('kind', ['cmyk', 'corrupt'])
def test_native_tier_declines_to_pil(kind):
    data = _jpeg_bytes(mode='CMYK') if kind == 'cmyk' else _jpeg_bytes()[:40]
    assert native.decode_jpeg_fixed_native(data, 32) is None
    if kind == 'cmyk':
        frame, tier = tjpeg.decode_jpeg_tier(io.BytesIO(data), 32)
        assert tier == 'pil' and frame.shape == (32, 32, 3)
        np.testing.assert_array_equal(
            frame, jjpeg.decode_jpeg_fixed(io.BytesIO(data), 32))
    else:
        with pytest.raises(OSError):
            tjpeg.decode_jpeg_tier(io.BytesIO(data), 32)


@pytest.mark.usefixtures('native_tier')
def test_native_batch_fills_declined_frames_with_pil():
    datas = [_jpeg_bytes(120 + 8 * i, 160) for i in range(3)]
    datas.append(_jpeg_bytes(mode='CMYK'))
    out = native.decode_jpeg_batch_native(datas, 40, nthreads=2)
    for i in range(3):
        np.testing.assert_array_equal(
            out[i], native.decode_jpeg_fixed_native(datas[i], 40))
    np.testing.assert_array_equal(out[3], tjpeg.decode_jpeg_fixed(
        io.BytesIO(datas[3]), 40, allow_native=False))


def test_env_gate_turns_the_native_tier_off(monkeypatch):
    monkeypatch.setenv('SAV_TPU_NO_NATIVE', '1')
    monkeypatch.setattr(native, '_lib', None)
    assert native.decode_jpeg_fixed_native(_jpeg_bytes(), 32) is None
    assert native.status().startswith('pil')
    frame, tier = tjpeg.decode_jpeg_tier(io.BytesIO(_jpeg_bytes()), 32)
    assert tier == 'pil' and frame.shape == (32, 32, 3)


def test_resize_center_crop_array_matches_jax():
    rng = np.random.RandomState(1)
    for shape in [(50, 70, 3), (60, 40), (45, 45, 1), (30, 30, 4),
                  (36, 36, 3)]:
        arr = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(
            tjpeg.resize_center_crop_array(arr, 36),
            jjpeg.resize_center_crop_array(arr, 36))


@pytest.fixture(scope='module')
def npz_shards(tmp_path_factory):
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (23, 20, 20, 3)).astype(np.uint8)
    labels = rng.randint(0, 5, 23)
    directory = str(tmp_path_factory.mktemp('shards'))
    tloader.write_npz_shards(images, labels, directory, shard_size=10)
    return directory, images, labels


def test_npz_shard_source_matches_jax(npz_shards):
    directory, images, labels = npz_shards
    pattern = os.path.join(directory, '*.npz')
    port, want = tloader.NpzShardSource(pattern), jloader.NpzShardSource(
        pattern)
    assert len(port) == len(want) == 23
    assert sorted(os.listdir(directory)) == [
        'shard-00000.npz', 'shard-00001.npz', 'shard-00002.npz']
    for i in range(23):
        np.testing.assert_array_equal(port[i]['image'], want[i]['image'])
        np.testing.assert_array_equal(port[i]['image'], images[i])
        assert port[i]['label'] == want[i]['label'] == labels[i]


@pytest.mark.parametrize('n', [7, 100, 641])
@pytest.mark.parametrize('lo,hi', [(0.0, 0.9), (0.9, 1.0), (0.0, 0.95),
                                   (0.95, 1.0), (0.05, 0.15)])
def test_subset_indices_match_jax(n, lo, hi):
    """The same example indices as ``sav_tpu``'s SubsetSource (and the
    holdout split of its AugmentedArrayDataset)."""
    class Source:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return i

    if int(round(hi * n)) <= int(round(lo * n)):
        with pytest.raises(ValueError):
            tloader.SubsetSource(Source(), lo, hi)
        return
    port = tloader.SubsetSource(Source(), lo, hi)
    want = jloader.SubsetSource(Source(), lo, hi)
    assert len(port) == len(want)
    assert [port[i] for i in range(len(port))] == [
        want[i] for i in range(len(want))]
    np.testing.assert_array_equal(port.indices(), want._indices())


def test_train_and_holdout_are_disjoint():
    n = 641
    train = set(tpipe.split_indices(n, 0.0, 0.95).tolist())
    held = set(tpipe.split_indices(n, 0.95, 1.0).tolist())
    assert not train & held and train | held == set(range(n))
    assert len(held) == 32


def _host(source, training, workers=0, batch=4, seed=0,
          augmentation='cutmix_mixup_randaugment_405'):
    return tloader.HostDataset(source, batch, 32, augmentation=augmentation,
                               training=training, seed=seed,
                               num_workers=workers)


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_host_dataset_is_a_function_of_seed_and_step(jpeg_tree):
    """Forward skip gives the fresh stream's batch, a backward seek replays
    it, and a differently seeded stream differs."""
    root, _ = jpeg_tree
    source = tjpeg.JpegFolderSource(root, decode_size=DECODE)
    walked = _host(source, True)
    stream = [walked.batch(s) for s in range(5)]
    skipped = _host(source, True)
    _assert_batches_equal(skipped.batch(4), stream[4])   # epoch 2 (15 / 4)
    _assert_batches_equal(skipped.batch(1), stream[1])   # backward
    assert not torch.equal(_host(source, True, seed=1).batch(1)['images'],
                           stream[1]['images'])
    assert walked.num_batches == 3
    assert walked.stats['batches'] == 5 and walked.stats['decoded'] == 20


def test_host_dataset_workers_give_the_same_batches(jpeg_tree):
    _, tar_path = jpeg_tree
    source = tjpeg.JpegTarSource([tar_path], decode_size=DECODE)
    inline, pooled = _host(source, True), _host(source, True, workers=2)
    try:
        for step in (0, 1, 3):
            _assert_batches_equal(pooled.batch(step), inline.batch(step))
        assert pooled.stats['decode_s'] > 0
    finally:
        pooled.close()


def test_host_eval_matches_grain_eval_with_a_masked_tail(npz_shards):
    """Eval walks the holdout once in order: the JAX GrainDataset's batches,
    the last one zero-padded with mask 0, then StopIteration."""
    directory, _, _ = npz_shards
    pattern = os.path.join(directory, '*.npz')
    port = _host(tloader.SubsetSource(tloader.NpzShardSource(pattern), 0.5,
                                      1.0), training=False)
    want = jloader.GrainDataset(
        jloader.SubsetSource(jloader.NpzShardSource(pattern), 0.5, 1.0), 4,
        32, training=False)
    assert port.num_batches == want.num_batches == 3          # 12 held out
    for step in range(3):
        got, ref = port.batch(step), want.batch(step)
        np.testing.assert_array_equal(got['labels'].numpy(),
                                      np.asarray(ref['labels']))
        np.testing.assert_array_equal(got['mask'].numpy(),
                                      np.asarray(ref['mask']))
        np.testing.assert_allclose(got['images'].numpy(),
                                   np.asarray(ref['images']), rtol=0,
                                   atol=1e-4)
    tail = _host(tloader.SubsetSource(tloader.NpzShardSource(pattern), 0.6,
                                      1.0), training=False)
    assert tail.num_batches == 3                                # 9 held out
    assert tail.batch(2)['mask'].tolist() == [1.0, 0.0, 0.0, 0.0]
    with pytest.raises(StopIteration):
        tail.batch(3)


@pytest.mark.parametrize('name', ['tar', 'folder', 'shards', 'npz'])
def test_create_dataset_routes(name, jpeg_tree, npz_shards, tmp_path):
    root, tar_path = jpeg_tree
    directory, images, labels = npz_shards
    npz = str(tmp_path / 'a.npz')
    np.savez(npz, images=images, labels=labels)
    path = {'tar': tar_path, 'folder': root, 'shards': directory,
            'npz': npz}[name]
    data = tpipe.create_dataset(path + '?split=train[:80%]', 4, 32,
                                augmentation='randaugment')
    kind = (tpipe.AugmentedArrayDataset if name == 'npz'
            else tloader.HostDataset)
    assert isinstance(data, kind)
    batch = data.batch(0)
    assert batch['images'].shape == (4, 32, 32, 3)
    assert torch.isfinite(batch['images']).all()


def test_create_dataset_refusals(tmp_path):
    with pytest.raises(ValueError, match='neither'):
        tpipe.create_dataset(str(tmp_path), 4, 32)
    with pytest.raises(ValueError, match='infinite'):
        tpipe.create_dataset('synthetic?split=train[:50%]', 4, 32)
    with pytest.raises(ImportError, match='tensorflow_datasets'):
        tpipe.create_dataset('tfds:imagenet2012', 4, 32)
    with pytest.raises(ValueError, match='Unknown dataset'):
        tpipe.create_dataset('/no/such/source', 4, 32)


def test_imagenet21k_shards_match_jax(jpeg_tree, tmp_path):
    """The tar -> .npz converter writes the JAX package's shards (the same
    224 px frames and labels) and the constants agree."""
    from sav_tpu.data import imagenet21k as j21k
    from sav_tpu_torch.data import imagenet21k as t21k
    _, tar_path = jpeg_tree
    names = [name for name, _ in t21k.iter_tar_images(tar_path)]
    assert names == [name for name, _ in j21k.iter_tar_images(tar_path)]
    got = t21k.prepare_npz_shards(tar_path, str(tmp_path / 'port'),
                                  shard_size=6)
    want = j21k.prepare_npz_shards(tar_path, str(tmp_path / 'jax'),
                                   shard_size=6)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with np.load(a) as x, np.load(b) as y:
            np.testing.assert_array_equal(x['images'], y['images'])
            np.testing.assert_array_equal(x['labels'], y['labels'])
    for name in ('NUM_CLASSES', 'TRAIN_IMAGES', 'VALIDATION_IMAGES',
                 'IMAGE_SIZE'):
        assert getattr(t21k, name) == getattr(j21k, name)
