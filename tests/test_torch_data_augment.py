"""Torch port, the whole train augmentation (``data/pipeline.py``) against
``sav_tpu.data.pipeline.make_train_augment_fn``, on the draws JAX's key
tree took (``torch_parity.jax_augment_draws``), for the CLI default, the
bare ``randaugment`` token (gaussian levels with magstd, layer
probability), mixup with colour jitter, and ``'none'``; and
``AugmentedArrayDataset``.

Tolerances: labels, ``mix_labels`` and ``ratio`` exact. Images are
compared after ``normalize`` on the 0-255 scale (times 255 * std), every
value within 255:
- JAX run as a Python function (each op and ``lax.switch`` compiled on
  its own): at least 99.9% of the values within 2e-3, the crop's
  tolerance (``test_torch_data_ops.py``); RandAugment's thresholds and
  truncations turn a difference that small into a step at the few values
  on a boundary (seen over 12 seeds: 99.966% at the worst).
- JAX jitted, as the package runs it: XLA also contracts the warps'
  coordinate arithmetic into multiply-adds, so a nearest warp takes the
  neighbouring pixel at a few half-pixel boundaries, and a later Equalize
  turns one moved pixel into a one-step shift of its LUT over whole value
  ranges: at least 90% of the values within 2e-3 and a mean difference
  of at most 0.25 (seen over 12 seeds: 93.7% and 0.107 at the worst, for
  the CLI default; 99.98% and 2e-4 for the others).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.data import pipeline as jpipe
from sav_tpu_torch.data import pipeline as tpipe
from sav_tpu_torch.data import randaugment as tra
from torch_parity import jax_augment_draws

torch.set_num_threads(1)

B, FRAME, SIZE = 8, 48, 40
SCALE = 255.0 * np.asarray((0.232, 0.228, 0.229), np.float32)  # 1/normalize
NAMES = ['cutmix_mixup_randaugment_405', 'randaugment',
         'mixup_0.5_colorjitter_0.4', 'none']


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (B, FRAME, FRAME, 3)).astype(np.uint8),
            rng.randint(0, 10, B).astype(np.int32))


def assert_images_close(got, want, share, mean=2e-3, tol=2e-3):
    diff = np.abs(got - want) * SCALE
    assert np.isfinite(got).all()
    assert np.mean(diff <= tol) >= share, (np.mean(diff <= tol), diff.max())
    assert diff.mean() <= mean, diff.mean()
    assert diff.max() <= 255.0


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'jit'])
@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('name', NAMES)
def test_apply_matches_jax_on_its_draws(name, seed, jit):
    images, labels = _batch(seed)
    key = jax.random.PRNGKey(seed)
    augment = jpipe.make_train_augment_fn(SIZE,
                                          jpipe.parse_augment_name(name))
    want = (jax.jit(augment) if jit else augment)(
        key, jnp.asarray(images), jnp.asarray(labels))
    draws = jax_augment_draws(key, B, FRAME, name, SIZE)
    got = tpipe.apply(torch.from_numpy(images),
                      torch.from_numpy(labels).long(), draws,
                      tpipe.parse_augment_name(name), SIZE)
    assert set(got) == set(want)
    assert got['images'].shape == (B, SIZE, SIZE, 3)
    assert_images_close(got['images'].numpy(), np.asarray(want['images']),
                        **(dict(share=0.9, mean=0.25) if jit
                           else dict(share=0.999)))
    for k in set(want) - {'images'}:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_randaugment_groups_like_one_example_at_a_time():
    """Grouping the batch by drawn op gives each example what running it
    alone gives (every op of the table drawn at least once)."""
    ra = tra.RandAugment(num_layers=2, magnitude=7.0, magstd=0.5,
                         prob_to_apply=0.7, cutout=True, size=SIZE)
    gen = torch.Generator().manual_seed(5)
    n = 48
    images = torch.rand(n, SIZE, SIZE, 3, generator=gen) * 255
    draws = ra.draw(gen, n)
    assert set(draws['op'].flatten().tolist()) == set(range(16))
    batched = ra.apply(images, draws)
    for i in range(0, n, 7):
        one = {k: v[..., i:i + 1] for k, v in draws.items()}
        np.testing.assert_array_equal(
            ra.apply(images[i:i + 1], one).numpy(), batched[i:i + 1].numpy())


def test_op_table_is_jax_order():
    from sav_tpu.data.randaugment import _op_table
    assert tra.OP_NAMES == tuple(name for name, _ in _op_table(224))
    for size in (224, 128, 96, 32, 40, 384):
        from sav_tpu.data.randaugment import translate_const
        assert tra.translate_const(size) == translate_const(size)


def test_make_train_augment_fn_is_draw_then_apply():
    images, labels = _batch(3)
    config = tpipe.parse_augment_name('cutmix_mixup_randaugment_405')
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    got = tpipe.make_train_augment_fn(SIZE, config)(
        tpipe.step_generator(7, 2), x, y)
    draws = tpipe.draw(tpipe.step_generator(7, 2), B, FRAME, config, SIZE)
    want = tpipe.apply(x, y, draws, config, SIZE)
    for k in want:
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
def test_augmented_array_dataset(training):
    """Eval walks the split once with a masked tail and its batches equal
    the JAX dataset's; training is deterministic per (seed, step) and
    draws from the split only."""
    rng = np.random.RandomState(0)
    n = 37
    images = rng.randint(0, 256, (n, FRAME, FRAME, 3)).astype(np.uint8)
    labels = np.arange(n)
    split = ('holdout', 0.0, 0.8)
    kwargs = dict(batch_size=8, image_size=SIZE, training=training, seed=3,
                  split=split, augmentation='cutmix_mixup_randaugment_405')
    port = tpipe.AugmentedArrayDataset(images, labels, **kwargs)
    held = set(tpipe.split_indices(n, 0.0, 0.8).tolist())
    if training:
        a, b = port.batch(4), port.batch(4)
        for k in a:
            assert torch.equal(a[k], b[k])
        assert set(a['labels'].tolist()) <= held
        assert not torch.equal(a['images'], port.batch(5)['images'])
        return
    jax_data = jpipe.AugmentedArrayDataset(images, labels, **kwargs)
    assert port.num_batches == jax_data.num_batches == 4
    for step in range(port.num_batches):
        got, want = port.batch(step), jax_data.batch(step)
        np.testing.assert_array_equal(got['labels'].numpy(),
                                      np.asarray(want['labels']))
        np.testing.assert_array_equal(got['mask'].numpy(),
                                      np.asarray(want['mask']))
        np.testing.assert_allclose(got['images'].numpy(),
                                   np.asarray(want['images']), rtol=0,
                                   atol=1e-4)
    assert float(port.batch(3)['mask'].sum()) == 30 - 24
    with pytest.raises(StopIteration):
        port.batch(4)
