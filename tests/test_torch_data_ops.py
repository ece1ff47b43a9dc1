"""Torch port, the augmentation's ops: every op of ``data/image_ops.py`` and
``data/color.py`` against the JAX function (``sav_tpu/data``) given the
same explicit per-example parameters, the train half of
``data/preprocess.py``, cutout, random erasing, mixup, cutmix and
``mix_augment`` on the draws JAX took, and the grammar of augmentation
names and split specs.

The JAX side runs eagerly (``jax.vmap``, no jit), so each primitive is
its own XLA computation and rounds as IEEE float32 does. Tolerances, on
the 0-255 scale:
- elementwise, integer and warp ops (invert, solarize, solarize_add,
  posterize, grayscale, brightness, contrast, color, autocontrast,
  equalize, rotate, shear, translate, the bilinear affine warp, rgb<->hsv,
  the jitter ops, cutout, erasing, flip, the CIFAR crop, mixup, cutmix):
  bit-equal. Where XLA rounds differently from IEEE float32 the port
  mirrors it: its dot sums luma as fma(b, wb, fma(g, wg, r*wr)), its
  ``jnp.mean`` multiplies by the reciprocal of the count.
- the depthwise convolutions (sharpness, smooth, blur, gaussian blur):
  3e-4, the sums run in another order (seen: 3.1e-5); color jitter's
  contrast about a float32 per-channel mean, 1e-4 (seen: 3.1e-5; on
  integer-valued images the sum is exact and so is the op).
- bilinear resampling (rescale, random_resized_crop): 2e-3.
  ``jax.image.scale_and_translate`` is jitted, and XLA fuses the window
  arithmetic into the weights (the port mirrors the multiply-add it
  contracts in the sample positions); its products then round in float32
  as far as 1.9e-3 from the float64-exact product (seen: port vs JAX
  1.3e-3 at 64 -> 40 px, JAX jitted vs JAX eager 1.9e-3).
Nearest-neighbour warps are bit-equal here; the whole pipeline's test
(``test_torch_data_augment.py``) holds shares of equal pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.data import color as jcolor
from sav_tpu.data import image_ops as jops
from sav_tpu.data import mix as jmix
from sav_tpu.data import pipeline as jpipe
from sav_tpu.data import preprocess as jpre
from sav_tpu_torch.data import color as tcolor
from sav_tpu_torch.data import image_ops as tops
from sav_tpu_torch.data import mix as tmix
from sav_tpu_torch.data import pipeline as tpipe
from sav_tpu_torch.data import preprocess as tpre
from torch_parity import _jax_crop, _jax_erase, _jax_mix

torch.set_num_threads(1)

N, H, W = 6, 40, 48
CONV_TOL = 3e-4
REDUCE_TOL = 1e-4
RESAMPLE_TOL = 2e-3


def _images(seed=0, integer=False, size=(H, W)):
    x = np.random.RandomState(seed).uniform(0, 255, (N,) + size + (3,))
    return (np.floor(x) if integer else x).astype(np.float32)


def _params(seed=1):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return {
        'factor': rng.uniform(0, 2, N).astype(f32),
        'degrees': rng.uniform(-30, 30, N).astype(f32),
        'shear': rng.uniform(-0.3, 0.3, N).astype(f32),
        'pixels': rng.uniform(-15, 15, N).astype(f32),
        'bits': rng.randint(0, 5, N).astype(np.int32),
        'threshold': np.floor(rng.uniform(0, 256, N)).astype(f32),
        'addition': np.floor(rng.uniform(0, 110, N)).astype(f32),
        'level': rng.uniform(0, 1, N).astype(f32),
        'sigma': rng.uniform(0.1, 2.0, N).astype(f32),
        'delta': rng.uniform(-0.2, 0.2, N).astype(f32),
        'low': rng.uniform(0.2, 1.8, N).astype(f32),
    }


# (name, JAX fn of (image, *params), port fn of (images, *params),
#  parameter names, tolerance: 0 = bit-equal)
OPS = [
    ('invert', jops.invert, tops.invert, (), 0),
    ('solarize', jops.solarize, tops.solarize, ('threshold',), 0),
    ('solarize_add', jops.solarize_add, tops.solarize_add, ('addition',), 0),
    ('posterize', jops.posterize, tops.posterize, ('bits',), 0),
    ('grayscale', jops.grayscale, tops.grayscale, (), 0),
    ('brightness', jops.brightness, tops.brightness, ('factor',), 0),
    ('contrast', jops.contrast, tops.contrast, ('factor',), 0),
    ('color', jops.color, tops.color, ('factor',), 0),
    ('sharpness', jops.sharpness, tops.sharpness, ('factor',), CONV_TOL),
    ('smooth', jops.smooth, tops.smooth, ('factor',), CONV_TOL),
    ('blur', jops.blur, tops.blur, ('factor',), CONV_TOL),
    ('autocontrast', jops.autocontrast, tops.autocontrast, (), 0),
    ('equalize', jops.equalize, tops.equalize, (), 0),
    ('rotate', jops.rotate, tops.rotate, ('degrees',), 0),
    ('shear_x', jops.shear_x, tops.shear_x, ('shear',), 0),
    ('shear_y', jops.shear_y, tops.shear_y, ('shear',), 0),
    ('translate_x', jops.translate_x, tops.translate_x, ('pixels',), 0),
    ('translate_y', jops.translate_y, tops.translate_y, ('pixels',), 0),
    ('blend', lambda a, f: jops.blend(a, 255.0 - a, f),
     lambda a, f: tops.blend(a, 255.0 - a, f), ('factor',), 0),
    ('jitter_brightness', lambda im, f: jnp.clip(im * f, 0.0, 255.0),
     tcolor.brightness, ('low',), 0),
    ('jitter_contrast',
     lambda im, f: jnp.clip((im - jnp.mean(im, axis=(0, 1), keepdims=True))
                            * f + jnp.mean(im, axis=(0, 1), keepdims=True),
                            0.0, 255.0),
     tcolor.contrast, ('low',), REDUCE_TOL),
    ('jitter_saturation',
     lambda im, f: jnp.clip(jops.grayscale(im) + (im - jops.grayscale(im))
                            * f, 0.0, 255.0),
     tcolor.saturation, ('low',), 0),
    ('jitter_hue',
     lambda im, d: jnp.clip(jcolor.hsv_to_rgb(jnp.stack([
         (jcolor.rgb_to_hsv(im / 255.0)[..., 0] + d) % 1.0,
         jcolor.rgb_to_hsv(im / 255.0)[..., 1],
         jcolor.rgb_to_hsv(im / 255.0)[..., 2]], -1)) * 255.0, 0.0, 255.0),
     tcolor.hue, ('delta',), 0),
]


def _compare(jfn, tfn, names, tol, images, params):
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(images),
                                    *[jnp.asarray(params[k]) for k in names]))
    got = tfn(torch.from_numpy(images),
              *[torch.from_numpy(params[k]) for k in names]).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize('integer', [False, True], ids=['float', 'integer'])
@pytest.mark.parametrize('name,jfn,tfn,names,tol', OPS,
                         ids=[op[0] for op in OPS])
def test_op_matches_jax(name, jfn, tfn, names, tol, integer):
    """Each op on a batch whose examples carry their own parameters, on
    float images (post-crop) and integer-valued ones (post-posterize)."""
    _compare(jfn, tfn, names, tol, _images(integer=integer), _params())


def test_op_names_match_the_registry():
    assert list(tops.NAME_TO_FUNC) == list(jops.NAME_TO_FUNC)


def test_bilinear_affine_warp_matches_jax():
    p = _params()
    angle = p['degrees'] / 50.0
    matrix = np.stack([np.cos(angle), -np.sin(angle), p['pixels'],
                       np.sin(angle), np.cos(angle), -p['pixels']],
                      1).astype(np.float32)
    images = _images()
    want = np.asarray(jax.vmap(lambda im, m: jops.affine_transform(
        im, m, interpolation='bilinear'))(jnp.asarray(images),
                                          jnp.asarray(matrix)))
    got = tops.affine_transform(torch.from_numpy(images),
                                torch.from_numpy(matrix),
                                interpolation='bilinear').numpy()
    np.testing.assert_array_equal(got, want)


def test_rescale_matches_jax():
    images = _images(size=(40, 40))
    level = _params()['level']
    want = np.asarray(jax.vmap(jops.rescale)(jnp.asarray(images),
                                             jnp.asarray(level)))
    got = tops.rescale(torch.from_numpy(images),
                       torch.from_numpy(level)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_TOL)


def test_rgb_hsv_round_trip_matches_jax():
    rgb = _images() / 255.0
    hsv = np.asarray(jax.vmap(jcolor.rgb_to_hsv)(jnp.asarray(rgb)))
    np.testing.assert_array_equal(
        tcolor.rgb_to_hsv(torch.from_numpy(rgb)).numpy(), hsv)
    np.testing.assert_array_equal(
        tcolor.hsv_to_rgb(torch.from_numpy(hsv)).numpy(),
        np.asarray(jax.vmap(jcolor.hsv_to_rgb)(jnp.asarray(hsv))))


def test_gaussian_blur_matches_jax():
    images = _images()
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    want = np.asarray(jax.vmap(lambda k, im: jcolor.gaussian_blur(k, im))(
        keys, jnp.asarray(images)))
    # the sigma each key drew (gaussian_blur's first split)
    sigma = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(k)[0], (), minval=0.1, maxval=2.0))(keys))
    got = tcolor.gaussian_blur(torch.from_numpy(images),
                               torch.from_numpy(sigma)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_TOL)


def test_color_jitter_matches_jax_per_example_orders():
    """color_jitter with JAX's draws: each example runs its own order of
    the four ops (grouped by op at each slot). ``lax.switch`` compiles its
    branches into one XLA computation whose fused multiply-adds round
    apart from the eager ops (seen: 1.5e-4 at 18 of 34560 values), so
    this is held at the convolutions' 3e-4."""
    from torch_parity import _jax_jitter
    images = _images()
    keys = jax.random.split(jax.random.PRNGKey(4), N)
    want = np.asarray(jax.vmap(lambda k, im: jcolor.color_jitter(
        k, im, strength=0.5))(keys, jnp.asarray(images)))
    order, factor = jax.vmap(lambda k: _jax_jitter(k, 0.5))(keys)
    assert len({tuple(o) for o in np.asarray(order)}) > 1
    got = tcolor.color_jitter(torch.from_numpy(images),
                              torch.from_numpy(np.asarray(order)).long(),
                              torch.from_numpy(np.asarray(factor))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_TOL)


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), N)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_random_resized_crop_matches_jax(seed):
    frame, out = 64, 40
    images = _images(seed, size=(frame, frame))
    keys = _keys(seed)
    want = np.asarray(jax.vmap(lambda k, im: jpre.random_resized_crop(
        k, im, out))(keys, jnp.asarray(images)))
    crop = np.asarray(jax.vmap(lambda k: _jax_crop(k, frame, frame))(keys))
    got = tpre.random_resized_crop(torch.from_numpy(images),
                                   torch.from_numpy(crop), out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_TOL)


def test_random_flip_and_train_preprocess_match_jax():
    frame, out = 64, 40
    images = _images(size=(frame, frame))
    keys = _keys(5)
    flip = np.asarray(jax.vmap(jax.random.bernoulli)(keys))
    assert 0 < flip.sum() < N
    want = np.asarray(jax.vmap(jpre.random_flip)(keys, jnp.asarray(images)))
    np.testing.assert_array_equal(
        tpre.random_flip(torch.from_numpy(images),
                         torch.from_numpy(flip)).numpy(), want)

    want = np.asarray(jax.vmap(lambda k, im: jpre.train_preprocess(
        k, im, out))(keys, jnp.asarray(images)))
    crop = np.asarray(jax.vmap(lambda k: _jax_crop(jax.random.split(k)[0],
                                                   frame, frame))(keys))
    flip = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(
        jax.random.split(k)[1]))(keys))
    got = tpre.train_preprocess(torch.from_numpy(images),
                                torch.from_numpy(crop),
                                torch.from_numpy(flip), out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_TOL)


def test_train_cifar_preprocess_matches_jax():
    images = _images(size=(32, 32))
    keys = _keys(6)
    want = np.asarray(jax.vmap(jpre.train_cifar_preprocess)(
        keys, jnp.asarray(images)))

    def draws(k):
        r_y, r_x, r_flip = jax.random.split(k, 3)
        return (jax.random.randint(r_y, (), 0, 9),
                jax.random.randint(r_x, (), 0, 9),
                jax.random.bernoulli(r_flip))

    y0, x0, flip = (torch.from_numpy(np.asarray(a))
                    for a in jax.vmap(draws)(keys))
    got = tpre.train_cifar_preprocess(torch.from_numpy(images), y0.long(),
                                      x0.long(), flip).numpy()
    np.testing.assert_array_equal(got, want)


def test_cutout_matches_jax():
    images = _images()
    keys = _keys(7)
    want = np.asarray(jax.vmap(lambda k, im: jops.cutout(im, k, 9))(
        keys, jnp.asarray(images)))

    def centers(k):
        ry, rx = jax.random.split(k)
        return (jax.random.randint(ry, (), 0, H),
                jax.random.randint(rx, (), 0, W))

    cy, cx = (torch.from_numpy(np.asarray(a)).long()
              for a in jax.vmap(centers)(keys))
    got = tops.cutout(torch.from_numpy(images), cy, cx, 9).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_erasing_matches_jax():
    size = 40
    images = _images(size=(size, size))
    keys = _keys(8)
    want = np.asarray(jax.vmap(lambda k, im: jops.random_erasing(
        im, k, erase_prob=0.5))(keys, jnp.asarray(images)))
    apply, box, noise = (np.asarray(a) for a in jax.vmap(
        lambda k: _jax_erase(k, size, 0.5))(keys))
    assert 0 < apply.sum() < N
    got = tops.random_erasing(torch.from_numpy(images),
                              torch.from_numpy(apply),
                              torch.from_numpy(box).long(),
                              torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got, want)


def _mix_inputs(seed=9, size=32):
    rng = np.random.RandomState(seed)
    images = rng.uniform(-2, 2, (8, size, size, 3)).astype(np.float32)
    labels = rng.randint(0, 10, 8).astype(np.int32)
    return images, labels


def _assert_batch_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_mixup_and_cutmix_match_jax():
    images, labels = _mix_inputs()
    key = jax.random.PRNGKey(10)
    config = jpipe.AugmentConfig()
    draws = _jax_mix(key, 8, 32, config)
    rng_mix, rng_cut = jax.random.split(key, 4)[2:]
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels).long()
    want = jmix.mixup(rng_mix, jnp.asarray(images), jnp.asarray(labels), 0.8)
    got = tmix.mixup(ti, tl, torch.from_numpy(draws['mixup']['ratio']),
                     torch.from_numpy(draws['mixup']['perm']).long())
    _assert_batch_equal(got, want)
    want = jmix.cutmix(rng_cut, jnp.asarray(images), jnp.asarray(labels), 1.0)
    got = tmix.cutmix(ti, tl, torch.from_numpy(draws['cutmix']['box']).long())
    assert (got['ratio'] < 1).any()
    _assert_batch_equal(got, want)


@pytest.mark.parametrize('seed', range(6))
@pytest.mark.parametrize('prob', [1.0, 0.5])
def test_mix_augment_matches_jax(seed, prob):
    """Both branches and, at prob 0.5, both sides of the gate appear over
    the seeds."""
    images, labels = _mix_inputs(seed)
    key = jax.random.PRNGKey(100 + seed)
    config = jpipe.AugmentConfig(mix_prob=prob)
    want = jmix.mix_augment(key, jnp.asarray(images), jnp.asarray(labels),
                            prob_to_apply=prob)
    draws = _jax_mix(key, 8, 32, config)
    draws = {k: ({kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()}
                 if isinstance(v, dict) else v) for k, v in draws.items()}
    got = tmix.mix_augment(torch.from_numpy(images),
                           torch.from_numpy(labels).long(), draws,
                           prob_to_apply=prob)
    _assert_batch_equal(got, want)


def test_port_draws_have_the_jax_distributions():
    """The port's own draws: shapes, dtypes and ranges of every field, and
    one generator seed giving one set of draws."""
    config = tpipe.parse_augment_name('cutmix_mixup_randaugment_405')
    a = tpipe.draw(tpipe.step_generator(0, 3), 64, 48, config, 40)
    b = tpipe.draw(tpipe.step_generator(0, 3), 64, 48, config, 40)
    crop = a['crop']
    assert crop.shape == (64, 4) and crop.dtype == torch.float32
    assert (crop[:, 2:] >= 1).all() and (crop[:, 2:] <= 48).all()
    assert (crop[:, 0] + crop[:, 2] <= 48 + 1e-4).all()
    ra = a['ra']
    assert ra['op'].shape == (4, 64) and int(ra['op'].max()) < 16
    assert torch.allclose(ra['level'], torch.full((4, 64), 0.5))
    assert ra['apply'].all()
    box = a['erase']['box']
    assert ((box[:, 2] >= 1) & (box[:, 2] <= 20)).all()
    assert a['erase']['noise'].shape == (64, 40, 40, 3)
    mixup = a['mix']['mixup']
    assert (mixup['ratio'] >= 0.5).all() and (mixup['ratio'] <= 1).all()
    assert sorted(mixup['perm'].tolist()) == list(range(64))
    cut = a['mix']['cutmix']['box']
    assert (cut[:, 0] + cut[:, 2] <= 40).all()
    for key in ('crop', 'flip'):
        assert torch.equal(a[key], b[key])
    assert torch.equal(a['erase']['noise'], b['erase']['noise'])
    level = tpipe.draw(tpipe.step_generator(1, 0), 512, 48,
                       tpipe.parse_augment_name('randaugment'), 40)['ra']
    assert 0.8 < float(level['level'].mean() * 10 / 9) < 1.2
    assert 0.4 < float(level['apply'].float().mean()) < 0.6


# (string, the config every field of which must equal the JAX parse's)
NAMES = ['cutmix_mixup_randaugment_405', 'randaugment', 'none', '',
         'mixup_0.5_colorjitter_0.4', 'cutmix', 'mixup', 'colorjitter',
         'randaugment_colorjitter', 'randaugment_29_mixup_0.25',
         'cutmix_mixup_0.7', 'randaugment_312_cutmix', 'colorjitter_.6']


@pytest.mark.parametrize('name', NAMES)
def test_parse_augment_name_matches_jax(name):
    assert (dataclasses_asdict(tpipe.parse_augment_name(name))
            == dataclasses_asdict(jpipe.parse_augment_name(name)))


def dataclasses_asdict(config):
    import dataclasses
    return dataclasses.asdict(config)


SPLITS = ['train', 'train[:90%]', 'train[90%:]', 'validation', '[5%:15%]',
          'train[10 %:20 %]', 'train[2.5%:97.5%]', 'holdout[95%:]']
BAD_SPLITS = ['train[ 10 %: 20 %]', 'train[90%:10%]', 'train[50%:50%]',
              '1train', 'train[:120%]', 'train[', ' ']


@pytest.mark.parametrize('spec', SPLITS)
def test_parse_split_fractions_matches_jax(spec):
    assert (tpipe.parse_split_fractions(spec)
            == jpipe.parse_split_fractions(spec))
    name = f'/data/x?split={spec}'
    assert tpipe.parse_dataset_spec(name) == jpipe.parse_dataset_spec(name)


@pytest.mark.parametrize('spec', BAD_SPLITS)
def test_parse_split_fractions_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jpipe.parse_split_fractions(spec)
    with pytest.raises(ValueError):
        tpipe.parse_split_fractions(spec)


def test_parse_dataset_spec_without_split():
    assert tpipe.parse_dataset_spec('/a/b') == ('/a/b', None)
