"""Torch port serving: eval preprocessing against sav_tpu's (@224 and
@384), the ``serve`` top-k against the JAX forward, and the predict CLI
on JPEGs with and without ``params.npz``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sav_tpu.data.preprocess import eval_preprocess as jax_eval_preprocess
from sav_tpu_torch import predict
from sav_tpu_torch.data.preprocess import eval_preprocess
from sav_tpu_torch.utils.flax_bridge import flatten_tree
from torch_parity import jax_vit, torch_vit

# preprocessed pixels are ~N(0, 1) after normalize; the two frameworks sum
# the resampling products in other orders (f32)
PIXEL_ATOL = 1e-4


def _frames(n, size, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               dtype=np.uint8)


@pytest.mark.parametrize('img_size', [224, 384])
def test_eval_preprocess_matches_jax(img_size):
    frames = _frames(2, predict.decode_size_for(img_size))
    expect = jax.vmap(lambda im: jax_eval_preprocess(
        im.astype(jnp.float32), img_size))(jnp.asarray(frames))
    ours = eval_preprocess(torch.from_numpy(frames).float(), img_size)
    assert ours.shape == (2, img_size, img_size, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(expect),
                               atol=PIXEL_ATOL, rtol=0)


def test_decode_sizes():
    assert predict.decode_size_for(224) == 256
    assert predict.decode_size_for(384) == 439


def test_serve_top_k_matches_jax():
    img = 32
    model, params = jax_vit(img, use_kernel=False)
    frames = _frames(3, predict.decode_size_for(img), seed=1)
    x = jax.vmap(lambda im: jax_eval_preprocess(im.astype(jnp.float32),
                                                img))(jnp.asarray(frames))
    logits = model.apply({'params': params}, x, is_training=False)
    probs, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 3)
    ours_p, ours_i = predict.serve(torch_vit(params, img), frames, img, 3)
    np.testing.assert_array_equal(ours_i.numpy(), np.asarray(idx))
    np.testing.assert_allclose(ours_p.numpy(), np.asarray(probs), atol=1e-5,
                               rtol=0)


@pytest.fixture(scope='module')
def full_vit_ti():
    """vit_ti_patch16 at 32 px with a filled head (the CLI builds registry
    configs, so the tree is the full 12-layer one)."""
    return jax_vit(32, overrides={}, use_kernel=False)


def _write_jpegs(tmp_path):
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(48, 40), (40, 56)]):
        arr = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f'im{i}.jpg', quality=95)
    return img_dir


def _run_cli(args, capsys):
    predict.main(args)
    captured = capsys.readouterr()
    return [json.loads(line) for line in captured.out.splitlines()], \
        captured.err


def test_cli_with_params_npz(tmp_path, capsys, full_vit_ti):
    model, params = full_vit_ti
    ckpt = tmp_path / 'ckpt'
    ckpt.mkdir()
    np.savez(ckpt / 'params.npz', **flatten_tree(params))
    img_dir = _write_jpegs(tmp_path)
    lines, err = _run_cli(
        ['-m', 'vit_ti_patch16', '-c', str(ckpt), '--images', str(img_dir),
         '-s', '32', '--num_classes', '10', '--top_k', '3', '--dtype',
         'float32', '--device', 'cpu', '-b', '1'], capsys)
    assert 'loaded' in err and len(lines) == 2
    frames = np.stack([predict.decode_jpeg_fixed(line['path'], 37)
                       for line in lines])
    x = jax.vmap(lambda im: jax_eval_preprocess(im.astype(jnp.float32),
                                                32))(jnp.asarray(frames))
    logits = model.apply({'params': params}, x, is_training=False)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 3)
    for line, want in zip(lines, np.asarray(idx)):
        assert [c['class'] for c in line['top_k']] == want.tolist()


def test_cli_without_params_warns_and_uses_random_init(tmp_path, capsys):
    img_dir = _write_jpegs(tmp_path)
    lines, err = _run_cli(
        ['-m', 'vit_ti_patch16', '-c', str(tmp_path / 'missing'), '--images',
         str(img_dir / '*.jpg'), '-s', '32', '--num_classes', '10',
         '--top_k', '2', '--device', 'cpu'], capsys)
    assert 'WARNING' in err and 'random init' in err
    assert len(lines) == 2
    for line in lines:
        assert len(line['top_k']) == 2
        # zero-initialised head: uniform probabilities
        assert all(abs(c['prob'] - 0.1) < 1e-3 for c in line['top_k'])


def test_cli_refuses_int8(tmp_path):
    # families without an int8 path refuse --quantized, as the JAX factory does
    with pytest.raises(RuntimeError, match='no int8 path'):
        predict.main(['-m', 'tnt_s_patch16', '-c', str(tmp_path),
                      '--images', str(tmp_path), '--quantized', 'ff',
                      '--device', 'cpu'])
