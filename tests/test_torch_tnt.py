"""Torch port: TNT. Logits from one flax tree against ``sav_tpu.models.TNT``
in three modes (per-op, ``'fused_inner'`` and ``'fused_inner_outer'``, the
JAX kernels in interpret mode) at both inner widths (tnt_s_patch16's D=24
and tnt_b_patch16's D=40); every route keeps the flax tree's keys; the
pixel-token order; ``'auto'`` off the card and its refusal on the card;
the two factory names and the refusals (scan layout, dropout, unknown
modes); and the CLIs end to end on a TNT name on the CPU.

float32, ``torch_parity.TNT_SMALL`` (2 layers, 32 px, 8 x 8 patches of 4
pixel tokens, outer D=128 H=2). The head, cls, LayerNorms and Dense biases
are filled (their inits would let a swapped one pass unseen). Tolerance:
logits atol 1e-4, as the ViT, CaiT and Mixer tests.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import tnt_inner as jax_ti
from sav_tpu_torch import predict
from sav_tpu_torch.models import available_models, create_model, set_use_kernel
from sav_tpu_torch.models.factory import MODEL_CONFIGS
from sav_tpu_torch.models.tnt import EncoderBlock, pixel_tokens
from sav_tpu_torch.train import __main__ as train_cli
from sav_tpu_torch.utils.flax_bridge import (flatten_tree, flax_to_torch,
                                             torch_to_flax)
from torch_parity import (NUM_CLASSES, TNT_NAMES, TNT_SMALL, images, jax_tnt,
                          torch_tnt)

ATOL = 1e-4
MODES = (False, 'fused_inner', 'fused_inner_outer')


@pytest.fixture(autouse=True)
def nb128(monkeypatch):
    """128 patches a JAX kernel block, as the JAX package's own tests."""
    monkeypatch.setattr(jax_ti, '_NB', 128)


def _jax_logits(name, use_kernel, x):
    model, params = jax_tnt(name, use_kernel=use_kernel)
    return params, np.asarray(model.apply({'params': params}, jnp.asarray(x),
                                          is_training=False))


@pytest.mark.parametrize('use_kernel', MODES)
@pytest.mark.parametrize('name', TNT_NAMES)
def test_logits_match_jax(name, use_kernel):
    x = images(2, 32)
    params, want = _jax_logits(name, use_kernel, x)
    model = torch_tnt(params, name, use_kernel=use_kernel)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize('use_kernel', MODES + ('auto', 'fused_layer_full'))
def test_every_route_keeps_the_flax_keys(use_kernel):
    _, params = jax_tnt()
    want = sorted(flatten_tree(params))
    model = torch_tnt(params, use_kernel=use_kernel)
    assert sorted(flatten_tree(torch_to_flax(model.state_dict()))) == want
    for key in ('PixelEmbedBlock_0/Dense_0/kernel', 'AddAbsPosEmbed_1/pos_embed',
                'Encoder_0/EncoderBlock_1/Inner2OuterBlock_0/Dense_0/kernel',
                'Encoder_0/EncoderBlock_1/FFBlock_1/Dense_1/bias', 'cls'):
        assert key in want


def test_pixel_tokens_are_channel_major():
    """Each 4 x 4 pixel block flattens as (c t1 t2), as the JAX package's
    rearrange; a (t1 t2 c) order has the same shape and only a parity test
    of values tells them apart."""
    img = torch.arange(2 * 16 * 16 * 3, dtype=torch.float32).reshape(
        2, 16, 16, 3)
    tok = pixel_tokens(img, (8, 8), (4, 4))
    assert tok.shape == (2 * 4, 4, 48)
    # image 1, patch (row 1, col 0), pixel block (1, 1), channel 2, t (3, 0)
    want = img[1, 8 + 4 + 3, 0 + 4 + 0, 2]
    assert tok[1 * 4 + 2, 1 * 2 + 1, 2 * 16 + 3 * 4 + 0] == want


def test_auto_is_per_op_off_the_card_and_set_use_kernel_reroutes():
    x = images(2, 32, seed=3)
    params, want = _jax_logits('tnt_s_patch16', False, x)
    model = torch_tnt(params, use_kernel='auto')
    with torch.no_grad():
        auto = model(torch.from_numpy(x))
        set_use_kernel(model, 'fused_inner_outer')
        rerouted = model(torch.from_numpy(x))
    np.testing.assert_allclose(auto.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(rerouted.numpy(), want, atol=ATOL, rtol=0)
    assert all(m.use_kernel == 'fused_inner_outer' for m in model.modules()
               if isinstance(m, EncoderBlock))
    with pytest.raises(NotImplementedError, match='TNT'):
        set_use_kernel(model, 'fused_token')


def test_auto_refuses_an_inner_shape_the_kernels_do_not_take_on_the_card():
    """On the card 'auto' raises for 4 pixel tokens (the kernels take one
    16-row tile a patch) instead of running the inner layer per-op; the
    same model routes per-op off the card."""
    model = create_model('tnt_s_patch16', num_classes=NUM_CLASSES, img_size=32,
                         device='cpu', **TNT_SMALL)
    block = model.Encoder_0.EncoderBlock_0
    on_card = types.SimpleNamespace(shape=(32, 4, 24),
                                    device=torch.device('cuda'))
    with pytest.raises(NotImplementedError, match='use_kernel=False'):
        block.inner_route(on_card)
    assert not block.inner_route(torch.zeros(32, 4, 24))


def test_factory_names_and_refusals():
    assert set(TNT_NAMES) <= set(available_models())
    want = {'tnt_s_patch16': (12, 4, 6, 24, 384),
            'tnt_b_patch16': (12, 4, 10, 40, 640)}
    for name, dims in want.items():
        cls, config = MODEL_CONFIGS[name]
        assert cls.__name__ == 'TNT'
        assert tuple(config[k] for k in (
            'num_layers', 'inner_num_heads', 'outer_num_heads',
            'inner_embed_dim', 'outer_embed_dim')) == dims
    model = create_model('tnt_b_patch16', device='cpu', num_layers=1)
    block = model.Encoder_0.EncoderBlock_0
    assert model.PixelEmbedBlock_0.Dense_0.kernel.shape == (48, 40)
    assert block.Inner2OuterBlock_0.Dense_0.kernel.shape == (16 * 40, 640)
    assert block.FFBlock_0.Dense_0.kernel.shape == (40, 160)
    assert model.AddAbsPosEmbed_0.pos_embed.shape == (1, 16, 40)
    assert model.AddAbsPosEmbed_1.pos_embed.shape == (1, 197, 640)
    assert model.PatchEmbedBlock_0.Dense_0.bias is not None
    with pytest.raises(NotImplementedError, match='scan'):
        create_model('tnt_s_patch16', device='cpu', scan_layers=True)
    with pytest.raises(NotImplementedError, match='dropout'):
        create_model('tnt_s_patch16', device='cpu', dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match='TNT mode'):
        create_model('tnt_s_patch16', device='cpu', use_kernel='fused_th')


def test_bridge_refuses_a_scan_stacked_tnt_tree():
    stacked = {'Encoder_0': {'EncoderBlock': {'LayerNorm_0': {
        'scale': np.ones((2, 24), np.float32)}}}}
    with pytest.raises(NotImplementedError, match='scan-stacked'):
        flax_to_torch(stacked)


def test_cli_trains_tnt_and_predict_reads_its_checkpoint(tmp_path, capsys):
    ckpt = tmp_path / 'ck'
    metrics = train_cli.main(['--device', 'cpu', '--data_dir', 'synthetic',
                              '-m', 'tnt_s_patch16', '-s', '32', '-b', '2',
                              '--total_steps', '2', '--eval_batches', '1',
                              '--num_classes', '10', '-c', str(ckpt)])
    assert np.isfinite(metrics['loss']) and 'eval_loss' in metrics
    assert (ckpt / 'params.npz').exists()
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    from PIL import Image
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (40, 50, 3), dtype=np.uint8)).save(img_dir / 'a.jpg')
    capsys.readouterr()
    predict.main(['-m', 'tnt_s_patch16', '-c', str(ckpt), '--images',
                  str(img_dir), '-s', '32', '--device', 'cpu', '--top_k', '2',
                  '--num_classes', '10'])
    captured = capsys.readouterr()
    assert 'loaded' in captured.err and len(captured.out.splitlines()) == 1
