"""Torch port: ViT logits against sav_tpu's from the same flax tree, for
every pos_embed value and every attention route the port has, float32.

Tolerance: logits atol 1e-4 (2 layers of f32 math in another summation
order, logits of magnitude ~10 from the filled head)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.models import available_models as jax_available_models
from sav_tpu_torch.models import available_models, create_model
from sav_tpu_torch.models.vit import set_use_kernel
from torch_parity import images, jax_vit, torch_vit

IMG = 32
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax(pos_embed):
    model, params = jax_vit(IMG, pos_embed=pos_embed, use_kernel=False)
    logits = model.apply({'params': params}, jnp.asarray(images(2, IMG)),
                         is_training=False)
    return params, np.asarray(logits)


@pytest.mark.parametrize('use_kernel', [False, 'fused_layer',
                                        'fused_layer_full'])
@pytest.mark.parametrize('pos_embed', ['learned', 'fixed', 'rotary', 'none'])
def test_logits_match_jax(pos_embed, use_kernel):
    params, expect = _jax(pos_embed)
    model = torch_vit(params, IMG, pos_embed=pos_embed, use_kernel=use_kernel)
    with torch.no_grad():
        logits = model(torch.from_numpy(images(2, IMG)))
    assert logits.shape == (2, 10)
    np.testing.assert_allclose(logits.numpy(), expect, atol=ATOL, rtol=0)


def test_auto_is_the_per_op_path_on_cpu():
    params, expect = _jax('learned')
    model = torch_vit(params, IMG, use_kernel='auto')
    with torch.no_grad():
        logits = model(torch.from_numpy(images(2, IMG)))
    np.testing.assert_allclose(logits.numpy(), expect, atol=ATOL, rtol=0)


def test_set_use_kernel_reroutes_the_same_weights():
    params, expect = _jax('learned')
    model = torch_vit(params, IMG, use_kernel=False)
    set_use_kernel(model, 'fused_layer_xla')
    with torch.no_grad():
        logits = model(torch.from_numpy(images(2, IMG)))
    np.testing.assert_allclose(logits.numpy(), expect, atol=ATOL, rtol=0)
    with pytest.raises(NotImplementedError):
        set_use_kernel(model, 'fused_block')


def test_factory_names_and_refusals():
    """The port's factory has every name of the JAX factory (all 34, the
    three CvT names with them); a name neither has raises; the HF layer
    options build."""
    assert available_models() == jax_available_models()
    assert len(available_models()) == 34
    assert {'cvt-13', 'cvt-21', 'cvt-w24'} <= set(available_models())
    with pytest.raises(RuntimeError, match='Model not found'):
        create_model('vit_h_patch14', device='cpu')
    # fused_qkv and attn_bias build (the importers' trees carry the
    # biases); only a forced fused-sublayer mode refuses them
    model = create_model('vit_ti_patch16', device='cpu', num_layers=1,
                         fused_qkv=True)
    assert model.Encoder_0.EncoderBlock_0.SelfAttentionBlock_0.fused_qkv
    model = create_model('vit_ti_patch16', device='cpu', num_layers=1,
                         attn_bias=True)
    attn = model.Encoder_0.EncoderBlock_0.SelfAttentionBlock_0
    assert attn.queries.bias.shape == (3, 64)
    assert attn.DenseGeneral_0.bias.shape == (192,)
    with pytest.raises(ValueError, match='attn_bias'):
        create_model('vit_ti_patch16', device='cpu', num_layers=1,
                     attn_bias=True, use_kernel='fused_layer')


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('this host has a card; the refusal is for hosts without')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        create_model('vit_ti_patch16', num_layers=1)


def test_init_is_seeded_and_flax_shaped():
    a = create_model('vit_ti_patch16', device='cpu', num_layers=1, seed=3)
    b = create_model('vit_ti_patch16', device='cpu', num_layers=1, seed=3)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    sd = a.state_dict()
    assert torch.count_nonzero(sd['Dense_0.kernel']) == 0      # zero head
    assert torch.count_nonzero(sd['cls']) == 0
    std = sd['Encoder_0.EncoderBlock_0.SelfAttentionBlock_0.queries.kernel'].std()
    assert abs(float(std) - 192 ** -0.5) < 0.1 * 192 ** -0.5   # lecun normal
