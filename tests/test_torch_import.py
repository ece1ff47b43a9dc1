"""Torch port: the checkpoint importers (HF, timm, AugReg npz), the
safetensors reader and writer, the ``model.json`` spec path, the
``import_checkpoint`` CLI into ``predict`` and ``train --finetune_from``,
and the loss-stream comparison, against the JAX package's counterparts.

The source models are built in-process, as the JAX import tests build
them: a ``transformers`` ViT from a config, the timm-layout torch ViT of
``tests/test_timm_import.py``, the flat AugReg npz of
``tests/test_npz_import.py``; nothing is downloaded. Every parameter of
the HF model is filled from a seeded generator (its biases start at zero,
which would hide a dropped or swapped bias).

float32 on the CPU. Tolerances: the converters' trees equal the JAX
converters' bit for bit; the port's logits against the HF model's atol
5e-4, rtol 5e-3 (the JAX test's: HF's LayerNorm eps is 1e-12, the
import's 1e-6, and torch sums in another order), against the JAX model's
from the same tree atol 1e-5 (f32 in another order, logits ~1).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip('transformers')

from sav_tpu.models.factory import _spec_activation as jax_spec_activation  # noqa: E402
from sav_tpu.models.factory import create_model as jax_create_model  # noqa: E402
from sav_tpu.models.vit import ViT as JaxViT  # noqa: E402
from sav_tpu.utils import hf_import as jax_hf  # noqa: E402
from sav_tpu.utils import npz_import as jax_npz  # noqa: E402
from sav_tpu.utils import timm_import as jax_timm  # noqa: E402
from sav_tpu_torch import compare_loss_streams, import_checkpoint  # noqa: E402
from sav_tpu_torch import predict  # noqa: E402
from sav_tpu_torch.models import create_model  # noqa: E402
from sav_tpu_torch.models.factory import resolve_num_classes  # noqa: E402
from sav_tpu_torch.models.vit import ViT  # noqa: E402
from sav_tpu_torch.train import __main__ as train_cli  # noqa: E402
from sav_tpu_torch.utils import hf_import, npz_import  # noqa: E402
from sav_tpu_torch.utils import safetensors as st  # noqa: E402
from sav_tpu_torch.utils import timm_import  # noqa: E402
from sav_tpu_torch.utils.flax_bridge import flatten_tree, flax_to_torch  # noqa: E402
import test_npz_import  # noqa: E402
import test_timm_import  # noqa: E402
import torch_parity  # noqa: E402,F401  (pins torch to one thread)

IMG = 32
HF_CONFIG = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                 intermediate_size=256, image_size=IMG, patch_size=8,
                 hidden_act='gelu')
HF_ATOL, HF_RTOL = 5e-4, 5e-3
JAX_ATOL = 1e-5


def fill_torch(model, seed):
    """Every parameter of a torch ViT from a seeded generator: LayerNorm
    scales 1 + N(0, 0.1^2), biases N(0, 0.1^2), the cls token and the
    position embedding N(0, 0.5^2), every other matrix N(0, 1/fan_in)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            module = name.rsplit('.', 2)[-2] if '.' in name else name
            if 'norm' in module and name.endswith('weight'):
                p.copy_(1.0 + 0.1 * noise)
            elif name.endswith('bias'):
                p.copy_(0.1 * noise)
            elif 'token' in name or 'pos' in name:
                p.copy_(0.5 * noise)
            else:
                p.copy_(noise / np.sqrt(np.prod(p.shape[1:])))
    return model


def _hf(num_labels=13, headless=False, **overrides):
    cfg = transformers.ViTConfig(**{**HF_CONFIG, **overrides},
                                 num_labels=num_labels)
    torch.manual_seed(0)
    model = (transformers.ViTModel(cfg, add_pooling_layer=False) if headless
             else transformers.ViTForImageClassification(cfg))
    return cfg, fill_torch(model, 1).eval()


@pytest.fixture(scope='module')
def hf_model():
    return _hf()


def _state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def images(seed=3, batch=2):
    return np.random.RandomState(seed).standard_normal(
        (batch, IMG, IMG, 3)).astype(np.float32)


def hf_logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits.numpy()


def port_logits(params, kwargs, x, **extra):
    model = ViT(**kwargs, img_size=IMG, use_kernel=False, **extra)
    model.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def jax_logits(params, kwargs, x):
    """The JAX model of the port's kwargs (the activation's table name
    decoded by the JAX factory's own table) on the same tree."""
    kwargs = dict(kwargs, activation_fn=jax_spec_activation(
        kwargs['activation_fn']))
    model = JaxViT(**kwargs, use_kernel=False)
    return np.asarray(model.apply({'params': params}, jnp.asarray(x),
                                  is_training=False))


def assert_same_tree(ours, want):
    ours, want = flatten_tree(ours), flatten_tree(want)
    assert sorted(ours) == sorted(want)
    for key in want:
        assert ours[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(ours[key], want[key], err_msg=key)


# ---- HF

def test_hf_tree_equals_jax_bit_for_bit(hf_model):
    cfg, model = hf_model
    sd = _state(model)
    params, kwargs = hf_import.convert_hf_vit(sd, cfg)
    want, want_kwargs = jax_hf.convert_hf_vit(sd, cfg)
    assert_same_tree(params, want)
    assert hf_import.model_spec(kwargs) == jax_hf.model_spec(want_kwargs)
    assert kwargs['activation_fn'] == 'gelu_exact'


def test_hf_dir_reads_what_save_pretrained_wrote(hf_model, tmp_path):
    """``read_hf_dir`` on ``save_pretrained``'s ``model.safetensors``
    gives the JAX converter's tree of the in-memory state dict."""
    cfg, model = hf_model
    model.save_pretrained(tmp_path)
    assert (tmp_path / 'model.safetensors').exists()
    sd, config = hf_import.read_hf_dir(str(tmp_path))
    assert config['hidden_act'] == 'gelu' and config['layer_norm_eps'] == 1e-12
    params, _ = hf_import.convert_hf_vit(sd, config)
    want, _ = jax_hf.convert_hf_vit(_state(model), cfg)
    assert_same_tree(params, want)


@pytest.mark.parametrize('fused_qkv', [False, True])
def test_hf_logits_match_hf_and_jax(hf_model, fused_qkv):
    cfg, model = hf_model
    params, kwargs = hf_import.convert_hf_vit(_state(model), cfg)
    x = images()
    ours = port_logits(params, kwargs, x, fused_qkv=fused_qkv)
    np.testing.assert_allclose(ours, hf_logits(model, x), atol=HF_ATOL,
                               rtol=HF_RTOL)
    np.testing.assert_allclose(ours, jax_logits(params, kwargs, x),
                               atol=JAX_ATOL, rtol=0)


def test_hf_headless_model_imports_as_a_trunk(tmp_path):
    """A ``ViTModel`` (no ``vit.`` prefix, no classifier; saved with its
    pooler, which the import drops) gets a zero head of ``num_classes``,
    and its trunk equals the JAX converter's."""
    cfg, model = _hf(headless=True)
    torch.manual_seed(0)
    with_pooler = fill_torch(transformers.ViTModel(cfg), 1)
    with_pooler.save_pretrained(tmp_path)
    sd, config = hf_import.read_hf_dir(str(tmp_path))
    assert not any(k.startswith('pooler.') for k in sd)
    params, kwargs = hf_import.convert_hf_vit(sd, config, num_classes=7)
    want, want_kwargs = jax_hf.convert_hf_vit(_state(model), cfg,
                                              num_classes=7)
    assert_same_tree(params, want)
    assert kwargs['num_classes'] == want_kwargs['num_classes'] == 7
    assert not params['Dense_0']['kernel'].any()
    assert params['Dense_0']['kernel'].shape == (64, 7)


def test_hf_without_qkv_bias_raises_as_jax_does():
    """``qkv_bias=False`` leaves no q/k/v bias keys: both converters raise
    KeyError on the first (neither invents a zero bias)."""
    cfg, model = _hf(qkv_bias=False)
    sd = _state(model)
    assert not any(k.endswith('query.bias') for k in sd)
    with pytest.raises(KeyError, match='query.bias'):
        jax_hf.convert_hf_vit(sd, cfg)
    with pytest.raises(KeyError, match='query.bias'):
        hf_import.convert_hf_vit(sd, cfg)


def test_hf_activation_names():
    assert hf_import._act_fn('gelu') == 'gelu_exact'
    for name in ('gelu_new', 'gelu_fast', 'gelu_pytorch_tanh'):
        assert hf_import._act_fn(name) == 'gelu'
    with pytest.raises(ValueError, match='hidden_act'):
        hf_import._act_fn('swish')


# ---- safetensors

def test_safetensors_reader_matches_the_library(hf_model, tmp_path):
    """The reader on what ``save_pretrained`` wrote, against the
    ``safetensors`` package's own reader and the model's state dict."""
    safetensors_numpy = pytest.importorskip('safetensors.numpy')
    _, model = hf_model
    model.save_pretrained(tmp_path)
    path = str(tmp_path / 'model.safetensors')
    ours = st.load_file(path)
    want = safetensors_numpy.load_file(path)
    assert sorted(ours) == sorted(want) == sorted(_state(model))
    for key in want:
        np.testing.assert_array_equal(ours[key], want[key], err_msg=key)
        np.testing.assert_array_equal(ours[key], _state(model)[key])


@pytest.mark.parametrize('dtype', ['F32', 'F16', 'BF16'])
def test_safetensors_round_trip(tmp_path, dtype):
    rng = np.random.RandomState(0)
    values = {'a.weight': rng.standard_normal((3, 5)).astype(np.float32),
              'b': rng.standard_normal((7,)).astype(np.float32),
              'c.scalar': np.full((), 2.5, np.float32)}
    if dtype == 'F32':
        tensors = values
    elif dtype == 'F16':
        tensors = {k: v.astype(np.float16) for k, v in values.items()}
    else:
        tensors = {k: torch.from_numpy(v).bfloat16()
                   for k, v in values.items()}
    path = str(tmp_path / 'x.safetensors')
    st.save_file(tensors, path, metadata={'format': 'pt'})
    header = st.read_header(path)
    assert header['__metadata__'] == {'format': 'pt'}
    assert {header[k]['dtype'] for k in values} == {dtype}
    back = st.load_file(path)
    for key, value in tensors.items():
        want = (value.float().numpy() if isinstance(value, torch.Tensor)
                else value)
        assert back[key].shape == want.shape
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    # the library reads what the writer wrote (numpy has no bfloat16: the
    # BF16 file through the library's torch reader)
    safetensors_torch = pytest.importorskip('safetensors.torch')
    lib = safetensors_torch.load_file(path)
    for key in tensors:
        np.testing.assert_array_equal(lib[key].float().numpy(), back[key])


def test_safetensors_sharded_index(hf_model, tmp_path):
    """A sharded checkpoint: transformers' own shards and index, and the
    writer's, both read back whole."""
    cfg, model = hf_model
    model.save_pretrained(tmp_path / 'hf', max_shard_size='100KB')
    assert (tmp_path / 'hf' / 'model.safetensors.index.json').exists()
    sd, config = hf_import.read_hf_dir(str(tmp_path / 'hf'))
    want = _state(model)
    assert sorted(sd) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(sd[key], want[key], err_msg=key)
    (tmp_path / 'ours').mkdir()
    index = st.save_sharded(want, str(tmp_path / 'ours'), 3)
    back = st.load_sharded(index)
    assert sorted(back) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], err_msg=key)


def test_pytorch_model_bin_is_read(hf_model, tmp_path):
    cfg, model = hf_model
    model.save_pretrained(tmp_path, safe_serialization=False)
    assert (tmp_path / 'pytorch_model.bin').exists()
    sd, config = hf_import.read_hf_dir(str(tmp_path))
    params, _ = hf_import.convert_hf_vit(sd, config)
    assert_same_tree(params, jax_hf.convert_hf_vit(_state(model), cfg)[0])


def test_hf_dir_without_weights_raises(tmp_path):
    (tmp_path / 'config.json').write_text('{}')
    with pytest.raises(FileNotFoundError, match='model.safetensors'):
        hf_import.read_hf_dir(str(tmp_path))


# ---- timm

@pytest.fixture(scope='module')
def timm_state():
    torch.manual_seed(0)
    model = fill_torch(test_timm_import._TimmViT(), 2).eval()
    return model, _state(model)


def test_timm_tree_equals_jax_bit_for_bit(timm_state):
    _, sd = timm_state
    params, kwargs = timm_import.convert_timm_vit(sd)
    want, want_kwargs = jax_timm.convert_timm_vit(sd)
    assert_same_tree(params, want)
    assert hf_import.model_spec(kwargs) == jax_hf.model_spec(want_kwargs)
    assert kwargs['num_heads'] == 1           # D // 64 at D = 64
    prefixed = {f'module.{k}': v for k, v in sd.items()}
    params, _ = timm_import.convert_timm_vit(
        prefixed, num_heads=test_timm_import.HEADS)
    assert_same_tree(params, jax_timm.convert_timm_vit(
        sd, num_heads=test_timm_import.HEADS)[0])


def test_timm_logits_match_torch_and_jax(timm_state):
    model, sd = timm_state
    params, kwargs = timm_import.convert_timm_vit(
        sd, num_heads=test_timm_import.HEADS)
    x = images(5)
    ours = port_logits(params, kwargs, x)
    with torch.no_grad():
        want = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(ours, want, atol=HF_ATOL, rtol=HF_RTOL)
    np.testing.assert_allclose(ours, jax_logits(params, kwargs, x),
                               atol=JAX_ATOL, rtol=0)


def test_timm_refusals(timm_state):
    _, sd = timm_state
    with pytest.raises(ValueError, match='distilled'):
        timm_import.convert_timm_vit({**sd, 'dist_token': np.zeros((1, 1, 64))})
    with pytest.raises(ValueError, match='missing keys'):
        timm_import.convert_timm_vit({'head.weight': np.zeros((2, 2))})
    with pytest.raises(ValueError, match='does not divide'):
        timm_import.convert_timm_vit(sd, num_heads=3)


def test_timm_file_envelope(timm_state, tmp_path):
    model, sd = timm_state
    path = tmp_path / 'deit.pth'
    torch.save({'model': model.state_dict(), 'epoch': 3}, path)
    back = timm_import.read_timm_file(str(path))
    assert sorted(back) == sorted(sd)
    for key in sd:
        np.testing.assert_array_equal(back[key], sd[key])


# ---- AugReg npz

@pytest.mark.parametrize('pre_logits', [False, True])
def test_npz_tree_equals_jax_bit_for_bit(pre_logits):
    sd = test_npz_import._make_npz(np.random.default_rng(0), pre_logits)
    params, kwargs = npz_import.convert_vit_npz(sd, num_classes=5)
    want, want_kwargs = jax_npz.convert_vit_npz(sd, num_classes=5)
    assert_same_tree(params, want)
    assert hf_import.model_spec(kwargs) == jax_hf.model_spec(want_kwargs)
    assert kwargs['activation_fn'] == 'gelu'
    if pre_logits:      # an in21k trunk: the bottleneck and head dropped
        assert kwargs['num_classes'] == 5
        assert not params['Dense_0']['kernel'].any()
    else:
        assert kwargs['num_classes'] == test_npz_import.CLASSES


def test_npz_logits_match_the_original_and_jax():
    sd = test_npz_import._make_npz(np.random.default_rng(0))
    params, kwargs = npz_import.convert_vit_npz(sd)
    x = images(7)
    ours = port_logits(params, kwargs, x)
    np.testing.assert_allclose(ours, test_npz_import._numpy_vit(sd, x),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ours, jax_logits(params, kwargs, x),
                               atol=JAX_ATOL, rtol=0)


def test_npz_refuses_a_non_vit_file():
    with pytest.raises(ValueError, match='missing keys'):
        npz_import.convert_vit_npz({'Dense_0/kernel': np.zeros((2, 2))})


# ---- model.json

def _write_spec(directory, spec):
    directory.mkdir(exist_ok=True)
    (directory / 'model.json').write_text(json.dumps(spec))
    return directory


def test_jax_written_spec_builds_the_port_model(hf_model, tmp_path):
    """A spec written by the JAX package's ``model_spec`` builds a port
    model whose logits match HF's, through the spec's path and through its
    directory; the spec's head width wins over the default."""
    cfg, model = hf_model
    want_params, want_kwargs = jax_hf.convert_hf_vit(_state(model), cfg)
    _write_spec(tmp_path, jax_hf.model_spec(want_kwargs))
    x = images(11)
    for name in (str(tmp_path / 'model.json'), str(tmp_path)):
        port = create_model(name, img_size=IMG, device='cpu',
                            use_kernel=False)
        assert port.Dense_0.kernel.shape[1] == 13
        port.load_state_dict(flax_to_torch(want_params), strict=True)
        with torch.no_grad():
            ours = port.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(ours, hf_logits(model, x), atol=HF_ATOL,
                                   rtol=HF_RTOL)


def test_port_written_spec_builds_the_jax_model(hf_model, tmp_path):
    cfg, model = hf_model
    params, kwargs = hf_import.convert_hf_vit(_state(model), cfg)
    _write_spec(tmp_path, hf_import.model_spec(kwargs))
    jax_model = jax_create_model(str(tmp_path / 'model.json'),
                                 use_kernel=False)
    assert jax_model.num_classes == 13
    x = images(13)
    want = np.asarray(jax_model.apply({'params': params}, jnp.asarray(x),
                                      is_training=False))
    np.testing.assert_allclose(port_logits(params, kwargs, x), want,
                               atol=JAX_ATOL, rtol=0)


def test_spec_num_classes(tmp_path):
    spec = {'model': 'vit', 'kwargs': dict(
        num_classes=13, num_layers=1, num_heads=2, embed_dim=64,
        patch_shape=[8, 8], expand_ratio=2.0, attn_bias=True,
        activation='relu')}
    name = str(_write_spec(tmp_path, spec))
    assert resolve_num_classes(name, None) == 13
    assert resolve_num_classes(name, 4) == 4
    assert resolve_num_classes('vit_ti_patch16', None) == 1000
    model = create_model(name, img_size=IMG, device='cpu')
    assert model.Dense_0.kernel.shape == (64, 13)
    block = model.Encoder_0.EncoderBlock_0
    assert block.FFBlock_0.activation_fn == 'relu' and block.attn_bias
    assert block.FFBlock_0.Dense_0.kernel.shape == (64, 128)
    model = create_model(name, num_classes=4, img_size=IMG, device='cpu')
    assert model.Dense_0.kernel.shape == (64, 4)       # a given width wins


@pytest.mark.parametrize('spec,error,match', [
    ({'model': 'resnet'}, RuntimeError, 'known: botnet, cait'),
    ({'model': 'vit', 'kwargs': {'activation': 'swish'}}, RuntimeError,
     'known: gelu, gelu_exact, relu'),
    ({'model': 'vit', 'kwargs': {'scan_layers': True}}, NotImplementedError,
     'Queue 1 item 1'),
    ({'model': 'cait', 'kwargs': {'activation': 'gelu'}},
     NotImplementedError, 'Queue 1 item 19'),
])
def test_spec_refusals(tmp_path, spec, error, match):
    name = str(_write_spec(tmp_path, spec))
    with pytest.raises(error, match=match):
        create_model(name, img_size=IMG, device='cpu')


def test_spec_refuses_an_unknown_override(tmp_path):
    spec = {'model': 'vit', 'kwargs': dict(
        num_layers=1, num_heads=2, embed_dim=64, patch_shape=[8, 8])}
    name = str(_write_spec(tmp_path, spec))
    with pytest.raises(RuntimeError, match='supported overrides: .*attn_bias'):
        create_model(name, img_size=IMG, device='cpu', num_blocks=3)
    model = create_model(name, img_size=IMG, device='cpu', fused_qkv=True)
    assert model.Encoder_0.EncoderBlock_0.SelfAttentionBlock_0.fused_qkv


# ---- the CLI

def _write_jpegs(directory, n=2):
    from PIL import Image
    directory.mkdir()
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(directory / f'im{i}.jpg', quality=95)
    return directory


def test_cli_import_predict_and_finetune(hf_model, tmp_path, capsys):
    """``import_checkpoint hf`` -> ``predict -m OUT/model.json -c OUT`` ->
    ``train -m OUT --finetune_from OUT`` at another size and head width,
    all on the CPU; the imported checkpoint predicts as the HF model
    does."""
    cfg, model = hf_model
    src, out = tmp_path / 'hf', tmp_path / 'imported'
    model.save_pretrained(src)
    spec = import_checkpoint.main(['hf', str(src), str(out)])
    assert spec == str(out / 'model.json')
    assert sorted(os.listdir(out)) == ['0', 'model.json', 'params.npz']
    capsys.readouterr()
    predict.main(['-m', spec, '-c', str(out), '--images',
                  str(_write_jpegs(tmp_path / 'imgs')), '-s', str(IMG),
                  '--device', 'cpu', '--top_k', '3', '--dtype', 'float32'])
    captured = capsys.readouterr()
    assert 'step 0' in captured.err
    rows = [json.loads(line) for line in captured.out.splitlines()]
    assert len(rows) == 2 and all(len(r['top_k']) == 3 for r in rows)
    assert all(c['class'] < 13 for r in rows for c in r['top_k'])
    ft = tmp_path / 'ft'
    metrics = train_cli.main(['--device', 'cpu', '--data_dir', 'synthetic',
                              '-m', str(out), '--finetune_from', str(out),
                              '-s', '48', '-b', '2', '--total_steps', '2',
                              '--num_classes', '5', '--dtype', 'float32',
                              '-c', str(ft)])
    text = capsys.readouterr().out
    assert 'pos-embed interpolated 17 -> 37 tokens' in text
    assert 'head re-initialised for 5 classes' in text
    assert np.isfinite(metrics['loss']) and 'eval_loss' in metrics
    assert sorted(os.listdir(ft)) == ['2', 'params.npz']


@pytest.mark.parametrize('source', ['timm', 'npz'])
def test_cli_imports_timm_and_npz(timm_state, tmp_path, source):
    model, sd = timm_state
    if source == 'timm':
        src = tmp_path / 'vit.pth'
        torch.save({'state_dict': model.state_dict()}, src)
        argv = ['timm', str(src), str(tmp_path / 'out'), '--num-heads', '4',
                '--ema']
        want = jax_timm.convert_timm_vit(sd, num_heads=4)[0]
    else:
        npz = test_npz_import._make_npz(np.random.default_rng(1))
        src = tmp_path / 'vit.npz'
        np.savez(src, **npz)
        argv = ['npz', str(src), str(tmp_path / 'out')]
        want = jax_npz.convert_vit_npz(npz)[0]
    import_checkpoint.main(argv)
    from sav_tpu_torch.train.checkpoint import CheckpointManager
    restored = CheckpointManager(str(tmp_path / 'out')).restore_for_inference()
    assert restored['step'] == 0
    assert_same_tree(restored['params'], want)
    assert (restored['ema_params'] is not None) == (source == 'timm')


def test_cli_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match='Queue 1 item 1'):
        import_checkpoint.main(['npz', 'x.npz', str(tmp_path),
                                '--scan-layers'])
    with pytest.raises(SystemExit):
        import_checkpoint.main(['hf', str(tmp_path), str(tmp_path),
                                '--num-heads', '4'])


# ---- loss streams

def test_compare_loss_streams(tmp_path):
    a = tmp_path / 'a.log'
    b = tmp_path / 'b.log'
    a.write_text('step 0: loss=6.9078 images_per_sec=12\n'
                 'step 1: loss=6.9 learning_rate=1e-05\n'
                 'step 2: eval_loss=1.5 eval_top_1_acc=0\n'
                 'step 2: loss=6.8\n')
    b.write_text('INFO:absl:step 1: loss=6.9\n'
                 'step 2: loss=6.801 images_per_sec=3\n')
    parsed = compare_loss_streams.parse(str(a))
    assert parsed == {0: 6.9078, 1: 6.9, 2: 6.8}
    assert compare_loss_streams.main([str(a), str(b)]) == 0
    report, code = compare_loss_streams.compare(
        parsed, compare_loss_streams.parse(str(b)), from_step=2)
    assert code == 0 and report.startswith('1 overlapping steps in [2, 2]; '
                                           '0 bit-equal')
    b.write_text('step 2: loss=6.9\n')
    assert compare_loss_streams.main([str(a), str(b)]) == 2
    assert compare_loss_streams.main([str(a), str(b), '--from-step',
                                      '3']) == 1
