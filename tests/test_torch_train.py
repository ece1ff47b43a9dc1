"""Torch port training: the optimizer chain and schedules against optax (via
``sav_tpu.train.state``), ``train_step``/``eval_step`` against
``sav_tpu.train.steps`` from one flax tree, top-k metrics, the synthetic
source, and the training CLI end to end on the CPU (its checkpoint read
back by the predict CLI, and resumed by a second run).

float32. Tolerances: parameters and moments atol 1e-6 after 5 optimizer
steps (updates of size ~lr = 1e-3, f32 math in another order); schedule
values rtol 1e-6 (optax in f32, the port in f64); losses and metrics atol
1e-5; parameters after 3 train steps atol 1e-5 (gradients of a 2-layer
model agree to ~1e-6, Adam normalises them to steps of ~lr). The train-step
comparison runs Adam with eps 1e-3: Adam divides by |g| + eps, so at the
default 1e-8 an element whose gradient is numerically zero (~1e-9) steps by
~lr in a direction set by rounding noise. The chain at the default eps is
compared with optax on its own above.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu.utils.metrics import topk_correct as jax_topk_correct
from sav_tpu_torch import predict
from sav_tpu_torch.data.synthetic import SyntheticDataset
from sav_tpu_torch.train import __main__ as train_cli
from sav_tpu_torch.train import loop, state, steps
from sav_tpu_torch.utils.flax_bridge import flatten_tree, torch_to_flax
from sav_tpu_torch.utils.metrics import topk_correct
from torch_parity import NUM_CLASSES, jax_vit, torch_vit

IMG = 32
STEP_EPS = 1e-3     # Adam eps of the train-step comparison (see above)


class Leaves(torch.nn.Module):
    """A parameter tree as a module (named_parameters = the tree's keys)."""

    def __init__(self, tree):
        super().__init__()
        for name, value in tree.items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.from_numpy(value.copy())))


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {'a': rng.standard_normal((3, 4)).astype(np.float32),
            'b': rng.standard_normal((5,)).astype(np.float32)}


def _grads(step, scale):
    g = _tree(100 + step)
    return {k: v * scale for k, v in g.items()}


OPT_CASES = {
    'plain': dict(kw={}, scales=[1.0] * 5),
    'clip': dict(kw={'clip_grad': 1.0}, scales=[1.0, 0.01, 2.0, 0.05, 1.0]),
    'mu_bf16': dict(kw={'mu_dtype': 'bfloat16'}, scales=[1.0] * 5),
    'cosine': dict(kw={}, scales=[1.0] * 5, schedule='cosine'),
    'wsd': dict(kw={}, scales=[1.0] * 5, schedule='wsd'),
    'ema': dict(kw={}, scales=[1.0] * 5, ema=0.9),
}


def _schedules(kind):
    """(port schedule, optax schedule) of one family at small step counts."""
    if kind == 'cosine':
        args = (1e-3, 1024, 1, 2, 4)        # peak 2e-3, warmup 2, decay 4
        return (state.warmup_cosine_schedule(*args),
                jax_state.warmup_cosine_schedule(*args))
    args = (2e-3, 8, 2, 3)                  # warmup 2, plateau 3, decay 3
    return (state.warmup_stable_decay_schedule(*args),
            jax_state.warmup_stable_decay_schedule(*args))


@pytest.mark.parametrize('case', sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    spec = OPT_CASES[case]
    lr = 1e-3
    jax_lr = lr
    if 'schedule' in spec:
        lr, jax_lr = _schedules(spec['schedule'])
    tx = jax_state.build_optimizer(jax_lr, **spec['kw'])
    jstate = jax_state.TrainState.create({'params': _tree()}, tx,
                                         ema='ema' in spec)
    model = Leaves(_tree())
    ours = state.TrainState(model,
                            state.build_optimizer(model.parameters(), lr,
                                                  **spec['kw']),
                            ema='ema' in spec)
    for i, scale in enumerate(spec['scales']):
        g = _grads(i, scale)
        jstate = jstate.apply_gradients(
            tx, {k: jnp.asarray(v) for k, v in g.items()},
            ema_decay=spec.get('ema'))
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[name])
        ours.apply_gradients(spec.get('ema'))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jstate.params[name]),
                                       atol=1e-6, rtol=0, err_msg=f'{i} {name}')
            if 'ema' in spec:
                np.testing.assert_allclose(
                    ours.ema_params[name].numpy(),
                    np.asarray(jstate.ema_params[name]), atol=1e-6, rtol=0)
    adam = next(s for s in jstate.opt_state if hasattr(s, 'mu'))
    for name, p in model.named_parameters():
        mu = ours.optimizer.state[p]['mu']
        want_dtype = torch.bfloat16 if case == 'mu_bf16' else torch.float32
        assert mu.dtype == want_dtype
        np.testing.assert_allclose(mu.float().numpy(),
                                   np.asarray(adam.mu[name], np.float32),
                                   atol=1e-6, rtol=0)
    if 'schedule' in spec:      # warmup from 0: the first update is zero
        first = Leaves(_tree())
        opt = state.build_optimizer(first.parameters(), lr)
        for name, p in first.named_parameters():
            p.grad = torch.from_numpy(_grads(0, 1.0)[name])
        opt.step()
        for name, p in first.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), _tree()[name])


@pytest.mark.parametrize('kind', ['cosine', 'wsd'])
def test_schedules_match_optax(kind):
    ours, want = _schedules(kind)
    for count in range(14):
        np.testing.assert_allclose(ours(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))


def _batch(i, n=4, mask=False):
    rng = np.random.RandomState(10 + i)
    batch = {'images': rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32),
             'labels': rng.randint(0, NUM_CLASSES, (n,)).astype(np.int32)}
    if mask:
        batch['mask'] = np.array([1, 1, 1, 0], np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == 'labels' else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_train(use_kernel, grad_accum):
    model, params = jax_vit(IMG, use_kernel=use_kernel)
    tx = jax_state.build_optimizer(1e-3, eps=STEP_EPS)
    jstate = jax_state.TrainState.create({'params': params}, tx)
    step = jax.jit(functools.partial(
        jax_steps.train_step, model=model, tx=tx, num_classes=NUM_CLASSES,
        label_smoothing=0.1, grad_accum=grad_accum))
    metrics = []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        jstate, m = step(jstate, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, metrics, flatten_tree(jax.tree_util.tree_map(
        np.asarray, jstate.params))


@pytest.mark.parametrize('use_kernel,grad_accum', [
    (False, 1), ('fused_layer_full', 1), (False, 2)])
def test_train_step_matches_jax(use_kernel, grad_accum):
    params, want_metrics, want_params = _jax_train(use_kernel, grad_accum)
    model = torch_vit(params, IMG, use_kernel=use_kernel)
    ts = state.TrainState(model, state.build_optimizer(
        model.parameters(), 1e-3, eps=STEP_EPS))
    for i in range(3):
        m = steps.train_step(ts, _torch_batch(_batch(i)),
                             num_classes=NUM_CLASSES, label_smoothing=0.1,
                             grad_accum=grad_accum)
        assert sorted(m) == sorted(want_metrics[i])
        for k, v in m.items():
            np.testing.assert_allclose(float(v), want_metrics[i][k],
                                       atol=1e-5, rtol=0, err_msg=f'{i} {k}')
    ours = flatten_tree(torch_to_flax(model.state_dict()))
    assert sorted(ours) == sorted(want_params)
    for k in ours:
        np.testing.assert_allclose(ours[k], want_params[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    assert ts.step == 3


def test_eval_step_sums_match_jax():
    model, params = jax_vit(IMG, use_kernel=False)
    tx = jax_state.build_optimizer(1e-3)
    batch = _batch(7, mask=True)
    want = jax_steps.eval_step(
        jax_state.TrainState.create({'params': params}, tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, model=model,
        num_classes=NUM_CLASSES)
    tmodel = torch_vit(params, IMG, use_kernel=False)
    ours = steps.eval_step(state.TrainState(tmodel, state.build_optimizer(
        tmodel.parameters(), 1e-3)), _torch_batch(batch),
        num_classes=NUM_CLASSES)
    assert sorted(ours) == sorted(want)
    for k in ours:
        np.testing.assert_allclose(float(ours[k]), float(want[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_blended_targets_and_topk_match_jax():
    rng = np.random.RandomState(3)
    batch = {'labels': rng.randint(0, 7, (6,)).astype(np.int32),
             'mix_labels': rng.randint(0, 7, (6,)).astype(np.int32),
             'ratio': rng.uniform(size=(6,)).astype(np.float32)}
    want = jax_steps.blended_targets({k: jnp.asarray(v) for k, v in batch.items()},
                                     7, 0.1)
    ours = steps.blended_targets(_torch_batch(batch), 7, 0.1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=1e-7)
    logits = rng.standard_normal((6, 3)).astype(np.float32)     # k > classes
    labels = rng.randint(0, 3, (6,))
    want = jax_topk_correct(jnp.asarray(logits), jnp.asarray(labels),
                            prefix='p_')
    ours = topk_correct(torch.from_numpy(logits), torch.from_numpy(labels),
                        prefix='p_')
    assert sorted(ours) == sorted(want) == ['p_top_1_acc', 'p_top_5_acc']
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(want[k]))


def test_synthetic_source_is_seeded_and_shaped():
    a = SyntheticDataset(3, 8, num_classes=5, seed=1)
    b = SyntheticDataset(3, 8, num_classes=5, seed=1)
    x, y = a.batch(2), b.batch(2)
    assert x['images'].shape == (3, 8, 8, 3) and x['labels'].shape == (3,)
    assert torch.equal(x['images'], y['images'])
    assert torch.equal(x['labels'], y['labels'])
    assert not torch.equal(a.batch(3)['images'], x['images'])
    assert 0 <= float(x['images'].min()) and float(x['images'].max()) < 1
    assert int(x['labels'].max()) < 5


def _write_jpegs(tmp_path):
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (40, 48, 3), dtype=np.uint8)).save(
            img_dir / f'im{i}.jpg', quality=95)
    return img_dir


def test_cli_trains_and_predict_reads_its_checkpoint(tmp_path, capsys):
    ckpt = tmp_path / 'ck'
    metrics = train_cli.main(['--device', 'cpu', '--data_dir', 'synthetic',
                              '-m', 'vit_ti_patch16', '-s', '32', '-b', '4',
                              '--total_steps', '2', '-c', str(ckpt)])
    out = capsys.readouterr().out
    assert 'step 0:' in out and 'final metrics' in out
    assert np.isfinite(metrics['loss']) and 'eval_loss' in metrics
    assert (ckpt / 'params.npz').exists()
    predict.main(['-m', 'vit_ti_patch16', '-c', str(ckpt), '--images',
                  str(_write_jpegs(tmp_path)), '-s', '32', '--device', 'cpu',
                  '--top_k', '2'])
    captured = capsys.readouterr()
    assert 'loaded' in captured.err
    assert len(captured.out.splitlines()) == 2
    # the same -c resumes from its step-2 checkpoint and runs on to step 4
    metrics = train_cli.main(['--device', 'cpu', '--data_dir', 'synthetic',
                              '-m', 'vit_ti_patch16', '-s', '32', '-b', '4',
                              '--total_steps', '4', '-c', str(ckpt)])
    out = capsys.readouterr().out
    assert 'restoring checkpoint at step 2' in out
    assert 'step 2:' not in out and 'step 3:' in out
    assert np.isfinite(metrics['loss'])
    assert sorted(os.listdir(ckpt)) == ['2', '4', 'params.npz']


def test_cli_trains_with_switchback(tmp_path, capsys):
    """``--quantized ff_sb`` (refused until K14 was ported) trains: every
    FF sublayer of the model is the SwitchBack span, and two steps end
    finite on the CPU (the kernels' twins)."""
    from sav_tpu_torch.ops import int8_ff
    ckpt = tmp_path / 'ck'
    config = loop.TrainConfig(model_name='vit_ti_patch16', img_size=32,
                              batch_size=4, quantized='ff_sb',
                              checkpoint_dir=str(ckpt))
    model = loop.Trainer(config, device='cpu').model
    blocks = [getattr(model.Encoder_0, f'EncoderBlock_{i}') for i in range(12)]
    assert all(b.quantized == 'ff_sb' for b in blocks)
    from sav_tpu_torch.models import vit
    assert vit.INT8_FF_SUBLAYER['ff_sb'] is int8_ff.int8_ff_sublayer_sb
    metrics = train_cli.main(['--device', 'cpu', '--data_dir', 'synthetic',
                              '-m', 'vit_ti_patch16', '-s', '32', '-b', '4',
                              '--total_steps', '2', '--quantized', 'ff_sb',
                              '-c', str(ckpt)])
    assert 'final metrics' in capsys.readouterr().out
    assert np.isfinite(metrics['loss']) and np.isfinite(metrics['eval_loss'])


@pytest.mark.parametrize('flag', [
    ['--prefetch_chunks', '3'], ['--model_parallelism', '2'],
    ['--scan_layers'], ['--remat', 'full'], ['--pipeline_parallelism', '2'],
    ['--steps_per_dispatch', '4'], ['--pipeline_microbatches', '8']])
def test_cli_refuses_unported_flags(tmp_path, flag):
    argv = ['--device', 'cpu', '--data_dir', 'synthetic', '-m',
            'vit_ti_patch16', '-c', str(tmp_path)] + flag
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        train_cli.main(argv)


def test_logger_warns_without_wandb(monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'wandb', None)
    with pytest.warns(UserWarning, match='wandb'):
        loop.MetricLogger(use_wandb=True)


def test_model_refuses_dropout():
    from sav_tpu_torch.models import create_model
    with pytest.raises(NotImplementedError, match='dropout'):
        create_model('vit_ti_patch16', device='cpu', num_layers=1,
                     dropout_rate=0.1)
