"""Torch port: CaiT training. Three ``train_step``s from one flax tree
against ``sav_tpu.train.steps`` at stochastic-depth rate 0 (per-op path,
the talking-heads span, gradient accumulation); the stochastic-depth
stream of ``train_step`` and the Trainer (seeded from the config seed and
the step, different noise per microbatch); and the CLIs end to end on a
CaiT name on the CPU.

float32. Tolerances as in test_torch_train.py (slice 2): losses, metrics
and parameters after 3 steps atol 1e-5, Adam eps 1e-3 for the comparison
(see there why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu_torch import predict
from sav_tpu_torch.models import create_model
from sav_tpu_torch.nn.regularization import StochasticDepthBlock
from sav_tpu_torch.train import __main__ as train_cli
from sav_tpu_torch.train import loop, state, steps
from sav_tpu_torch.utils.flax_bridge import flatten_tree, torch_to_flax
from torch_parity import NUM_CLASSES, jax_cait, torch_cait

IMG = 32
STEP_EPS = 1e-3


def _batch(i, n=4):
    rng = np.random.RandomState(20 + i)
    return {'images': rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32),
            'labels': rng.randint(0, NUM_CLASSES, (n,)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == 'labels' else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_train(use_kernel, grad_accum):
    model, params = jax_cait(IMG, use_kernel=use_kernel)
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
    (False, 1), ('fused_th', 1), ('fused_th_xla', 2)])
def test_train_step_matches_jax(use_kernel, grad_accum):
    jax_kernel = False if use_kernel == 'fused_th_xla' else use_kernel
    params, want_metrics, want_params = _jax_train(jax_kernel, grad_accum)
    model = torch_cait(params, IMG, use_kernel=use_kernel)
    ts = state.TrainState(model, state.build_optimizer(
        model.parameters(), 1e-3, eps=STEP_EPS))
    for i in range(3):
        m = steps.train_step(ts, _torch_batch(_batch(i)),
                             num_classes=NUM_CLASSES, label_smoothing=0.1,
                             grad_accum=grad_accum,
                             generator=torch.Generator().manual_seed(i))
        assert sorted(m) == sorted(want_metrics[i])
        for k, v in m.items():
            np.testing.assert_allclose(float(v), want_metrics[i][k],
                                       atol=1e-5, rtol=0, err_msg=f'{i} {k}')
    ours = flatten_tree(torch_to_flax(model.state_dict()))
    assert sorted(ours) == sorted(want_params)
    for k in ours:
        np.testing.assert_allclose(ours[k], want_params[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def _masks(model, run):
    """Per-sample keep masks each StochasticDepthBlock drew during ``run``."""
    drawn = []

    def hook(module, args, out):
        x = args[0]
        keep = (out.reshape(len(out), -1).abs().sum(1) > 0)
        if module.training and module.drop_rate:
            drawn.append(keep & (x.reshape(len(x), -1).abs().sum(1) > 0))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, StochasticDepthBlock)]
    run()
    for h in handles:
        h.remove()
    return drawn


def _sd_model():
    return create_model('cait_xxs_24', num_classes=NUM_CLASSES, device='cpu',
                        img_size=IMG, num_layers=2, num_layers_token_only=1,
                        embed_dim=64, num_heads=4, stoch_depth_rate=0.5,
                        use_kernel='fused_th_xla')


def _sd_step(model, batch, seed, grad_accum=1):
    ts = state.TrainState(model, state.build_optimizer(model.parameters(), 0.0))
    return steps.train_step(ts, batch, num_classes=NUM_CLASSES,
                            label_smoothing=0.0, grad_accum=grad_accum,
                            generator=torch.Generator().manual_seed(seed))


def test_stochastic_depth_stream_per_microbatch():
    """Two identical microbatches under grad_accum draw different masks;
    the same seed draws the same masks again; no generator raises."""
    half = _batch(0, n=8)
    batch = _torch_batch({k: np.concatenate([v, v]) for k, v in half.items()})
    model = _sd_model()
    first = _masks(model, lambda: _sd_step(model, batch, 5, grad_accum=2))
    again = _masks(model, lambda: _sd_step(model, batch, 5, grad_accum=2))
    assert len(first) == 12                  # 6 blocks x 2 microbatches
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert any(not torch.equal(a, b) for a, b in zip(first[:6], first[6:]))
    assert any(not bool(m.all()) for m in first)     # rate 0.5 drops some
    with pytest.raises(RuntimeError, match='Generator'):
        steps.train_step(state.TrainState(model, state.build_optimizer(
            model.parameters(), 0.0)), batch, num_classes=NUM_CLASSES,
            label_smoothing=0.0)
    assert all(m.generator is None for m in model.modules()
               if isinstance(m, StochasticDepthBlock))


def test_trainer_seeds_the_stream_from_seed_and_step():
    assert loop.stochastic_depth_seed(42, 0) != loop.stochastic_depth_seed(42, 1)
    assert loop.stochastic_depth_seed(42, 1) != loop.stochastic_depth_seed(43, 1)
    config = loop.TrainConfig(model_name='cait_xxs_24', img_size=IMG,
                              batch_size=4, seed=1, dtype='float32',
                              total_steps=2, num_classes=NUM_CLASSES)
    losses = []
    for _ in range(2):
        trainer = loop.Trainer(config, device='cpu')
        assert trainer.generator.device.type == 'cpu'
        data = trainer.dataset()
        losses.append([float(trainer.train_step(data.batch(i))['loss'])
                       for i in range(2)])
    assert losses[0] == losses[1]


def test_cli_trains_cait_and_predict_reads_its_checkpoint(tmp_path, capsys):
    ckpt = tmp_path / 'ck'
    metrics = train_cli.main(['--device', 'cpu', '--data_dir', 'synthetic',
                              '-m', 'cait_xxs_24', '-s', '32', '-b', '2',
                              '--total_steps', '2', '--eval_batches', '1',
                              '--num_classes', '10', '-c', str(ckpt)])
    assert np.isfinite(metrics['loss']) and 'eval_loss' in metrics
    assert (ckpt / 'params.npz').exists()
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    from PIL import Image
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (40, 48, 3), dtype=np.uint8)).save(img_dir / 'a.jpg')
    capsys.readouterr()
    predict.main(['-m', 'cait_xxs_24', '-c', str(ckpt), '--images',
                  str(img_dir), '-s', '32', '--device', 'cpu', '--top_k', '2',
                  '--num_classes', '10'])
    captured = capsys.readouterr()
    assert 'loaded' in captured.err and len(captured.out.splitlines()) == 1
