"""Torch port: the FF-sublayer backward's launch plan and algebra on the CPU
(``csrc/ff_bwd.cu`` + ``csrc/ff_bwd_sm90.cuh``, K16; the kernels run only
on the card, ``tests/test_torch_cuda.py``).

* ``ff_bwd_plan``, the Python mirror of the C entry ``sav_ff_bwd_plan``:
  128-row tiles cover every row, the weight gradients' split-K chunks
  cover every 64-row step with none empty, the shared memory fits a block
  and the scratch it sizes is what the kernels write (at M = 37,824, the
  rows of ViT-B/16 @224 bs192, at ragged M = 1003 and 129, and at M = 1).
* The geometry the kernels do not take raises ValueError (never asserts).
* ``kernel_algebra``, a test-only torch mirror of the kernels' arithmetic:
  dgact per 128-row tile with the gelu' epilogue, dh and h rounded to bf16,
  the tile's f32 column sums of dh summed tile by tile for db1, dy from
  the bf16 dh, dW1 and dW2 as one f32 partial a chunk of rows summed chunk
  by chunk. Held against ``ff_bwd_plain`` (dy within 2^-8 of max: both are
  bf16 and f32 sums in another order may round to the neighbouring value;
  dW1, dW2, db1 within 1e-5 of max: f32 sums in another order) and against
  the JAX package's ``_ff_bwd_kernel`` (K16) in Pallas interpret mode (there
  dW1 and dW2 within 2^-8 of max too: XLA's f32 tanh on the CPU differs
  from torch's in the last bits for most elements, so an element of the
  bf16 dh or h may round to the neighbouring value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import fused_layer as jax_fl
from sav_tpu_torch.ops import fused_layer as fl

import torch_parity  # noqa: F401  (pins torch to one thread)

SMEM_LIMIT = 232448
ROWS_TOL = 2.0 ** -8
SUM_TOL = 1e-5
VIT_B = (768, 3072)
M_CASES = (37824, 1003, 129, 1)


@pytest.mark.parametrize('m', M_CASES)
def test_plan_covers_every_row(m):
    plan = fl.ff_bwd_plan(m, *VIT_B)
    tile, step = fl.FF_TILE, fl.FF_STEP
    assert (plan['row_tiles'] - 1) * tile < m <= plan['row_tiles'] * tile
    assert (plan['steps'] - 1) * step < m <= plan['steps'] * step
    chunks, per = plan['chunks'], plan['steps_per_chunk']
    assert 1 <= chunks <= fl.FF_MAX_CHUNKS
    # every step in one chunk, the last chunk not empty
    assert (chunks - 1) * per < plan['steps'] <= chunks * per


@pytest.mark.parametrize('m', M_CASES)
def test_plan_units_and_scratch(m):
    dim, hidden = VIT_B
    plan = fl.ff_bwd_plan(m, dim, hidden)
    t, tn = fl.FF_TILE, fl.FF_TILE_N
    assert plan['units'] == {
        'dgact': plan['row_tiles'] * hidden // tn,
        'dy': plan['row_tiles'] * dim // tn,
        'dw': plan['chunks'] * (dim // t * hidden // tn
                                + hidden // t * dim // tn)}
    assert plan['part_floats'] == plan['chunks'] * 2 * dim * hidden
    assert plan['colsum_floats'] == plan['row_tiles'] * hidden
    assert 0 < plan['smem'] <= SMEM_LIMIT


def test_plan_at_vit_b_bs192_fills_the_card_in_rounds():
    """At M = 37,824 the 144 weight-gradient tiles (128 x 256) go in 5
    chunks of 119 steps (the last 115): 720 units, 6 rounds of 132 SMs
    (the last 45% full), against 2 rounds of 591 steps unsplit."""
    plan = fl.ff_bwd_plan(37824, *VIT_B)
    assert (plan['row_tiles'], plan['steps']) == (296, 591)
    assert (plan['chunks'], plan['steps_per_chunk']) == (5, 119)
    assert plan['units'] == {'dgact': 3552, 'dy': 888, 'dw': 720}
    # small M: one chunk, the partial is the gradient
    assert fl.ff_bwd_plan(1003, *VIT_B)['chunks'] == 1
    assert fl.ff_bwd_plan(1, *VIT_B)['steps_per_chunk'] == 1


@pytest.mark.parametrize('sms', [1, 78, 114, 132])
def test_plan_takes_any_card(sms):
    """The SM count moves the split, never the cover."""
    plan = fl.ff_bwd_plan(37824, *VIT_B, sms=sms)
    chunks, per = plan['chunks'], plan['steps_per_chunk']
    assert (chunks - 1) * per < plan['steps'] <= chunks * per


@pytest.mark.parametrize('m,dim,hidden', [(0, 768, 3072), (16, 100, 3072),
                                          (16, 768, 3000), (16, 64, 256),
                                          (16, 0, 256)])
def test_plan_refuses_what_the_kernels_do_not_tile(m, dim, hidden):
    with pytest.raises(ValueError):
        fl.ff_bwd_plan(m, dim, hidden)


def test_wrapper_checks_raise():
    """On a CPU tensor ``ff_bwd`` is the twin; on a device it is not built
    for it raises ValueError before any launch."""
    meta = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device='meta')
    with pytest.raises(ValueError):
        fl.ff_bwd(meta(4, 128), meta(4, 256), meta(4, 128), meta(128, 256),
                  meta(256, 128))


def _case(m, dim, hidden, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: torch.from_numpy(
        (rng.standard_normal(s) * std).astype(np.float32)).bfloat16()
    return (mk(m, dim), mk(m, hidden), mk(m, dim),
            mk(dim, hidden, std=dim ** -0.5),
            mk(hidden, dim, std=hidden ** -0.5))


def kernel_algebra(g2, hpre2, y2, w1, w2, sms=132):
    """The kernels' arithmetic in torch (test only): (dy2, dw1, dw2, db1)
    like ``ff_bwd_plain``."""
    m, dim = g2.shape
    hidden = hpre2.shape[1]
    plan = fl.ff_bwd_plan(m, dim, hidden, sms=sms)
    tile, step = fl.FF_TILE, fl.FF_STEP
    hp = hpre2.float()
    t = torch.tanh(fl._GELU_C * (hp + fl._GELU_A * hp ** 3))
    dh = torch.empty(m, hidden, dtype=g2.dtype)
    h = (0.5 * hp * (1.0 + t)).to(g2.dtype)
    db1 = torch.zeros(hidden)
    for r0 in range(0, m, tile):                    # GELU: row tiles
        rows = slice(r0, min(r0 + tile, m))
        dgact = g2[rows].float() @ w2.float().t()
        dh32 = dgact * fl._gelu_bwd_from_t(hp[rows], t[rows])
        dh[rows] = dh32.to(g2.dtype)
        db1 += dh32.sum(dim=0)                      # the tile's partial
    dy2 = (dh.float() @ w1.float().t()).to(g2.dtype)          # DY
    dw1 = torch.zeros(dim, hidden)
    dw2 = torch.zeros(hidden, dim)
    span = plan['steps_per_chunk'] * step
    for c in range(plan['chunks']):                 # WGRAD: chunk partials
        rows = slice(c * span, min((c + 1) * span, m))
        dw1 += y2[rows].float().t() @ dh[rows].float()
        dw2 += h[rows].float().t() @ g2[rows].float()
    return dy2, dw1, dw2, db1


def _rel(a, b):
    a, b = torch.as_tensor(np.asarray(a, np.float32)), torch.as_tensor(
        np.asarray(b, np.float32))
    return float((a - b).abs().max() / b.abs().max())


def _hold(got, want, tols=(ROWS_TOL, SUM_TOL, SUM_TOL, SUM_TOL)):
    for name, g, w, tol in zip(('dy', 'dw1', 'dw2', 'db1'), got, want, tols):
        g = g.float() if isinstance(g, torch.Tensor) else g
        w = w.float() if isinstance(w, torch.Tensor) else w
        assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.mark.parametrize('m,sms', [(1, 132), (130, 132), (700, 1),
                                   (700, 132), (1003, 132)])
def test_kernel_algebra_matches_twin(m, sms):
    """Ragged row tiles, in one chunk and in several: at D = 128, F = 256
    the 3 weight-gradient tiles (dW2's half past D) leave 132 SMs idle
    unless M is split (700 rows: 4 chunks), while one SM gains nothing from
    a split."""
    args = _case(m, 128, 256, m)
    chunks = fl.ff_bwd_plan(m, 128, 256, sms=sms)['chunks']
    assert (chunks > 1) == (m > fl.FF_STEP and sms == 132)
    _hold(kernel_algebra(*args, sms=sms), fl.ff_bwd_plain(*args))


def test_kernel_algebra_matches_jax_kernel():
    """At M = 300 (a ragged 128-row tile), D = 128, F = 256: the JAX
    package's ``_ff_bwd_pallas`` (K16) in interpret mode on the same bf16
    operands."""
    m, dim, hidden = 300, 128, 256
    args = _case(m, dim, hidden, 7)
    jax_out = jax_fl._ff_bwd_pallas(*(jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16) for a in args))
    want = [torch.from_numpy(np.array(t, np.float32)) for t in jax_out]
    _hold(kernel_algebra(*args), want, (ROWS_TOL,) * 3 + (SUM_TOL,))
