"""Torch port at CaiT-XS's geometry (6 heads of 48, D = 288, F = 1152:
``cait_xs_24``, ``cait_xs_36``) against sav_tpu from the same numpy inputs,
float32:

* the talking-heads span ``th_attention_sublayer`` at B = 2, L = 37, D =
  96, H = 6 (d = 48), forward and all nine gradients, on each of the
  port's routes (on the CPU each route runs its kernels' plain twins):
  against the JAX span in Pallas interpret mode (its fused kernel K5,
  ``_th_fwd_kernel`` and ``_th_bwd_kernel``, once, shared by the three
  routes) and against its jnp twin ``th_sublayer_reference`` with and
  without the residual;
* a cait_xs-shaped CaiT (D = 288, 6 heads, 2 body + 1 class-attention
  layers, 64 px: 16 patches) from one flax tree: logits for every
  ``use_kernel`` the port takes against the JAX model's per-op path and
  its 'fused_th' route (interpret mode), three ``train_step``s against
  ``sav_tpu.train.steps`` on the per-op path and the span, and the int8
  routes ``quantized='ff'`` (K12's twin), ``'ff_sb'`` and ``'all'`` (K11's
  and K12's twins) against the JAX model's (K14's twin, 'ff_sb''s
  backward, is held at D = 288 through its algebra below and against the
  JAX kernel in ``test_torch_switchback.py``);
* the launch plans at cait_xs's shapes, whose counts are ceilings where
  288 is not a whole number of tiles: K6a's and K6b's 5 boxes of 64
  columns, K11's 5 column tiles an output and 5 slots a contraction,
  K12's 3 OUT tiles (no pairs) and 5 x 18 transpose tiles, K14's 3 DY
  tiles; test-only torch mirrors of what the kernels do at those ragged
  edges (K11's QKV column tiles, K12's masked codes transpose) and the
  int8 kernels' algebra (``test_torch_int8_ff_plan.py``,
  ``test_torch_int8_dx_plan.py``) at D = 288 against the twins, bit for
  bit.

Tolerances as the files they extend: the span's forward atol 2e-5 and
each gradient within 5e-4 of its max |grad| (``test_torch_th_attention.py``);
logits atol 1e-4 (``test_torch_cait.py``); losses, metrics and parameters
after 3 steps atol 1e-5 with Adam eps 1e-3 (``test_torch_cait_train.py``);
the int8 routes' logits within 1e-4 of max |logit| and at least 10x that
from the unquantized model (``test_torch_int8_models.py``; image by
image, one flipped code allowed: ``test_int8_logits_match_jax`` says
why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sav_tpu.ops import th_attention as jax_th
from sav_tpu.train import state as jax_state
from sav_tpu.train import steps as jax_steps
from sav_tpu_torch.models import cait
from sav_tpu_torch.ops import int8_ff as tff
from sav_tpu_torch.ops import th_attention as th
from sav_tpu_torch.train import state, steps
from sav_tpu_torch.utils.flax_bridge import flatten_tree, torch_to_flax
from test_torch_int8_dx_plan import _case as dx_case
from test_torch_int8_dx_plan import kernel_algebra as dx_algebra
from test_torch_int8_ff_plan import _case as ff_case
from test_torch_int8_ff_plan import kernel_algebra as ff_algebra
from torch_parity import NUM_CLASSES, fill_body, images, jax_vit, torch_vit

FWD_TOL = 2e-5
GRAD_TOL = 5e-4
LOGIT_TOL = 1e-4
STEP_EPS = 1e-3
SMEM_LIMIT = 232448
NAMES = ('x', 'scale', 'bias', 'wq', 'wk', 'wv', 'wo', 'm_pre', 'm_post')
SPAN = (2, 37, 96, 6)           # B, L, D, H: d = 48, cait_xs's heads
IMG = 64
CAIT_XS = dict(num_layers=2, num_layers_token_only=1, stoch_depth_rate=0.0)
DIM, HIDDEN, HEADS = 288, 1152, 6


def _inputs(seed):
    b, l, dim, heads = SPAN
    d = th.HEAD_CH
    rng = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    ins = (mk(b, l, dim), 1.0 + 0.1 * mk(dim), 0.1 * mk(dim),
           mk(dim, heads, d, std=dim ** -0.5), mk(dim, heads, d, std=dim ** -0.5),
           mk(dim, heads, d, std=dim ** -0.5),
           mk(heads, d, dim, std=(heads * d) ** -0.5),
           np.eye(heads, dtype=np.float32) + 0.2 * mk(heads, heads),
           np.eye(heads, dtype=np.float32) + 0.2 * mk(heads, heads))
    return ins, mk(b, l, dim, std=1.0 / np.sqrt(l))        # cotangent


@functools.lru_cache(maxsize=None)
def _jax(fn, residual=False, seed=0):
    """(out, nine gradients) of the JAX span ('kernel') or its twin."""
    ins, g = _inputs(seed)
    heads = SPAN[3]
    if fn == 'kernel':
        f = lambda *a: jax_th.th_attention_sublayer(*a, heads, jax_th.LN_EPS,
                                                    residual)
    else:
        f = lambda *a: jax_th.th_sublayer_reference(*a, residual=residual)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _port(route, residual=False, seed=0):
    ins, g = _inputs(seed)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = th.th_attention_sublayer(*ts, SPAN[3], th.LN_EPS, residual, route)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


def _check(port, want):
    np.testing.assert_allclose(port[0], want[0], atol=FWD_TOL, rtol=0)
    for name, ours, ref in zip(NAMES, port[1], want[1]):
        assert ours.shape == ref.shape, name
        err = np.abs(ours.astype(np.float64) - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_the_span_shape_is_a_kernel_shape_on_both_sides():
    """The JAX side runs its fused kernel K5 here; the port's kernels are
    built for these heads, and on the card the span takes K5 too (96 and
    cait_xs's 288 are multiples of 32, which the projection GEMMs take
    with a ragged last tile), as at every cait_xs length."""
    b, l, dim, heads = SPAN
    assert jax_th.th_mode(l, heads, th.HEAD_CH) == 'fused'
    assert th.kernel_supported(heads, th.HEAD_CH)
    for length, width in ((l, dim), (196, DIM), (197, DIM), (576, DIM)):
        assert th.th_route(length, heads, th.HEAD_CH, width,
                           'cuda') == 'fused'
        assert th.fused_fits(length, heads, width)


@pytest.mark.parametrize('route', th.ROUTES)
def test_span_matches_jax_kernel(route):
    _check(_port(route), _jax('kernel'))


@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('route', th.ROUTES)
def test_span_matches_jax_reference(route, residual):
    _check(_port(route, residual, seed=1), _jax('reference', residual, 1))


# ---- the launch plans at cait_xs's shapes: ceilings, not floors

@pytest.mark.parametrize('l', [196, 197, 576, 577])
def test_th_plans_read_the_band_in_five_boxes(l):
    """288 columns are 4.5 boxes of 64: K6a and the fused backward read 5
    (a floor would drop columns 256-287, head 5's last 32), and both fit a
    block's shared memory (the card tests hold these mirrors equal to
    sav_th_core_fwd_smem and sav_th_bwd_smem)."""
    fwd = th.th_fwd_plan(l, HEADS)
    assert fwd['boxes'] * 64 >= HEADS * th.HEAD_CH > (fwd['boxes'] - 1) * 64
    assert fwd['boxes'] == 5
    assert (fwd['group'], fwd['groups'], fwd['halves'], fwd['stages']) == (
        6, 1, 1, 4)
    assert fwd['smem'] == 156784 <= SMEM_LIMIT
    bwd = th.th_bwd_plan(l, HEADS)
    assert bwd['design'] == 'fused' and bwd['boxes'] == 5
    assert bwd['smem'] == {'dq': 178272, 'dk': 177504, 'dv': 177504}
    assert th.th_fwd_split(128, l, HEADS) == 1


@pytest.mark.parametrize('b,l', [(32, 196), (3, 197), (1, 1)])
def test_k11_plan_takes_ragged_tiles_and_slots(b, l):
    """K11 at D = H*48 = 288: each of q, k and v takes 5 column tiles of
    64 (the last 32 wide), each contraction 5 slots of 64 (the last half
    zeros); the core's shared memory is K6a's with the codes' staging rows
    304 bytes apart after its mbarriers."""
    plan = th.th_q8_plan(b, l, DIM, HEADS)
    rows = plan['row_tiles']
    assert plan['units'] == {'qkv': rows * 3 * 5, 'out': rows * 5}
    assert plan['slots'] == {'qkv': 5, 'out': 5}
    core = th.th_fwd_plan(l, HEADS)['smem']
    assert plan['smem']['core'] == -(-(core - 1024) // 16) * 16 \
        + 64 * (DIM + 16) + 1024 == 176240
    for what in ('qkv', 'out', 'core'):
        assert plan['smem'][what] <= SMEM_LIMIT


def _col_tile(n_each, ct, tile=th.Q8_TILE):
    """``q8g::col_tile`` of ``csrc/q8_gemm_sm90.cuh`` for QKV: (output,
    first column there, first row of B)."""
    per = -(-n_each // tile)
    which = ct // per
    ocol0 = (ct - which * per) * tile
    return which, ocol0, which * n_each + ocol0


def test_k11_qkv_tiles_store_each_column_once_from_its_own_weights():
    """A test-only mirror of K11's QKV GEMM at cait_xs's width: each unit's
    64 columns are the product with the 64 B rows from ``bcol`` (for q's
    and k's last tile, 32 of them are the next output's first rows; past
    v's, zeros), stored up to the output's 288 columns (the TMA store
    clips) with the column scales read only below 288: every column of q,
    k and v is stored once, and equals the plain product."""
    rng = np.random.RandomState(5)
    m, hd = 6, DIM
    yq = rng.randint(-127, 128, (m, DIM)).astype(np.int64)
    wt = rng.randint(-127, 128, (3 * hd, DIM)).astype(np.int64)   # [3 H*48, D]
    scales = rng.uniform(0.5, 1.5, (3, hd))
    want = [yq @ wt[i * hd:(i + 1) * hd].T * scales[i] for i in range(3)]
    got = [np.full((m, hd), np.nan) for _ in range(3)]
    nt = 3 * -(-hd // th.Q8_TILE)
    assert nt == th.th_q8_plan(1, m, DIM, HEADS)['units']['qkv']
    b_pad = np.concatenate([wt, np.zeros((th.Q8_TILE, DIM), np.int64)])
    for ct in range(nt):
        which, ocol0, bcol = _col_tile(hd, ct)
        acc = yq @ b_pad[bcol:bcol + th.Q8_TILE].T
        cols = np.arange(ocol0, ocol0 + th.Q8_TILE)
        keep = cols < hd
        assert np.isnan(got[which][:, cols[keep]]).all()   # stored once
        got[which][:, cols[keep]] = acc[:, keep] * scales[which][cols[keep]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('m', [6272, 25088, 1003])
def test_int8_ff_plans_take_the_ragged_width(m):
    """K12/K13 and K14 at D = 288, F = 1152: OUT and DY take 3 column tiles
    of 128 (the last 32 wide), so OUT runs no pair units; the first
    products 5 slots of 64 codes over D (the last half zeros), the second
    9 of 128 over F; each weight's codes transpose 5 x 18 tiles."""
    ff = tff.int8_ff_plan(m, DIM, HIDDEN)
    assert ff['col_tiles'] == {'hidden': 9, 'out': 3}
    assert ff['out_pairs'] is False
    assert ff['stages'] == {'hidden': 5, 'out': 9}
    assert ff['transposes'] == 5 * 18
    assert ff['smem'] <= SMEM_LIMIT
    dx = tff.int8_dx_plan(m, DIM, HIDDEN)
    assert dx['col_tiles'] == {'dh': 9, 'dy': 3}
    assert dx['stages'] == {'dh': 5, 'dy': 9}
    assert dx['units']['dy'] == dx['row_tiles'] * 3


def transpose_algebra(w):
    """``transpose_codes_kernel`` in torch (test only): out[c][r] = w[r][c]
    for [rows, cols] codes (multiples of 4), a block a 64 x 64 tile over
    the ceiling count of tiles, words of 4 codes read only below the edges
    and written only below them; the rest of out keeps a sentinel."""
    rows, cols = w.shape
    ct = -(-cols // 64)
    out = torch.full((cols, rows), -128, dtype=torch.int8)
    for blk in range(-(-rows // 64) * ct):
        r0, c0 = blk // ct * 64, blk % ct * 64
        tile = torch.zeros(64, 64, dtype=torch.int8)
        for tx in range(16):                # word tx of each row: 4 codes
            if c0 + 4 * tx >= cols:
                continue
            rr = min(64, rows - r0)
            tile[:rr, 4 * tx:4 * tx + 4] = w[r0:r0 + rr, c0 + 4 * tx:c0 + 4 * tx + 4]
        for tx in range(16):                # out's codes r0 + 4 tx ..
            if r0 + 4 * tx >= rows:
                continue
            for c in range(64):
                if c0 + c >= cols:
                    break
                out[c0 + c, r0 + 4 * tx:r0 + 4 * tx + 4] = tile[4 * tx:4 * tx + 4, c]
    return out


@pytest.mark.parametrize('rows,cols', [(DIM, HIDDEN), (HIDDEN, DIM), (96, 160)])
def test_codes_transpose_writes_every_code_once(rows, cols):
    """At D = 288 (a ragged fifth tile) the transpose writes W1's [D, F]
    and W2's [F, D] codes whole, and nothing else of the [cols, rows]
    output (a floor count of tiles left W1's last 32 rows of codes
    unwritten)."""
    rng = np.random.RandomState(rows + cols)
    w = torch.from_numpy(rng.randint(-127, 128, (rows, cols)).astype(np.int8))
    assert torch.equal(transpose_algebra(w), w.t())


@pytest.mark.parametrize('ln', [False, True])
def test_int8_ff_algebra_at_288_is_the_twin_bit_for_bit(ln):
    """K12's and K13's tile algebra at D = 288, F = 1152 (OUT's last tile
    32 columns wide, the first product's last slot half zeros) against the
    twins, with and without hpre."""
    x, lnp, w = ff_case(50, DIM, HIDDEN, 3 + ln)
    lnp = lnp if ln else None
    out, hpre, hq = ff_algebra(x, lnp, *w)[:3]
    if lnp is None:
        want = tff.int8_ff_reference(x, *w, save_hpre=True)
    else:
        want = tff.int8_ff_ln_reference(x, *lnp, *w, save_hpre=True)
    assert out.shape == (50, DIM)
    assert torch.equal(hpre, want[1])
    assert torch.equal(out, want[0])
    assert torch.equal(out[:, 256:], want[0][:, 256:])   # the ragged tile


def test_int8_dx_algebra_at_288_is_the_twin_bit_for_bit():
    """K14's tile algebra at D = 288, F = 1152 (DY's last tile 32 columns
    wide, the first product's last slot half zeros) against its twin."""
    args = dx_case(50, DIM, HIDDEN, 11)
    dy2, dh = dx_algebra(*args)[:2]
    want_dy2, want_dh = tff.int8_ff_dx_reference(*args)
    assert dy2.shape == (50, DIM)
    assert torch.equal(dh, want_dh)
    assert torch.equal(dy2, want_dy2)


# ---- a cait_xs-shaped CaiT at depth 2

@functools.lru_cache(maxsize=None)
def _jax_model(use_kernel=False, quantized=False):
    """The flax model and its tree: head, LayerScale and LayerNorms filled
    (``fill_body``), the head then scaled by 1/20 so that the logits are
    O(1) and the loss near ln 10, as in training."""
    model, params = jax_vit(IMG, name='cait_xs_24', overrides=CAIT_XS,
                            use_kernel=use_kernel, quantized=quantized)
    params = fill_body(params)
    params['Dense_0']['kernel'] = params['Dense_0']['kernel'] / 20
    params['Dense_0']['bias'] = params['Dense_0']['bias'] / 20
    return model, params


@functools.lru_cache(maxsize=None)
def _jax_logits(use_kernel, quantized=False, n=2):
    model, _ = _jax_model(use_kernel, quantized)
    _, params = _jax_model(False)                  # one tree for all
    return np.asarray(jax.jit(model.apply, static_argnames='is_training')(
        {'params': params}, jnp.asarray(images(n, IMG)), is_training=False))


def test_the_model_is_cait_xs_shaped():
    _, params = _jax_model()
    model = torch_vit(params, IMG, name='cait_xs_24', overrides=CAIT_XS)
    block = model.Encoder_0.EncoderBlock_0
    assert block.num_heads == 6 and model.cls.shape == (1, 1, DIM)
    attn = block.SelfAttentionBlock_0
    assert tuple(attn.queries.kernel.shape) == (DIM, 6, th.HEAD_CH)
    assert tuple(attn.TalkingHeadsBlock_0.talking_heads_transform.shape) == (
        6, 6)
    assert block.th_route(torch.zeros(1, 196, DIM)) is None   # off the card


@pytest.mark.parametrize('jax_kernel', [False, 'fused_th'])
@pytest.mark.parametrize('use_kernel', cait.USE_KERNEL)
def test_logits_match_jax(use_kernel, jax_kernel):
    _, params = _jax_model()
    model = torch_vit(params, IMG, name='cait_xs_24', overrides=CAIT_XS,
                      use_kernel=use_kernel)
    with torch.no_grad():
        logits = model(torch.from_numpy(images(2, IMG)))
    assert logits.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(logits.numpy(), _jax_logits(jax_kernel),
                               atol=LOGIT_TOL, rtol=0)


# (JAX use_kernel, port use_kernel) of each int8 route, as the JAX package
# runs it: 'all' takes the span (K11) where th_supported holds
INT8 = {'ff': (False, False), 'ff_sb': (False, False),
        'all': ('fused_th', 'fused_th')}


@pytest.mark.parametrize('quantized', sorted(INT8))
def test_int8_logits_match_jax(quantized):
    """Each image's logits against the JAX model's, over that image's max
    |logit|. The two packages take LayerNorm's and the softmax's f32 sums
    in other orders, so a value within an ulp of a .5 code boundary takes
    the other code in one of them (``test_torch_th_q8.py``); at this
    width (~10^5 codes a forward of 4 images) that happens about once a
    forward, and one flipped code moves its image's logits by 1.4e-4 to
    5.1e-4 (the readings over two draws of 4 images, the other images
    1e-6). So at least 3 of the 4 images are held to 1e-4, each to 10x
    that (one flip), and the route must move the logits by at least 10x
    1e-4 from the unquantized model: a route that ran unquantized moves
    every image by 7e-4 or more and fails the first bar."""
    jax_kernel, use_kernel = INT8[quantized]
    _, params = _jax_model()
    want = _jax_logits(jax_kernel, quantized, 4)

    def ours(q):
        model = torch_vit(params, IMG, name='cait_xs_24', overrides=CAIT_XS,
                          use_kernel=use_kernel, quantized=q)
        with torch.no_grad():
            return model(torch.from_numpy(images(4, IMG))).numpy()

    scale = np.abs(want).max(axis=1)
    err = np.abs(ours(quantized) - want).max(axis=1) / scale
    moved = np.abs(ours(False) - want).max() / np.abs(want).max()
    assert (err <= LOGIT_TOL).sum() >= 3 and (err <= 10 * LOGIT_TOL).all(), err
    assert moved >= 10 * LOGIT_TOL, moved


def _batch(i, n=4):
    rng = np.random.RandomState(40 + i)
    return {'images': rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32),
            'labels': rng.randint(0, NUM_CLASSES, (n,)).astype(np.int32)}


def _torch_batch(i):
    return {k: torch.from_numpy(v.astype(np.int64) if k == 'labels' else v)
            for k, v in _batch(i).items()}


@functools.lru_cache(maxsize=None)
def _jax_train():
    model, params = _jax_model()
    tx = jax_state.build_optimizer(1e-3, eps=STEP_EPS)
    jstate = jax_state.TrainState.create({'params': params}, tx)
    step = jax.jit(functools.partial(
        jax_steps.train_step, model=model, tx=tx, num_classes=NUM_CLASSES,
        label_smoothing=0.1, grad_accum=1))
    metrics = []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        jstate, m = step(jstate, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))


def _torch_train(use_kernel):
    _, params = _jax_model()
    model = torch_vit(params, IMG, name='cait_xs_24', overrides=CAIT_XS,
                      use_kernel=use_kernel)
    ts = state.TrainState(model, state.build_optimizer(
        model.parameters(), 1e-3, eps=STEP_EPS))
    metrics = [steps.train_step(ts, _torch_batch(i), num_classes=NUM_CLASSES,
                                label_smoothing=0.1,
                                generator=torch.Generator().manual_seed(i))
               for i in range(3)]
    return metrics, flatten_tree(torch_to_flax(model.state_dict()))


@pytest.mark.parametrize('use_kernel', [False, 'fused_th'])
def test_train_step_matches_jax(use_kernel):
    want_metrics, want_params = _jax_train()
    metrics, ours = _torch_train(use_kernel)
    for i, m in enumerate(metrics):
        assert sorted(m) == sorted(want_metrics[i])
        for k, v in m.items():
            np.testing.assert_allclose(float(v), want_metrics[i][k],
                                       atol=1e-5, rtol=0, err_msg=f'{i} {k}')
    assert sorted(ours) == sorted(want_params)
    for k in ours:
        np.testing.assert_allclose(ours[k], want_params[k], atol=1e-5, rtol=0,
                                   err_msg=k)

