"""Shared fixtures of the torch-port parity tests (tests/test_torch_*.py):
one small ViT, CaiT and TNT configuration each, seeded inputs, and the same
flax tree loaded into both packages. Inputs come from numpy so both frameworks see the same
numbers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sav_tpu.models import create_model as jax_create_model
from sav_tpu_torch.models import create_model as torch_create_model
from sav_tpu_torch.utils.flax_bridge import flax_to_torch

torch.set_num_threads(1)

# 2 layers, D=128, H=2, d=64: every K1/K4 shape constraint of the port holds
SMALL = dict(num_layers=2, embed_dim=128, num_heads=2)
NUM_CLASSES = 10
# CaiT: 2 body layers, 1 class-attention layer, D=64, H=4, d=16; rate 0 so
# both packages run the same deterministic function in training mode
CAIT_SMALL = dict(num_layers=2, num_layers_token_only=1, embed_dim=64,
                  num_heads=4, stoch_depth_rate=0.0)


def fill_head(params, seed=1):
    """Random head kernel and cls token (both zero-initialised in ViT, which
    would make every logit 0 and any comparison of them empty)."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    params['Dense_0']['kernel'] = rng.standard_normal(
        params['Dense_0']['kernel'].shape).astype(np.float32)
    params['Dense_0']['bias'] = rng.standard_normal(
        params['Dense_0']['bias'].shape).astype(np.float32)
    params['cls'] = rng.standard_normal(params['cls'].shape).astype(np.float32)
    return params


def jax_vit(img_size, name='vit_ti_patch16', overrides=SMALL, **kwargs):
    """(flax model, params with a filled head) for a small ViT."""
    model = jax_create_model(name, num_classes=NUM_CLASSES, **overrides,
                             **kwargs)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.ones((1, img_size, img_size, 3)),
                           is_training=False)
    return model, fill_head(variables['params'])


def torch_vit(params, img_size, name='vit_ti_patch16', overrides=SMALL,
              **kwargs):
    """The port's model of the same config with ``params`` loaded."""
    model = torch_create_model(name, num_classes=NUM_CLASSES,
                               img_size=img_size, device='cpu', **overrides,
                               **kwargs)
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model.eval()


def images(n, size, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def fill_body(params, seed=2):
    """Every ``LayerScaleBlock_*.layerscale`` drawn from U(0.2, 0.6), and
    every LayerNorm's scale from U(0.5, 1.5) and bias from N(0, 0.1^2). At
    the config's eps (1e-5) each block would add ~1e-5 of its output to the
    residual stream, below any tolerance, so a comparison of logits, losses
    or parameters could not see the body or the class-attention blocks; and
    LayerNorms left at their (1, 0) init could be swapped unseen."""
    rng = np.random.RandomState(seed)

    def fill(tree, in_ln=False):
        for key in sorted(tree):
            shape = np.shape(tree[key])
            if isinstance(tree[key], dict):
                fill(tree[key], key.startswith('LayerNorm_'))
            elif key == 'layerscale':
                tree[key] = rng.uniform(0.2, 0.6, shape).astype(np.float32)
            elif in_ln and key == 'scale':
                tree[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            elif in_ln and key == 'bias':
                tree[key] = 0.1 * rng.standard_normal(shape).astype(np.float32)

    fill(params)
    return params


def jax_cait(img_size, overrides=CAIT_SMALL, **kwargs):
    """(flax model, params with a filled head, LayerScale and LayerNorms)
    for a small CaiT."""
    model, params = jax_vit(img_size, name='cait_xxs_24', overrides=overrides,
                            **kwargs)
    return model, fill_body(params)


def torch_cait(params, img_size, overrides=CAIT_SMALL, **kwargs):
    """The port's CaiT of the same config with ``params`` loaded."""
    return torch_vit(params, img_size, name='cait_xxs_24', overrides=overrides,
                     **kwargs)


# TNT: 2 layers at 32 px with 8 x 8 patches (16 patches, 4 pixel tokens of
# 4 x 4 each), outer D=128 H=2 (d=64: K1's constraints hold), inner D=24
# H=4 (tnt_s_patch16's) or D=40 H=4 (tnt_b_patch16's). Four pixel tokens
# keep the JAX inner kernel's interpret mode, whose unrolled loops grow with
# L^2, at seconds; its 16-token shape is held against the JAX twin in
# test_torch_tnt_inner.py.
TNT_SMALL = dict(num_layers=2, outer_embed_dim=128, outer_num_heads=2,
                 patch_shape=(8, 8))
TNT_NAMES = ('tnt_s_patch16', 'tnt_b_patch16')


def fill_biases(params, seed=3):
    """Every ``bias`` of a Dense (not of a LayerNorm, which ``fill_body``
    fills) drawn from N(0, 0.1^2): zero-initialised biases would let a
    swapped or dropped bias pass unseen."""
    rng = np.random.RandomState(seed)

    def fill(tree, in_ln=False):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                fill(tree[key], key.startswith('LayerNorm_'))
            elif key == 'bias' and not in_ln:
                tree[key] = 0.1 * rng.standard_normal(
                    np.shape(tree[key])).astype(np.float32)

    fill(params)
    return params


@functools.lru_cache(maxsize=None)
def _tnt_params(name, img_size):
    _, params = jax_vit(img_size, name=name, overrides=TNT_SMALL,
                        use_kernel=False)
    head = params['Dense_0']['kernel']
    params['Dense_0']['kernel'] = head / np.sqrt(head.shape[0])
    return fill_biases(fill_body(params))


def jax_tnt(name='tnt_s_patch16', img_size=32, **kwargs):
    """(flax model, params with the head, cls, LayerNorms and biases filled)
    for a small TNT; the params are initialised once per name and size
    (every use_kernel mode has the same tree) and are not to be modified.
    TNT has no final LayerNorm, so its cls features grow over the layers;
    the head kernel is scaled by 1/sqrt(D) (lecun's scale) so the logits
    and the loss stay O(1-10), where f32 resolves the 1e-5 the step tests
    hold them to (a loss of ~65 from the unscaled head is within two ulps
    of it)."""
    model = jax_create_model(name, num_classes=NUM_CLASSES, **TNT_SMALL,
                             **kwargs)
    return model, _tnt_params(name, img_size)


def torch_tnt(params, name='tnt_s_patch16', img_size=32, **kwargs):
    """The port's TNT of the same config with ``params`` loaded."""
    return torch_vit(params, img_size, name=name, overrides=TNT_SMALL,
                     **kwargs)


# BoTNet: botnet_t3's block types at 64 px, one block a stage, 16 initial
# filters, so the BoT stage runs a 4 x 4 grid of 128 channels in 2 heads of
# d = 64 (the K9 port's narrower head width; the JAX kernel takes it).
BOTNET_SMALL = dict(stage_sizes=(1, 1, 1, 1), initial_filters=16,
                    num_heads=2)
BOTNET_IMG = 64


def fill_batchnorm(variables, seed=4):
    """Every BatchNorm's scale from U(0.5, 1.5) and bias from N(0, 0.1^2),
    its running mean from N(0, 0.2^2) and var from U(0.5, 2), and every
    Dense bias from N(0, 0.1^2). BoTNet's last BN of each bottleneck starts
    at scale 0, so at init every block outputs swish(residual) and a
    miswired attention, SE or conv could not reach a logit; a mean of 0 and
    a var of 1 would hide a swapped mean/var or a flipped momentum."""
    rng = np.random.RandomState(seed)

    def fill(tree, kind):
        for key in sorted(tree):
            shape = np.shape(tree[key])
            if isinstance(tree[key], dict):
                fill(tree[key], 'bn' if key.startswith('BatchNorm_')
                     else 'dense' if key.startswith('Dense_') else kind)
            elif kind == 'bn' and key == 'scale':
                tree[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            elif kind == 'bn' and key == 'mean':
                tree[key] = 0.2 * rng.standard_normal(shape).astype(np.float32)
            elif kind == 'bn' and key == 'var':
                tree[key] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
            elif kind in ('bn', 'dense') and key == 'bias':
                tree[key] = 0.1 * rng.standard_normal(shape).astype(np.float32)

    fill(variables['params'], None)
    fill(variables['batch_stats'], None)
    return variables


@functools.lru_cache(maxsize=None)
def _botnet_variables():
    model = jax_create_model('botnet_t3', num_classes=NUM_CLASSES,
                             **BOTNET_SMALL)
    # jitted: the eager init dispatches op by op (~4x slower on this host)
    variables = jax.jit(model.init, static_argnames='is_training')(
        jax.random.PRNGKey(0), jnp.ones((1, BOTNET_IMG, BOTNET_IMG, 3)),
        is_training=False)
    return fill_batchnorm(jax.tree_util.tree_map(np.array, dict(variables)))


def jax_botnet(**kwargs):
    """(flax model, a copy of its filled ``{'params', 'batch_stats'}``) for
    the small BoTNet; the tree is initialised once (every use_kernel mode
    has the same one)."""
    model = jax_create_model('botnet_t3', num_classes=NUM_CLASSES,
                             **BOTNET_SMALL, **kwargs)
    return model, jax.tree_util.tree_map(np.copy, _botnet_variables())


def torch_botnet(variables, **kwargs):
    """The port's small BoTNet with ``variables`` (params and running
    statistics) loaded."""
    model = torch_create_model('botnet_t3', num_classes=NUM_CLASSES,
                               img_size=BOTNET_IMG, device='cpu',
                               **BOTNET_SMALL, **kwargs)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model


# CeiT: 2 layers, D=128, H=2 (d=64: K1's constraints hold) at 64 px: the
# I2T stem's 33 x 33 conv grid pools to 16 x 16, so 4 x 4 patches of 4 x 4
# and L = 17; each LeFF's 3 x 3 conv runs on the 4 x 4 grid
CEIT_SMALL = dict(num_layers=2, embed_dim=128, num_heads=2)
CEIT_IMG = 64


@functools.lru_cache(maxsize=None)
def _ceit_variables():
    model = jax_create_model('ceit_t', num_classes=NUM_CLASSES, **CEIT_SMALL)
    variables = jax.jit(model.init, static_argnames='is_training')(
        jax.random.PRNGKey(0), jnp.ones((1, CEIT_IMG, CEIT_IMG, 3)),
        is_training=False)
    variables = fill_batchnorm(jax.tree_util.tree_map(np.array,
                                                      dict(variables)))
    params = fill_head(fill_biases(fill_body(variables['params'])))
    head = params['Dense_0']['kernel']
    params['Dense_0']['kernel'] = head / np.sqrt(head.shape[0])
    return {'params': params, 'batch_stats': variables['batch_stats']}


def jax_ceit(**kwargs):
    """(flax model, a copy of its ``{'params', 'batch_stats'}``) for the
    small CeiT: the head (scaled by 1/sqrt(D), so the loss resolves to
    1e-5 in f32) and cls filled, and every LayerNorm, BatchNorm (running
    statistics too) and bias (the Dense ones and the LeFF convs') drawn
    away from its init, so a swapped or dropped one shows; the tree is
    initialised once (every use_kernel mode has the same one)."""
    model = jax_create_model('ceit_t', num_classes=NUM_CLASSES, **CEIT_SMALL,
                             **kwargs)
    return model, jax.tree_util.tree_map(np.copy, _ceit_variables())


def torch_ceit(variables, **kwargs):
    """The port's small CeiT with ``variables`` loaded."""
    model = torch_create_model('ceit_t', num_classes=NUM_CLASSES,
                               img_size=CEIT_IMG, device='cpu', **CEIT_SMALL,
                               **kwargs)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model


# CvT: cvt-13's block types at 32 px, stage sizes (1, 1, 2), every head
# d = 64 (widths 64, 128, 256 in 1, 2 and 4 heads): query grids 8 x 8,
# 4 x 4 and 3 x 3 over key grids 4 x 4, 2 x 2 and 2 x 2; stage 3's 5
# tokens (cls + 2 x 2) zero-pad to 3 x 3, and its width, 256, is the
# narrowest that takes the int8 FF under quantized='ff'/'all'
CVT_SMALL = dict(stage_sizes=(1, 1, 2), num_heads=(1, 2, 4),
                 embed_dim=(64, 128, 256))
CVT_IMG = 32


def fill_cvt_head(params, seed=1):
    """CvT's zero-initialised head (scaled by 1/sqrt(D), so the loss
    resolves to 1e-5 in f32) and its last stage's cls token, drawn from the
    seed: zero, they would make every logit 0 and hide the cls row."""
    rng = np.random.RandomState(seed)
    head = params['Dense_0']
    head['kernel'] = (rng.standard_normal(head['kernel'].shape)
                      / np.sqrt(head['kernel'].shape[0])).astype(np.float32)
    head['bias'] = rng.standard_normal(head['bias'].shape).astype(np.float32)
    last = params[f'Stage_{len(CVT_SMALL["stage_sizes"]) - 1}']
    last['cls'] = rng.standard_normal(last['cls'].shape).astype(np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _cvt_variables():
    model = jax_create_model('cvt-13', num_classes=NUM_CLASSES, **CVT_SMALL)
    variables = jax.jit(model.init, static_argnames='is_training')(
        jax.random.PRNGKey(0), jnp.ones((1, CVT_IMG, CVT_IMG, 3)),
        is_training=False)
    variables = fill_batchnorm(jax.tree_util.tree_map(np.array,
                                                      dict(variables)))
    params = fill_cvt_head(fill_biases(fill_body(variables['params'])))
    return {'params': params, 'batch_stats': variables['batch_stats']}


def jax_cvt(**kwargs):
    """(flax model, a copy of its ``{'params', 'batch_stats'}``) for the
    small CvT: the head and cls filled, and every LayerNorm, BatchNorm
    (running statistics too) and bias drawn away from its init, so a
    swapped or dropped one shows; the tree is initialised once (every
    use_kernel and quantized mode has the same one)."""
    model = jax_create_model('cvt-13', num_classes=NUM_CLASSES, **CVT_SMALL,
                             **kwargs)
    return model, jax.tree_util.tree_map(np.copy, _cvt_variables())


def torch_cvt(variables, **kwargs):
    """The port's small CvT with ``variables`` loaded."""
    model = torch_create_model('cvt-13', num_classes=NUM_CLASSES,
                               img_size=CVT_IMG, device='cpu', **CVT_SMALL,
                               **kwargs)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model


# ---------------------------------------------------------------- data
# The JAX package's augmentation key tree (sav_tpu/data/pipeline.py:155-181
# and the functions it calls), reproduced with jax.random: the draws JAX
# takes for a batch, in the port's draws format (sav_tpu_torch.data.
# pipeline.draw), so the port's ``apply`` can be held to JAX's output.

def _jax_crop(rng, height, width, area_range=(0.05, 1.0),
              ratio_range=(3 / 4, 4 / 3)):
    r_area, r_ratio, r_y, r_x = jax.random.split(rng, 4)
    area = jax.random.uniform(r_area, (), minval=area_range[0],
                              maxval=area_range[1]) * height * width
    log_ratio = jax.random.uniform(r_ratio, (), minval=jnp.log(ratio_range[0]),
                                   maxval=jnp.log(ratio_range[1]))
    ratio = jnp.exp(log_ratio)
    crop_w = jnp.clip(jnp.sqrt(area * ratio), 1.0, width)
    crop_h = jnp.clip(jnp.sqrt(area / ratio), 1.0, height)
    y0 = jax.random.uniform(r_y, ()) * (height - crop_h)
    x0 = jax.random.uniform(r_x, ()) * (width - crop_w)
    return jnp.stack([y0, x0, crop_h, crop_w])


def _jax_erase(rng, size, erase_prob, min_area=0.02, max_area=1 / 3,
               min_aspect=0.3):
    r_apply, r_area, r_aspect, r_y, r_x, r_noise = jax.random.split(rng, 6)
    target = jax.random.uniform(r_area, (), minval=min_area,
                                maxval=max_area) * size * size
    ratio = jnp.exp(jax.random.uniform(
        r_aspect, (), minval=jnp.log(min_aspect),
        maxval=jnp.log(1.0 / min_aspect)))
    half_h = jnp.clip(jnp.sqrt(target * ratio).astype(jnp.int32) // 2, 1,
                      size // 2)
    half_w = jnp.clip(jnp.sqrt(target / ratio).astype(jnp.int32) // 2, 1,
                      size // 2)
    cy = jax.random.randint(r_y, (), 0, size)
    cx = jax.random.randint(r_x, (), 0, size)
    noise = jax.random.normal(r_noise, (size, size, 3), jnp.float32)
    apply = jax.random.uniform(r_apply, ()) < erase_prob
    return apply, jnp.stack([cy, cx, half_h, half_w]), noise


def _jax_randaugment(rng, ra):
    """Per-layer (op, level, sign, apply) and the trailing cutout centers
    of sav_tpu.data.randaugment.RandAugment.__call__."""
    rng_cut, *layer_rngs = jax.random.split(rng, ra.num_layers + 1)
    ops, levels, signs, applies = [], [], [], []
    for layer_rng in layer_rngs:
        rng_branch, rng_apply, rng_level, rng_sign, _ = jax.random.split(
            layer_rng, 5)
        levels.append(ra._sample_level(rng_level))
        ops.append(jax.random.randint(rng_branch, (), 0, 16))
        signs.append(jax.random.bernoulli(rng_sign, 0.5))
        applies.append(jax.random.uniform(rng_apply, ()) < ra.prob_to_apply
                       if ra.prob_to_apply is not None else jnp.bool_(True))
    ry, rx = jax.random.split(rng_cut)
    cut = (jax.random.randint(ry, (), 0, ra.size),
           jax.random.randint(rx, (), 0, ra.size))
    return (jnp.stack(ops), jnp.stack(levels), jnp.stack(signs),
            jnp.stack(applies), cut)


def _jax_jitter(rng, strength):
    rng_perm, _, *op_rngs = jax.random.split(rng, 7)
    b = c = s = 0.8 * strength
    h = 0.2 * strength
    bounds = [(1.0 - b, 1.0 + b), (max(0.0, 1 - c), 1 + c),
              (max(0.0, 1 - s), 1 + s), (-h, h)]
    order = jax.random.permutation(rng_perm, 4)
    factors = []
    for slot in range(4):
        cands = jnp.stack([jax.random.uniform(op_rngs[slot], (), minval=lo,
                                              maxval=hi) for lo, hi in bounds])
        factors.append(cands[order[slot]])
    return order, jnp.stack(factors)


def _jax_mix(rng, batch, size, config):
    rng_branch, rng_apply, rng_mix, rng_cut = jax.random.split(rng, 4)
    branches = int(bool(config.mixup_alpha)) + int(bool(config.cutmix_alpha))
    out = {'use_first': bool(jax.random.bernoulli(rng_branch,
                                                  1.0 / branches)),
           'take': (bool(jax.random.bernoulli(rng_apply, config.mix_prob))
                    if config.mix_prob < 1.0 else True)}
    rng_beta, rng_perm = jax.random.split(rng_mix)
    mix = jax.random.beta(rng_beta, config.mixup_alpha, config.mixup_alpha,
                          (batch,))
    out['mixup'] = {'ratio': np.asarray(jnp.maximum(mix, 1.0 - mix)),
                    'perm': np.asarray(jax.random.permutation(rng_perm,
                                                              batch))}
    rng_beta, rng_y, rng_x = jax.random.split(rng_cut, 3)
    cut = jax.random.beta(rng_beta, config.cutmix_alpha,
                          config.cutmix_alpha, (batch,))
    cut = jnp.minimum(cut, 1.0 - cut)
    side = jnp.sqrt(cut)
    box_h = (side * size).astype(jnp.int32)
    box_w = (side * size).astype(jnp.int32)
    y0 = jnp.minimum(jax.random.randint(rng_y, (batch,), 0, size),
                     size - box_h)
    x0 = jnp.minimum(jax.random.randint(rng_x, (batch,), 0, size),
                     size - box_w)
    out['cutmix'] = {'box': np.asarray(jnp.stack([y0, x0, box_h, box_w], 1))}
    return out


def jax_augment_draws(rng, batch, frame, augmentation, image_size):
    """The draws ``sav_tpu.data.pipeline.make_train_augment_fn(image_size,
    parse_augment_name(augmentation))(rng, ...)`` takes for a ``[batch,
    frame, frame, 3]`` batch, as the port's draws dict of host tensors."""
    from sav_tpu.data.pipeline import parse_augment_name
    from sav_tpu.data.randaugment import RandAugment

    config = parse_augment_name(augmentation)
    ra = RandAugment(num_layers=config.num_layers,
                     magnitude=config.magnitude, magstd=config.magstd,
                     prob_to_apply=config.ra_prob, cutout=config.ra_cutout,
                     num_levels=10, size=image_size)

    def per_example(r):
        r_crop, r_aug, r_jitter, r_erase = jax.random.split(r, 4)
        r_crop2, r_flip = jax.random.split(r_crop)
        out = {'crop': _jax_crop(r_crop2, frame, frame),
               'flip': jax.random.bernoulli(r_flip)}
        if config.use_randaugment:
            out['ra'] = _jax_randaugment(r_aug, ra)
        if config.use_colorjitter:
            out['jitter'] = _jax_jitter(r_jitter, config.colorjitter_strength)
        if config.erase_prob:
            out['erase'] = _jax_erase(r_erase, image_size, config.erase_prob)
        return out

    rng_mix, rng_examples = jax.random.split(rng)
    per = jax.jit(jax.vmap(per_example))(jax.random.split(rng_examples,
                                                          batch))
    per = jax.tree_util.tree_map(np.asarray, per)

    def t(a, dtype=None):
        a = torch.from_numpy(np.array(a))
        return a if dtype is None else a.to(dtype)

    draws = {'crop': t(per['crop']), 'flip': t(per['flip'])}
    if config.use_randaugment:
        op, level, sign, apply, (cy, cx) = per['ra']
        draws['ra'] = {'op': t(op.T, torch.int64), 'level': t(level.T),
                       'sign': t(sign.T), 'apply': t(apply.T)}
        if config.ra_cutout:
            draws['ra'].update(cut_y=t(cy, torch.int64),
                               cut_x=t(cx, torch.int64))
    if config.use_colorjitter:
        order, factor = per['jitter']
        draws['jitter'] = {'order': t(order, torch.int64),
                           'factor': t(factor)}
    if config.erase_prob:
        apply, box, noise = per['erase']
        draws['erase'] = {'apply': t(apply), 'box': t(box, torch.int64),
                          'noise': t(noise)}
    if config.use_mix:
        mixed = _jax_mix(rng_mix, batch, image_size, config)
        for key in ('mixup', 'cutmix'):
            mixed[key] = {k: t(v, torch.int64 if v.dtype.kind == 'i'
                               else None) for k, v in mixed[key].items()}
        draws['mix'] = mixed
    return draws
