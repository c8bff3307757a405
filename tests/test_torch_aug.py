"""The port's training augmentation, MixUp/CutMix and the train step with
``aug_enabled=true`` against the JAX package, on the CPU in f32, at 32 px
from native 24x32 images.

JAX's threefry keys cannot be reproduced in torch, so the port splits every
random op into a draw step and an apply step. ``jax_*_draws`` below walk
JAX's key tree as the JAX code does (the step's ``fold``/``fold_name``, the
pipeline's ``fold_name`` tags, each op's ``split``), call ``jax.random``
themselves and turn the draws into the port's draw tuples. Each apply step
then runs on JAX's draws and is held to the JAX function on the same key; a
slip in the mirror shows up as a failed parity test. The port's own draw
step, which these tests bypass, is held to its distributions at the end.

Tolerances: both sides compute in f32 with ops in another order (a 3x3
inverse by the adjugate against LU, cos/sin/exp from other libraries), so
source coordinates differ by ~1e-5 px; on random images a pixel differs from
its neighbour by up to 255, so an output moves by up to ~3e-3 grey levels.
Images are held to 1e-2 grey levels before Normalize (measured at most
1.9e-3, in the geometry; 2.2e-4 in the photometric stages), and soft labels
to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.aug import color as jcolor
from image_classification_tpu.aug import erase as jerase
from image_classification_tpu.aug import filters as jfilters
from image_classification_tpu.aug import geometry as jgeom
from image_classification_tpu.aug import mix as jmix
from image_classification_tpu.aug import pipeline as jpipe
from image_classification_tpu.core import prng
from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.ops.warp import warp_pallas
from image_classification_tpu.train import loss as jax_loss
from image_classification_tpu.train.step import make_train_step as jax_make_train
from image_classification_tpu_torch.aug import color, erase, filters, geometry, mix
from image_classification_tpu_torch.aug.pipeline import (
    AugDraws,
    apply_train_augment,
    aug_configs_from,
    draw_train_augment,
)
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.models.factory import ModelBundle
from image_classification_tpu_torch.ops import warp, warp_reference
from image_classification_tpu_torch.train import loss
from image_classification_tpu_torch.train.loop import build_lr_schedule
from image_classification_tpu_torch.train.optim import build_optimizer
from image_classification_tpu_torch.train.step import (
    StepDraws,
    _main_head,
    accumulate_grads,
    draw_train_step,
    make_batch_augment,
    make_train_step,
)

from test_torch_model import NUM_CLASSES
from test_torch_train import (
    STEPS_PER_EPOCH,
    assert_trees_close,
    jax_as_port,
    jax_bundle,
    port_params,
    start_states,
)
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

NATIVE = (24, 32)
SIZE = 32
B = 8
GREY_TOL = 1e-2
PROBS_ONE = dict(hflip_prob=1.0, vflip_prob=1.0, ssr_prob=1.0,
                 distortion_prob=1.0, noise_blur_prob=1.0,
                 color_jitter_prob=1.0, color_shift_prob=1.0,
                 random_erasing_prob=1.0, mix_prob=1.0)
PROBS_ZERO = {k: 0.0 for k in PROBS_ONE}


def both_cfgs(**over):
    kw = dict(num_classes=NUM_CLASSES, image_size=(SIZE, SIZE), native_size=NATIVE,
              batch_size=B, compute_dtype="float32")
    kw.update(over)
    return JaxConfig(**kw).validate(), Config(**kw).validate()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def u8_images(seed, n=B, hw=NATIVE):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


# ---------------------------------------------------------------- JAX draws
def _uniform(key, shape, lo=0.0, hi=1.0):
    return t(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def _bernoulli(key, p, n):
    return t(jax.random.bernoulli(key, p, (n,)))


def jax_geometry_draws(key, n, out_hw, g) -> geometry.GeometryDraws:
    """geometric_augment's draws: geometry.py:226/283/342/381/413/466/519."""
    k_rrc, k_flip, k_ssr, k_dist = jax.random.split(key, 4)
    k_area, k_ratio, k_x, k_y = jax.random.split(k_rrc, 4)
    rrc = geometry.RRCDraws(
        _uniform(k_area, (n, 10), *g.rrc_scale),
        _uniform(k_ratio, (n, 10), jnp.log(g.rrc_ratio[0]), jnp.log(g.rrc_ratio[1])),
        _uniform(k_x, (n,)), _uniform(k_y, (n,)))
    kh, kv = jax.random.split(k_flip)
    flip = geometry.FlipDraws(_bernoulli(kh, g.hflip_prob, n),
                              _bernoulli(kv, g.vflip_prob, n))
    k_apply, k_sh, k_sc, k_rot = jax.random.split(k_ssr, 4)
    ssr = geometry.SSRDraws(
        _bernoulli(k_apply, g.ssr_prob, n),
        _uniform(k_sh, (n, 2), -g.shift_limit, g.shift_limit),
        _uniform(k_sc, (n,), -g.scale_limit, g.scale_limit),
        _uniform(k_rot, (n,), -g.rotate_limit, g.rotate_limit))
    c = g.distortion
    k_apply, k_pick, k_o, k_g, k_e = jax.random.split(k_dist, 5)
    k_k, k_s = jax.random.split(k_o)
    kx, ky = jax.random.split(k_g)
    steps = c.grid_num_steps
    dist = geometry.DistortionDraws(
        _bernoulli(k_apply, c.prob, n),
        t(jax.random.randint(k_pick, (n,), 0, 3)),
        _uniform(k_k, (n, 1, 1), -c.optical_distort_limit, c.optical_distort_limit),
        _uniform(k_s, (n, 2), -c.optical_shift_limit, c.optical_shift_limit),
        _uniform(kx, (n, steps), -c.grid_distort_limit, c.grid_distort_limit),
        _uniform(ky, (n, steps), -c.grid_distort_limit, c.grid_distort_limit),
        t(jax.random.normal(k_e, (n, *geometry.elastic_grid_hw(out_hw, c), 2))))
    return geometry.GeometryDraws(rrc, flip, ssr, dist)


def jax_noise_blur_draws(key, shape, c) -> filters.NoiseBlurDraws:
    """filters.py:102."""
    n = shape[0]
    k_apply, k_pick, k_var, k_noise, k_ks, k_mk = jax.random.split(key, 6)
    lo, hi = c.blur_limit
    return filters.NoiseBlurDraws(
        _bernoulli(k_apply, c.prob, n), t(jax.random.randint(k_pick, (n,), 0, 3)),
        _uniform(k_var, (n, 1, 1, 1), *c.gauss_noise_var),
        t(jax.random.normal(k_noise, shape)),
        t(lo + 2 * jax.random.randint(k_ks, (n,), 0, (hi - lo) // 2 + 1)),
        _uniform(k_mk, (n, 1, 1), 0.0, jnp.pi))


def jax_jitter_draws(key, n, c) -> color.ColorJitterDraws:
    """color.py:114."""
    k_apply, k_b, k_c, k_s, k_h, k_perm = jax.random.split(key, 6)

    def factor(k, amount):
        return _uniform(k, (n, 1, 1, 1), max(0.0, 1 - amount), 1 + amount)

    perms = jax.vmap(lambda k: jax.random.permutation(k, 4))(jax.random.split(k_perm, n))
    return color.ColorJitterDraws(
        _bernoulli(k_apply, c.prob, n), factor(k_b, c.brightness),
        factor(k_c, c.contrast), factor(k_s, c.saturation),
        _uniform(k_h, (n, 1, 1), -c.hue, c.hue), t(perms))


def jax_color_shift_draws(key, n, c) -> color.ColorShiftDraws:
    """color.py:176/202."""
    k_apply, k_pick, k_rgb, k_hsv = jax.random.split(key, 4)
    kh, ks, kv = jax.random.split(k_hsv, 3)
    return color.ColorShiftDraws(
        _bernoulli(k_apply, c.prob, n), t(jax.random.randint(k_pick, (n,), 0, 3)),
        _uniform(k_rgb, (n, 1, 1, 3), -c.rgb_shift_limit, c.rgb_shift_limit),
        _uniform(kh, (n, 1, 1), -c.hsv_hue_limit, c.hsv_hue_limit),
        _uniform(ks, (n, 1, 1), -c.hsv_sat_limit, c.hsv_sat_limit),
        _uniform(kv, (n, 1, 1), -c.hsv_val_limit, c.hsv_val_limit))


def jax_erase_draws(key, shape, c) -> erase.EraseDraws:
    """erase.py:28."""
    n, H, W = shape[:3]
    M = c.max_holes
    k_apply, k_n, k_h, k_w, k_y, k_x = jax.random.split(key, 6)
    return erase.EraseDraws(
        _bernoulli(k_apply, c.prob, n),
        t(jax.random.randint(k_n, (n,), c.min_holes, c.max_holes + 1)),
        t(jax.random.randint(k_h, (n, M), H // 16, H // 8 + 1)),
        t(jax.random.randint(k_w, (n, M), W // 16, W // 8 + 1)),
        _uniform(k_y, (n, M)), _uniform(k_x, (n, M)))


def jax_mix_draws(key, shape, c) -> mix.MixDraws:
    """mix.py:59."""
    n, H, W = shape[:3]
    k_perm, k_gate, k_choice, k_lam_m, k_lam_c, k_cx, k_cy = jax.random.split(key, 7)
    return mix.MixDraws(
        t(jax.random.permutation(k_perm, n)), _bernoulli(k_gate, c.prob, n),
        _bernoulli(k_choice, 0.5, n),
        t(jmix._beta(k_lam_m, c.mixup_alpha, (n,))),
        t(jmix._beta(k_lam_c, c.cutmix_alpha, (n,))),
        t(jax.random.randint(k_cx, (n,), 0, W)), t(jax.random.randint(k_cy, (n,), 0, H)))


def jax_aug_draws(key, shape, jaug) -> AugDraws:
    """train_augment's draws: the pipeline's tags (pipeline.py:152-160)."""
    from test_torch_randaug import jax_randaug_draws

    out_shape = (shape[0], *jaug["image_size"], shape[-1])
    ra = jaug.get("randaugment")
    return AugDraws(
        jax_geometry_draws(prng.fold_name(key, "geometry"), shape[0],
                           jaug["image_size"], jaug["geometry"]),
        jax_noise_blur_draws(prng.fold_name(key, "noise_blur"), out_shape,
                             jaug["noise_blur"]),
        jax_jitter_draws(prng.fold_name(key, "jitter"), shape[0], jaug["jitter"]),
        jax_color_shift_draws(prng.fold_name(key, "color_shift"), shape[0],
                              jaug["color_shift"]),
        jax_erase_draws(prng.fold_name(key, "erase"), out_shape, jaug["erase"]),
        None if ra is None else jax_randaug_draws(prng.fold_name(key, "randaug"),
                                                  shape[0], ra))


def jax_mix_cfg(jcfg) -> jmix.MixCfg:
    return jmix.MixCfg(mixup_alpha=jcfg.mixup_alpha, cutmix_alpha=jcfg.cutmix_alpha,
                       prob=jcfg.mix_prob, num_classes=jcfg.num_classes)


def jax_step_draws(base_key, step, shape, jcfg) -> StepDraws:
    """The train step's keys (train/step.py:93-104)."""
    key = prng.fold(base_key, step)
    jaug = jpipe.aug_configs_from(jcfg)
    out_shape = (shape[0], *jaug["image_size"], shape[-1])
    return StepDraws(jax_aug_draws(prng.fold_name(key, "aug"), shape, jaug),
                     jax_mix_draws(prng.fold_name(key, "mix"), out_shape,
                                   jax_mix_cfg(jcfg)))


# ---------------------------------------------------------------- helpers
def grey(a, b, std=None) -> float:
    """max |a - b| in grey levels (normalized outputs are scaled back)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    if std is not None:
        d = d * np.asarray(std) * 255.0
    return float(d.max())


def float_images(seed, shape=(B, SIZE, SIZE, 3)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


# ---------------------------------------------------------------- warp
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_plain_version_matches_pallas_kernel(dtype):
    """The warp's plain version (the wrapper's CPU path) against
    ``warp_pallas`` in interpret mode: f32 within 2e-3 (as
    ``tests/test_warp_pallas.py``; measured 3.1e-5), bf16 within one ulp
    (measured equal) at coordinates far outside the image, on its edges and
    on integer taps."""
    r = np.random.default_rng(0)
    img = r.uniform(0, 255, (2, 13, 17, 3)).astype(np.float32)
    coords = np.stack([r.uniform(-30, 45, (2, 11, 19)), r.uniform(-40, 60, (2, 11, 19))],
                      -1).astype(np.float32)
    coords[0, 0, :8] = [[0, 0], [12, 16], [12, 0.5], [-0.0, 16], [24, 32],
                        [-12, -16], [6.5, 16], [12, 7.25]]
    jimg = jnp.asarray(img).astype(dtype)
    theirs = np.asarray(warp_pallas(jimg, jnp.asarray(coords), interpret=True)
                        .astype(jnp.float32))
    timg = t(jimg.astype(jnp.float32)).to(getattr(torch, dtype))
    ours = warp(timg, torch.from_numpy(coords))
    assert ours.dtype == timg.dtype and ours.shape == (2, 11, 19, 3)
    ours = ours.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ours, theirs, atol=2e-3, rtol=0)
        xfirst = np.asarray(jgeom.bilinear_gather_mxu_xfirst(jimg, jnp.asarray(coords)))
        np.testing.assert_allclose(ours, xfirst, atol=2e-3, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(theirs), 1e-30))) - 7)
        assert (np.abs(ours - theirs) <= ulp).all()
    assert warp.launches == 0


def test_bilinear_gather_and_folds_match_jax():
    r = np.random.default_rng(1)
    img = r.uniform(0, 255, (2, 9, 14, 3)).astype(np.float32)
    coords = r.uniform(-20, 30, (2, 5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        geometry.bilinear_gather(torch.from_numpy(img), torch.from_numpy(coords)).numpy(),
        np.asarray(jgeom.bilinear_gather(jnp.asarray(img), jnp.asarray(coords))),
        atol=1e-3)
    idx = np.arange(-40, 40)
    for n in (1, 2, 9):
        np.testing.assert_array_equal(
            geometry.reflect101_index(torch.from_numpy(idx), n).numpy(),
            np.asarray(jgeom.reflect101_index(jnp.asarray(idx), n)))
        c = r.uniform(-50, 50, 200).astype(np.float32)
        np.testing.assert_array_equal(
            geometry.reflect101_coord(torch.from_numpy(c), n).numpy(),
            np.asarray(jgeom.reflect101_coord(jnp.asarray(c), n)))
    ref = warp_reference(torch.from_numpy(img), torch.from_numpy(coords))
    np.testing.assert_allclose(ref.numpy(), np.asarray(
        warp_pallas(jnp.asarray(img), jnp.asarray(coords), interpret=True)), atol=2e-3)


# ---------------------------------------------------------------- stages
@pytest.mark.parametrize("case", ["v4", "all_ones", "rrc_fallback"])
def test_geometry_matrices_and_maps_match_jax(case):
    jcfg, cfg = both_cfgs(**(PROBS_ONE if case == "all_ones" else {}))
    g = aug_configs_from(cfg)["geometry"]
    jg = jpipe.aug_configs_from(jcfg)["geometry"]
    if case == "rrc_fallback":   # areas past the image: no attempt fits
        g, jg = g._replace(rrc_scale=(2.0, 3.0)), jg._replace(rrc_scale=(2.0, 3.0))
    key = jax.random.key(5)
    out = (SIZE, SIZE)
    d = jax_geometry_draws(key, B, out, jg)
    k_rrc, k_flip, k_ssr, k_dist = jax.random.split(key, 4)
    pairs = [
        (geometry.random_resized_crop_matrix(d.rrc, NATIVE, out, g.rrc_ratio),
         jgeom.random_resized_crop_matrix(k_rrc, B, NATIVE, out, jg.rrc_scale, jg.rrc_ratio)),
        (geometry.flip_matrix(d.flip, out),
         jgeom.flip_matrix(k_flip, B, out, jg.hflip_prob, jg.vflip_prob)),
        (geometry.shift_scale_rotate_inverse_matrix(d.ssr, out),
         jgeom.shift_scale_rotate_inverse_matrix(k_ssr, B, out, jg.ssr_prob, jg.shift_limit,
                                                 jg.scale_limit, jg.rotate_limit)),
    ]
    for ours, theirs in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)
    c, jc, dd = g.distortion, jg.distortion, d.distortion
    _, _, k_o, k_g, k_e = jax.random.split(k_dist, 5)
    maps = [
        (geometry.optical_distortion_map(dd.optical_k, dd.optical_shift, out),
         jgeom.optical_distortion_map(k_o, B, out, jc)),
        (geometry.grid_distortion_map(dd.grid_x, dd.grid_y, out),
         jgeom.grid_distortion_map(k_g, B, out, jc)),
        (geometry.elastic_map(dd.elastic, out, c), jgeom.elastic_map(k_e, B, out, jc)),
        (geometry.distortion_source_map(dd, out, c),
         jgeom.distortion_source_map(k_dist, B, out, jc)),
    ]
    for ours, theirs in maps:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4, rtol=0)
    if case == "rrc_fallback":   # no attempt fits: the centred fallback crop
        m = pairs[0][0]
        assert torch.allclose(m[:, 0, 0], torch.full((B,), NATIVE[1] / SIZE))


@pytest.mark.parametrize("case", ["v4", "all_ones"])
def test_geometric_augment_matches_jax(case):
    jcfg, cfg = both_cfgs(**(PROBS_ONE if case == "all_ones" else {}))
    jg = jpipe.aug_configs_from(jcfg)["geometry"]
    img = u8_images(2).astype(np.float32)
    key = jax.random.key(6)
    theirs = jax.jit(lambda x, k: jgeom.geometric_augment(x, k, (SIZE, SIZE), jg))(
        jnp.asarray(img), key)
    ours = geometry.geometric_augment(torch.from_numpy(img),
                                      jax_geometry_draws(key, B, (SIZE, SIZE), jg),
                                      (SIZE, SIZE), aug_configs_from(cfg)["geometry"])
    assert grey(ours, theirs) <= GREY_TOL


STAGES = {
    "noise_blur": (jfilters.noise_blur_oneof, filters.noise_blur_oneof,
                   lambda k, s, c: jax_noise_blur_draws(k, s, c)),
    "jitter": (jcolor.color_jitter, color.color_jitter,
               lambda k, s, c: jax_jitter_draws(k, s[0], c)),
    "color_shift": (jcolor.color_shift_oneof, color.color_shift_oneof,
                    lambda k, s, c: jax_color_shift_draws(k, s[0], c)),
    "erase": (jerase.coarse_dropout, erase.coarse_dropout,
              lambda k, s, c: jax_erase_draws(k, s, c)),
}


@pytest.mark.parametrize("stage", list(STAGES))
def test_photometric_stage_matches_jax(stage):
    """Each stage at probability 1, so every sample takes one of its
    branches; B = 16 so that every branch of each OneOf runs."""
    jcfg, cfg = both_cfgs(**PROBS_ONE)
    jfn, fn, draws = STAGES[stage]
    jc, c = jpipe.aug_configs_from(jcfg)[stage], aug_configs_from(cfg)[stage]
    img = float_images(3, (16, SIZE, SIZE, 3))
    img[0, :4, :4] = 0.0   # black and saturated pixels: HSV's special cases
    img[1, :4, :4] = 255.0
    img[2, :4, :4, 1:] = img[2, :4, :4, :1]
    key = jax.random.key(7)
    theirs = jax.jit(lambda x, k: jfn(x, k, jc))(jnp.asarray(img), key)
    d = draws(key, img.shape, jc)
    if hasattr(d, "pick"):
        assert set(d.pick.tolist()) == {0, 1, 2}
    ours = fn(torch.from_numpy(img), d, c)
    assert grey(ours, theirs) <= GREY_TOL
    assert not np.array_equal(ours.numpy(), img)


def test_mixup_cutmix_matches_jax():
    jcfg, cfg = both_cfgs(mix_prob=1.0)
    img = float_images(4, (16, SIZE, SIZE, 3))
    labels = np.random.default_rng(5).integers(0, NUM_CLASSES, 16).astype(np.int32)
    key = jax.random.key(8)
    jmc = jax_mix_cfg(jcfg)
    ti, tl = jax.jit(lambda x, y, k: jmix.mixup_cutmix_batch(x, y, k, jmc))(
        jnp.asarray(img), jnp.asarray(labels), key)
    d = jax_mix_draws(key, img.shape, jmc)
    assert 0 < int(d.use_mixup.sum()) < 16
    oi, ol = mix.mixup_cutmix_batch(torch.from_numpy(img), torch.from_numpy(labels), d,
                                    mix.MixCfg(cfg.mixup_alpha, cfg.cutmix_alpha,
                                               cfg.mix_prob, cfg.num_classes))
    assert grey(oi, ti) <= GREY_TOL
    np.testing.assert_allclose(ol.numpy(), np.asarray(tl), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["v4", "all_ones"])
def test_train_augment_matches_jax(case):
    """The whole pipeline, JAX jitted once per case, against the port's
    apply step on JAX's draws; Normalize's output scaled back to grey."""
    jcfg, cfg = both_cfgs(**(PROBS_ONE if case == "all_ones" else {}))
    jaug, aug = jpipe.aug_configs_from(jcfg), aug_configs_from(cfg)
    img = u8_images(9)
    key = jax.random.key(10)
    theirs = jax.jit(lambda x, k: jpipe.train_augment(x, k, jaug))(jnp.asarray(img), key)
    ours = apply_train_augment(torch.from_numpy(img), jax_aug_draws(key, img.shape, jaug),
                               aug)
    assert ours.shape == (B, SIZE, SIZE, 3) and ours.dtype == torch.float32
    assert grey(ours, theirs, cfg.std) <= GREY_TOL


# ---------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def aug_steps():
    """JAX's jitted train step and the port's, aug and mix on (V4's
    probabilities), from one state; compiled once for the module."""
    over = dict(aug_enabled=True, native_size=NATIVE)
    from test_torch_train import both_cfgs as train_cfgs
    jcfg, cfg = train_cfgs(**over)
    tx_j, jstate, state = start_states(jcfg)
    jstep = jax.jit(jax_make_train(jax_bundle(), jcfg, tx_j,
                                   jax_loss.build_criterion(jcfg)))
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    bundle = ModelBundle("tiny", state.model, True, (SIZE, SIZE))
    step = make_train_step(bundle, cfg, tx, loss.build_criterion(cfg))
    return jcfg, cfg, jstate, state, jstep, step


def test_train_step_with_aug_and_mix_matches_jax_over_two_steps(aug_steps):
    """``configs/v4.json``'s aug and mix settings at 32 px, accumulation 2,
    the fused update with EMA: two steps, each fed JAX's draws for its step
    count. Tolerances of ``tests/test_torch_train.py``."""
    jcfg, cfg, jstate, state, jstep, step = aug_steps
    assert cfg.aug_enabled and cfg.mixup_alpha > 0 and cfg.cutmix_alpha > 0
    base = jax.random.key(0)
    for i in range(2):
        img = u8_images(20 + i)
        labels = np.random.default_rng(30 + i).integers(0, NUM_CLASSES, B).astype(np.int32)
        draws = jax_step_draws(base, state.step, img.shape, jcfg)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(img),
                                    "label": jnp.asarray(labels)}, base)
        state, m = step(state, {"image": torch.from_numpy(img),
                                "label": torch.from_numpy(labels).long()}, draws=draws)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-6)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    assert state.step == int(jstate.step) == 32
    atol = 1e-3 * cfg.lr
    assert_trees_close(port_params(state), jax_as_port(jstate.params), atol, "params")
    assert_trees_close(dict(zip(state.names(), (e.numpy() for e in state.ema))),
                       jax_as_port(jstate.ema_params), atol, "ema")


def test_accuracy_counts_the_labels_from_before_the_mix(aug_steps):
    """The labels are the model's own predictions on the mixed batch, so the
    JAX step, which scores against the labels from before the mix, counts
    every row; argmax of the soft targets would not (the first base key
    whose draws mix some row past its own label is taken)."""
    jcfg, cfg, _, _, jstep, _ = aug_steps
    _, jstate, state = start_states(jcfg, seed=11)
    img = torch.from_numpy(u8_images(40))
    augment = make_batch_augment(cfg)
    for seed in range(10):
        base = jax.random.key(seed)
        draws = jax_step_draws(base, state.step, img.shape, jcfg)
        images, _ = augment({"image": img, "label": torch.zeros(B, dtype=torch.long)},
                            draws=draws)
        with torch.no_grad():
            labels = _main_head(state.model(images)).argmax(-1)
        images, targets = augment({"image": img, "label": labels}, draws=draws)
        if (targets.argmax(-1) != labels).any():
            break
    assert (targets.argmax(-1) != labels).any()
    _, jm = jstep(jstate, {"image": jnp.asarray(img.numpy()),
                           "label": jnp.asarray(labels.numpy().astype(np.int32))}, base)
    _, m = accumulate_grads(state.model, cfg, loss.build_criterion(cfg), images,
                            targets, labels)
    assert float(m["accuracy"]) == float(jm["accuracy"]) == 1.0


# ---------------------------------------------------------------- draws
def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("probs", ["zero", "one"])
def test_draw_probabilities_gate_every_op(probs):
    """Probability 0 applies nothing and 1 applies everything."""
    _, cfg = both_cfgs(**(PROBS_ONE if probs == "one" else PROBS_ZERO))
    aug = aug_configs_from(cfg)
    n = 64
    d = draw_train_step(gen(0), (n, *NATIVE, 3), cfg)
    want = probs == "one"
    gates = [d.aug.geometry.flip.h, d.aug.geometry.flip.v, d.aug.geometry.ssr.apply,
             d.aug.geometry.distortion.apply, d.aug.noise_blur.apply, d.aug.jitter.apply,
             d.aug.color_shift.apply, d.aug.erase.apply, d.mix.do_mix]
    assert all(bool((g == want).all()) for g in gates)
    x = torch.from_numpy(float_images(11, (n, SIZE, SIZE, 3)))
    for name, fn in [("noise_blur", filters.noise_blur_oneof), ("jitter", color.color_jitter),
                     ("color_shift", color.color_shift_oneof), ("erase", erase.coarse_dropout)]:
        changed = (fn(x, getattr(d.aug, name), aug[name]) != x).flatten(1).any(1)
        assert bool((changed == want).all()), name
    mixed, lab = mix.mixup_cutmix_batch(x, torch.arange(n) % NUM_CLASSES, d.mix,
                                        mix.MixCfg(num_classes=NUM_CLASSES,
                                                   prob=cfg.mix_prob))
    # a row mixed with itself, or at lambda 1, keeps its image and label
    assert bool((lab.max(-1).values < 1).any()) == want
    assert torch.equal(mixed, x) != want
    if not want:
        grid = geometry.output_grid(SIZE, SIZE)[None]
        src = geometry.distortion_source_map(d.aug.geometry.distortion, (SIZE, SIZE),
                                             aug["geometry"].distortion)
        assert torch.equal(src, grid.expand_as(src))


def test_draw_ranges():
    _, cfg = both_cfgs(**PROBS_ONE)
    aug = aug_configs_from(cfg)
    g = aug["geometry"]
    n = 256
    d = draw_train_step(gen(1), (n, *NATIVE, 3), cfg)
    ssr, rrc = d.aug.geometry.ssr, d.aug.geometry.rrc
    assert bool((ssr.angle.abs() <= g.rotate_limit).all())
    assert bool((ssr.scale.abs() <= g.scale_limit).all())
    assert bool((ssr.shift.abs() <= g.shift_limit).all())
    assert bool(((rrc.area >= g.rrc_scale[0]) & (rrc.area < g.rrc_scale[1])).all())
    # every crop lies inside the native image
    A = geometry.random_resized_crop_matrix(rrc, NATIVE, (SIZE, SIZE), g.rrc_ratio)
    left = A[:, 0, 2] + 0.5 - 0.5 * A[:, 0, 0]      # x0
    top = A[:, 1, 2] + 0.5 - 0.5 * A[:, 1, 1]
    assert bool((left >= -1e-4).all() and (left + SIZE * A[:, 0, 0] <= NATIVE[1] + 1e-4).all())
    assert bool((top >= -1e-4).all() and (top + SIZE * A[:, 1, 1] <= NATIVE[0] + 1e-4).all())
    assert set(d.aug.noise_blur.ksize.tolist()) == {3, 5, 7}
    assert set(d.aug.geometry.distortion.pick.tolist()) == {0, 1, 2}
    er = d.aug.erase
    assert int(er.n.min()) == 1 and int(er.n.max()) == 8
    assert bool(((er.hh >= SIZE // 16) & (er.hh <= SIZE // 8)).all())
    perms = d.aug.jitter.order.sort(dim=1).values
    assert torch.equal(perms, torch.arange(4).expand(n, 4))
    assert torch.equal(d.mix.partner.sort().values, torch.arange(n))
    assert bool(((d.mix.cx >= 0) & (d.mix.cx < SIZE)).all())


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_beta_sampler(alpha):
    """Beta(a, a) has mean 1/2 and variance 1 / (4 (2a + 1)); 40,000 draws
    put the sample mean within 0.01 (about 4 standard errors) and the
    variance within 5%."""
    x = mix.sample_beta(gen(2), alpha, 40_000)
    assert bool(((x >= 0) & (x <= 1)).all()) and x.dtype == torch.float32
    assert abs(float(x.mean()) - 0.5) < 0.01
    var = 1 / (4 * (2 * alpha + 1))
    assert abs(float(x.var()) / var - 1) < 0.05
    assert bool((mix.sample_beta(gen(2), 0.0, 5) == 1).all())


def test_equal_seeds_give_equal_draws():
    _, cfg = both_cfgs()
    a, b, c = (draw_train_step(gen(s), (B, *NATIVE, 3), cfg) for s in (4, 4, 5))
    flat = [jax.tree_util.tree_leaves(x, is_leaf=lambda v: isinstance(v, torch.Tensor))
            for x in (a, b, c)]
    assert all(torch.equal(p, q) for p, q in zip(flat[0], flat[1]))
    assert not all(torch.equal(p, q) for p, q in zip(flat[0], flat[2]))
    x = torch.from_numpy(u8_images(12))
    aug = aug_configs_from(cfg)
    assert torch.equal(apply_train_augment(x, a.aug, aug),
                       apply_train_augment(x, draw_train_augment(gen(4), tuple(x.shape), aug),
                                           aug))
