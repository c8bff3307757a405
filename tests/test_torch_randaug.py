"""The port's RandAugment (``aug/randaug.py``) against the JAX package's, on
the CPU in f32, on 8 integer-valued 16x20 images. Every JAX call runs
eagerly at that one shape, so its ops compile once for the module (a
``jax.jit`` of the 15-way select costs seconds more on each shape).

Draws: the port's apply step runs on JAX's draws, taken through the mirror
of JAX's key tree (``jax_randaug_draws`` below, ``randaug.py:160-168``; in
the whole pipeline ``test_torch_aug.jax_aug_draws`` folds ``"randaug"``).

Tolerances, in grey levels (0..255). The photometric ops compute the same
f32 operations, some sums in another order, and agree to a few f32 ulps of
255 (measured at most 6.1e-5, contrast). The geometric ops resample at
coordinates from a 3x3 matrix whose cos/sin and products come from other
libraries; a coordinate may move by an ulp (~2e-6 px at 20 px), which moves
a pixel between neighbours up to 255 apart by ~5e-4 (measured at most
4.4e-4, shear-x). Every op is held to 1e-3. ``rand_augment`` chains three
ops (measured 2.6e-4) and ``train_augment`` the whole pipeline and
Normalize (measured 9.5e-4); both are held to 1e-2, the bound
``test_torch_aug.py`` holds the pipeline to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.aug import color as jcolor
from image_classification_tpu.aug import pipeline as jpipe
from image_classification_tpu.aug import randaug as jrand
from image_classification_tpu.core import prng
from image_classification_tpu_torch.aug import randaug
from image_classification_tpu_torch.aug.pipeline import (
    apply_train_augment,
    aug_configs_from,
    draw_train_augment,
)
from image_classification_tpu_torch.ops import warp

from test_torch_aug import both_cfgs, grey, jax_aug_draws, t, u8_images
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

HW = (16, 20)
B = 8
OP_TOL = 1e-3
CHAIN_TOL = 1e-2


def int_images(seed, n, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, (n, *HW, 3)).astype(np.float32)


def jax_randaug_draws(key, n, c) -> randaug.RandAugDraws:
    """rand_augment's draws (randaug.py:160-168)."""
    k_gate, k_ops, k_apply, k_mag, k_sign = jax.random.split(key, 5)
    shape = (n, c.num_ops)
    mags = jnp.clip(c.magnitude + c.mag_std * jax.random.normal(k_mag, shape), 0.0, 10.0)
    return randaug.RandAugDraws(
        t(jax.random.bernoulli(k_gate, c.prob, (n,))),
        t(jax.random.randint(k_ops, shape, 0, randaug.NUM_OPS)).long(),
        t(jax.random.bernoulli(k_apply, 0.5, shape)), t(mags),
        t(jax.random.bernoulli(k_sign, 0.5, shape)))


def jax_branch(i, x, mag, sign):
    """Branch ``i`` of one slot of JAX's ``rand_augment`` (randaug.py:176-196),
    written out so that one op runs alone."""
    frac = mag / 10.0
    signed = jnp.where(sign, frac, -frac)
    b1 = signed[:, None, None, None]
    f = frac[:, None, None, None]

    def warp_with(fn, *args):
        return jax.vmap(fn)(x, *args)

    branches = {
        0: lambda: jax.vmap(jrand._autocontrast)(x),
        1: lambda: jax.vmap(jrand._equalize)(x),
        2: lambda: jrand._invert(x),
        3: lambda: warp_with(jrand._rotate, signed * 30.0),
        4: lambda: jrand._posterize(x, 4 - jnp.floor(f * 4)),
        5: lambda: jrand._solarize(x, 256.0 * (1 - f)),
        6: lambda: jrand._solarize_add(x, 110.0 * f),
        7: lambda: jnp.clip(jcolor._adjust_saturation(x, 1.0 + b1 * 0.9), 0, 255),
        8: lambda: jnp.clip(jcolor._adjust_contrast(x, 1.0 + b1 * 0.9), 0, 255),
        9: lambda: jnp.clip(jcolor._adjust_brightness(x, 1.0 + b1 * 0.9), 0, 255),
        10: lambda: jnp.clip(jax.vmap(jrand._sharpness)(x, 1.0 + signed * 0.9), 0, 255),
        11: lambda: warp_with(lambda im, a: jrand._shear(im, a, 0), signed * 0.3),
        12: lambda: warp_with(lambda im, a: jrand._shear(im, a, 1), signed * 0.3),
        13: lambda: warp_with(lambda im, a: jrand._translate(im, a, 0), signed * 0.45),
        14: lambda: warp_with(lambda im, a: jrand._translate(im, a, 1), signed * 0.45),
    }
    return branches[i]()


def test_train_augment_with_randaugment_matches_jax():
    """The whole pipeline with ``use_randaugment=true`` (V2's RandAugment at
    p = 1, every other probability V4's) at 16x20 from 16x20, JAX's draws
    through the key tree, Normalize's output scaled back to grey levels.
    First in the module: its eager JAX run compiles the ops the tests
    below reuse."""
    jcfg, cfg = both_cfgs(use_randaugment=True, randaugment_prob=1.0,
                          native_size=HW, image_size=HW)
    jaug, aug = jpipe.aug_configs_from(jcfg), aug_configs_from(cfg)
    assert aug["randaugment"] == randaug.RandAugmentCfg(prob=1.0)
    img = u8_images(22, B, HW)
    key = jax.random.key(23)
    theirs = jpipe.train_augment(jnp.asarray(img), key, jaug)
    d = jax_aug_draws(key, img.shape, jaug)
    assert d.randaug is not None
    ours = apply_train_augment(torch.from_numpy(img), d, aug)
    assert grey(ours, theirs, cfg.std) <= CHAIN_TOL


@pytest.mark.parametrize("op", range(randaug.NUM_OPS), ids=list(randaug.OP_NAMES))
def test_each_op_matches_jax(op):
    """One slot, every sample on op ``op``, at magnitudes from 0 to 10 (the
    clip) with both signs; images with a flat channel and a two-level one
    too, where autocontrast keeps the channel and equalize meets an empty
    top bin; values in [10, 240), so autocontrast stretches."""
    x = int_images(op, B, 10, 240)
    x[1, ..., 0] = 77.0                                  # hi == lo
    x[2, ..., 1] = np.where(np.arange(HW[1]) % 2, 30.0, 200.0)
    mag = np.array([10.0, 9.0, 3.7, 0.4, 0.0, 9.5, 5.0, 7.5], np.float32)
    sign = np.arange(B) % 2 == 0
    d = randaug.RandAugDraws(
        torch.ones(B, dtype=torch.bool), torch.full((B, 1), op),
        torch.ones(B, 1, dtype=torch.bool), torch.from_numpy(mag)[:, None],
        torch.from_numpy(sign)[:, None])
    cfg = randaug.RandAugmentCfg(prob=1.0, num_ops=1)
    ours = randaug.apply_rand_augment(torch.from_numpy(x), d, cfg)
    theirs = jax_branch(op, jnp.asarray(x), jnp.asarray(mag), jnp.asarray(sign))
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    assert grey(ours, theirs) <= OP_TOL
    assert not np.array_equal(ours.numpy(), x)


@pytest.mark.parametrize("prob", [1.0, 0.3])
def test_rand_augment_matches_jax(prob):
    """``rand_augment`` whole (3 slots of the 15-way select) on JAX's draws."""
    x = int_images(20, B)
    cfg = randaug.RandAugmentCfg(prob=prob)
    jcfg = jrand.RandAugmentCfg(prob=prob)
    key = jax.random.key(21)
    d = jax_randaug_draws(key, B, jcfg)
    theirs = jrand.rand_augment(jnp.asarray(x), key, jcfg)
    ours = randaug.apply_rand_augment(torch.from_numpy(x), d, cfg)
    assert grey(ours, theirs) <= CHAIN_TOL
    on = (d.gate[:, None] & d.applies).any(1)
    changed = (ours != torch.from_numpy(x)).flatten(1).any(1)
    assert bool((changed <= on).all())      # a gated-off sample is untouched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identity_warp_keeps_every_bit(dtype):
    """A slot with no geometric op resamples through the identity: integer
    taps with hats 1 and 0 give every pixel back bit for bit, also in bf16,
    and the slot still launches no warp on a CPU tensor."""
    x = torch.from_numpy(np.random.default_rng(24).uniform(0, 255, (3, *HW, 3))
                         .astype(np.float32)).to(dtype)
    op = torch.tensor([0, 7, 10])
    mat = randaug.slot_matrix(op, torch.tensor([0.9, -0.4, 1.0]), HW)
    assert torch.equal(mat, torch.eye(3)[:2].expand(3, 2, 3))
    assert torch.equal(randaug.affine_warp(x, mat), x)
    assert warp.launches == 0


def test_draw_rand_augment_distributions():
    """Shapes and dtypes, and rates over 20,000 samples within ~4 standard
    errors: the gate at p, each op id 1/15, applies and signs 1/2, and the
    magnitudes clip(9 + 0.5 N(0, 1), 0, 10)."""
    n, cfg = 20_000, randaug.RandAugmentCfg()
    d = randaug.draw_rand_augment(torch.Generator().manual_seed(25), n, cfg)
    assert d.gate.shape == (n,) and d.gate.dtype == torch.bool
    for v in (d.op_ids, d.applies, d.mags, d.signs):
        assert v.shape == (n, cfg.num_ops)
    assert d.mags.dtype == torch.float32 and d.op_ids.dtype == torch.int64
    assert abs(d.gate.float().mean().item() - cfg.prob) < 0.013
    counts = torch.bincount(d.op_ids.flatten(), minlength=16)
    assert counts[15] == 0 and int(d.op_ids.min()) == 0
    assert (counts[:15].float() / (3 * n) - 1 / 15).abs().max().item() < 0.006
    for b in (d.applies, d.signs):
        assert abs(b.float().mean().item() - 0.5) < 0.008
    assert float(d.mags.min()) >= 0.0 and float(d.mags.max()) == 10.0
    assert abs(d.mags.mean().item() - 8.9996) < 0.01   # E clip(9 + 0.5 Z, 0, 10)
    again = randaug.draw_rand_augment(torch.Generator().manual_seed(25), n, cfg)
    assert all(torch.equal(a, b) for a, b in zip(d, again))


def test_pipeline_draws_randaugment_last():
    """RandAugment's draws come after every other op's, so V4's draws do not
    move when it is turned on; with it off the field is None."""
    _, cfg = both_cfgs()
    _, on = both_cfgs(use_randaugment=True)
    shape = (4, 24, 32, 3)
    off_d = draw_train_augment(torch.Generator().manual_seed(26), shape, aug_configs_from(cfg))
    on_d = draw_train_augment(torch.Generator().manual_seed(26), shape, aug_configs_from(on))
    assert off_d.randaug is None and on_d.randaug is not None
    flat = [jax.tree_util.tree_leaves(x[:5], is_leaf=lambda v: isinstance(v, torch.Tensor))
            for x in (off_d, on_d)]
    assert all(torch.equal(p, q) for p, q in zip(*flat))
