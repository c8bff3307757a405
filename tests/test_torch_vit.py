"""The port's ViT/DeiT and ConvNeXt's drop-path, head dropout and tanh-GELU
route against the JAX package's models, in f32 on the CPU, on the same
weights (moved by the port's carriers) and the same numpy inputs. Masks are
drawn from a numpy seed in place of ``jax.random.bernoulli`` under ``jit``
(:class:`MaskInjector`, which records the masks in the order and shapes JAX
asks for them) and handed to the port through ``layers.drop_masks``.

Tolerances: f32 on both sides with sums in another order (one matmul per
product in the port, XLA's einsums in JAX). Forward outputs are held to 1e-5
and gradients to 1e-4 of each tensor's largest element; they agreed to
~1e-6 and ~1e-6 relative.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.models.convnext import build_convnext as jax_build_convnext
from image_classification_tpu.models.deep_supervision import (
    DeepSupervisionModel as JaxDeepSupervision,
)
from image_classification_tpu.models.factory import create_model as jax_create_model
from image_classification_tpu.models.factory import list_models as jax_list_models
from image_classification_tpu.models.pretrained import (
    import_vit,
    load_checkpoint_into_variables,
)
from image_classification_tpu.models.vit import VisionTransformer as JaxViT
from image_classification_tpu.models.vit import build_vit as jax_build_vit
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.models import convnext as port_convnext
from image_classification_tpu_torch.models.convnext import build_convnext
from image_classification_tpu_torch.models.deep_supervision import DeepSupervisionModel
from image_classification_tpu_torch.models.factory import create_model, list_models
from image_classification_tpu_torch.models.layers import (
    AttentionDropout,
    Dropout,
    DropPath,
    drop_masks,
    drop_sites,
)
from image_classification_tpu_torch.models.pretrained import (
    convnext_state_dict_from_jax,
    load_checkpoint_into,
    state_dict_from_jax,
    vit_state_dict_from_jax,
)
from image_classification_tpu_torch.models.vit import VisionTransformer, build_vit
from test_torch_effnet import port_masks
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

NUM_CLASSES = 7
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
SMALL = dict(patch=8, dim=32, heads=4)
HW = (32, 24)             # 4 x 3 patches + the cls token = 13 tokens


def randomized(variables, seed=1):
    """flax's init with the LN scales, every bias and ConvNeXt's layer
    scale redrawn from a numpy seed, so no layer is the identity."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name, shape = jax.tree_util.keystr(path), np.shape(leaf)
        if "scale" in name:
            return (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.normal(size=shape)).astype(np.float32)
        if "gamma" in name:
            return rng.uniform(0.3, 0.7, shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(redraw, jax.tree.map(np.asarray, variables))


def rel_close(ours, theirs, tol, what=""):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape, (what, ours.shape, theirs.shape)
    scale = max(float(np.abs(theirs).max()), 1e-6)
    err = float(np.abs(ours - theirs).max())
    assert err <= tol * scale, f"{what}: max |d| {err} > {tol} x {scale}"


def jax_vit(depth, drop_rate=0.0, drop_path_rate=0.0):
    return JaxViT(num_classes=NUM_CLASSES, depth=depth, drop_rate=drop_rate,
                  drop_path_rate=drop_path_rate, dtype=jnp.float32, **SMALL)


def port_vit(depth, drop_rate=0.0, drop_path_rate=0.0, image_size=HW):
    return VisionTransformer(num_classes=NUM_CLASSES, depth=depth, drop_rate=drop_rate,
                             drop_path_rate=drop_path_rate, dtype=torch.float32,
                             image_size=image_size, **SMALL)


def inputs(seed=2, n=4, hw=HW):
    return np.random.default_rng(seed).normal(size=(n, *hw, 3)).astype(np.float32)


def init(module, x, seed=0):
    return randomized(jax.jit(module.init)(jax.random.key(seed), jnp.asarray(x[:1])))


class MaskInjector:
    """Replaces ``jax.random.bernoulli``: each call (at trace time under
    ``jit``) gets a keep-mask of the shape it asks for, ``uniform < p`` from
    a numpy seed, recorded in call order."""

    def __init__(self, monkeypatch, seed):
        rng = np.random.default_rng(seed)
        self.masks = []

        def draw(key, p=0.5, shape=None, **kwargs):
            m = rng.uniform(size=shape) < float(p)
            self.masks.append(m)
            return jnp.asarray(m)

        monkeypatch.setattr(jax.random, "bernoulli", draw)


def port_grads(model) -> dict[str, np.ndarray]:
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def loss_weights(n, seed=9):
    return np.random.default_rng(seed).normal(size=(n, NUM_CLASSES)).astype(np.float32)


# ------------------------------------------------------------------- ViT
@pytest.mark.parametrize("depth,taps", [(2, 1), (4, 2)])
def test_vit_forward_and_deep_supervision_match_jax(depth, taps):
    """Eval mode: the bare ViT's logits and taps, then the deep-supervised
    model's main and aux logits (mean over tokens); the tap count follows
    the set {depth//2, 3 depth//4, depth - 1}."""
    x = inputs()
    jm = JaxDeepSupervision(backbone=jax_vit(depth), num_classes=NUM_CLASSES)
    variables = init(jm, x)
    outs_j = jax.jit(jm.apply)(variables, jnp.asarray(x))
    bare = jax_vit(depth)
    logits_j, feats_j = jax.jit(lambda p, xx: bare.apply(
        {"params": p}, xx, return_features=True))(variables["params"]["backbone"],
                                                  jnp.asarray(x))
    model = DeepSupervisionModel(port_vit(depth), NUM_CLASSES)
    model.load_state_dict(state_dict_from_jax(variables["params"]), strict=True)
    with torch.no_grad():
        outs = model.eval()(torch.from_numpy(x))
        logits, feats = model.backbone(torch.from_numpy(x), return_features=True)
    assert len(outs) == len(outs_j) == 1 + taps and len(feats) == taps
    assert model.backbone.feature_dims == (SMALL["dim"],) * taps
    rel_close(logits.numpy(), logits_j, FWD_TOL, "logits")
    for a, b in zip(feats, feats_j):
        rel_close(a.numpy(), b, FWD_TOL, "tap")
    for i, (a, b) in enumerate(zip(outs, outs_j)):
        rel_close(a.numpy(), b, FWD_TOL, f"output {i}")


def test_vit_taps_are_a_set():
    with torch.device("meta"):
        assert [len(build_vit(n, 3, image_size=(32, 32)).taps)
                for n in ("vit_tiny_patch16_224", "vit_large_patch16_224")] == [3, 3]
    assert port_vit(12).taps == [6, 9, 11] and port_vit(4).taps == [2, 3]
    assert port_vit(2).taps == [1]


def test_vit_train_forward_on_jax_masks(monkeypatch):
    """Train mode with token dropout, attention dropout and drop-path (two
    DropPaths a block): the port's sites in JAX's draw order (shapes
    (B, N, D), then per block (1, 1, N, N) and (B,) twice; block 0's
    drop-path rate is 0, so it draws no DropPath), and the logits on the
    same masks."""
    depth, x = 4, inputs(3)
    jm = jax_vit(depth, drop_rate=0.3, drop_path_rate=0.5)
    variables = init(jm, x)
    cap = MaskInjector(monkeypatch, seed=5)
    logits_j = jax.jit(lambda v, xx: jm.apply(v, xx, deterministic=False, rngs={
        "dropout": jax.random.key(5)}))(variables, jnp.asarray(x))
    model = port_vit(depth, 0.3, 0.5)
    model.load_state_dict(vit_state_dict_from_jax(variables["params"]), strict=True)
    sites = drop_sites(model)
    B, N, D = x.shape[0], 13, SMALL["dim"]
    kinds = [type(s).__name__ for s in sites]
    assert kinds == (["Dropout", "AttentionDropout"]
                     + ["AttentionDropout", "DropPath", "DropPath"] * (depth - 1))
    assert [m.shape for m in cap.masks] == [s.mask_shape(B) if isinstance(s, Dropout)
                                            else (1, 1, N, N) if isinstance(s, AttentionDropout)
                                            else (B, 1, 1) for s in sites]
    assert sites[0].mask_shape(B) == (B, N, D)
    assert all(not m.all() for m in cap.masks[:2])
    model.train()
    with torch.no_grad(), drop_masks(sites, port_masks(cap.masks, sites)):
        logits = model(torch.from_numpy(x))
    rel_close(logits.numpy(), logits_j, FWD_TOL, "train-mode logits")
    with pytest.raises(RuntimeError, match="keep-mask"):
        model(torch.from_numpy(x))
    with torch.no_grad():   # eval mode: no masks, the identity
        rel_close(model.eval()(torch.from_numpy(x)).numpy(),
                  jax.jit(jm.apply)(variables, jnp.asarray(x)), FWD_TOL, "eval logits")


def test_attention_dropout_is_flax_arithmetic():
    """``weights * (keep / keep_prob)`` with the multiplier in the weights'
    dtype, one (1, 1, N, N) mask for every sample and head, against
    ``dot_product_attention_weights`` on the same mask."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)
    k = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)
    keep = rng.uniform(size=(1, 1, 5, 5)) < 0.7

    def fixed(key, p=0.5, shape=None, **kw):
        assert tuple(shape) == keep.shape
        return jnp.asarray(keep)

    real = jax.random.bernoulli
    jax.random.bernoulli = fixed
    try:
        w_j = fnn.attention.dot_product_attention_weights(
            jnp.asarray(q), jnp.asarray(k), dropout_rng=jax.random.key(0),
            dropout_rate=0.3, deterministic=False)
    finally:
        jax.random.bernoulli = real
    for dtype in (torch.float32, torch.bfloat16):
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk",
                                       torch.from_numpy(q) / 2.0,
                                       torch.from_numpy(k)), dim=-1).to(dtype)
        site = AttentionDropout(0.3, 5).train()
        with drop_masks([site], (torch.from_numpy(keep),)):
            out = site(w)
        assert out.dtype == dtype
        inv = float(torch.tensor(1.0, dtype=dtype) / torch.tensor(0.7, dtype=dtype))
        assert torch.equal(out, w * torch.from_numpy(keep).to(dtype) * inv)
        if dtype == torch.float32:
            rel_close(out.numpy(), w_j, FWD_TOL, "attention weights")


def test_vit_gradients_match_jax(monkeypatch):
    """The gradient of sum(logits * R) with every drop site live, against
    ``jax.grad`` of the same loss (jitted) on the same masks."""
    depth, x = 4, inputs(6)
    jm = jax_vit(depth, drop_rate=0.2, drop_path_rate=0.4)
    variables = init(jm, x)
    r = loss_weights(x.shape[0])
    cap = MaskInjector(monkeypatch, seed=8)

    def loss_j(params):
        logits = jm.apply({"params": params}, jnp.asarray(x), deterministic=False,
                          rngs={"dropout": jax.random.key(8)})
        return jnp.sum(logits * r)

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(variables["params"])
    model = port_vit(depth, 0.2, 0.4)
    model.load_state_dict(vit_state_dict_from_jax(variables["params"]), strict=True)
    sites = drop_sites(model)
    assert len(cap.masks) == len(sites)
    model.train()
    with drop_masks(sites, port_masks(cap.masks, sites)):
        loss = (model(torch.from_numpy(x)) * torch.from_numpy(r)).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(lj), rel=FWD_TOL, abs=FWD_TOL)
    ref = vit_state_dict_from_jax(jax.tree.map(np.asarray, gj))
    ours = port_grads(model)
    assert set(ours) == set(ref)
    for name, g in ref.items():
        rel_close(ours[name], g.numpy(), GRAD_TOL, name)


def test_vit_size_rule_matches_jax():
    """60x80 at patch 16 raises in both packages (the port's ValueError
    names the size and the patch; JAX's reshape raises TypeError); 64x80
    builds in both, with 21 tokens."""
    jm = JaxViT(num_classes=3, patch=16, dim=32, depth=1, heads=4, dtype=jnp.float32)
    with pytest.raises(TypeError):
        jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 60, 80, 3)))
    with pytest.raises(ValueError, match=r"60x80.*16"):
        VisionTransformer(3, 16, 32, 1, 4, image_size=(60, 80))
    cfg = Config(model_name="vit_base_patch16_224", image_size=(60, 80)).validate()
    with pytest.raises(ValueError, match="60x80"):
        create_model(cfg)
    v = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 64, 80, 3)))
    port = VisionTransformer(3, 16, 32, 1, 4, image_size=(64, 80))
    assert tuple(port.pos_embed.shape) == v["params"]["pos_embed"].shape == (1, 21, 32)


def timm_vit_state_dict(depth, tokens, seed=11) -> dict[str, np.ndarray]:
    g = np.random.default_rng(seed)
    d, c = SMALL["dim"], NUM_CLASSES

    def r(*shape):
        return g.normal(size=shape).astype(np.float32)

    sd = {"cls_token": r(1, 1, d), "pos_embed": r(1, tokens, d),
          "patch_embed.proj.weight": r(d, 3, 8, 8), "patch_embed.proj.bias": r(d),
          "norm.weight": r(d), "norm.bias": r(d), "head.weight": r(c, d), "head.bias": r(c)}
    for i in range(depth):
        sd.update({f"blocks.{i}.{k}": r(*s) for k, s in (
            ("norm1.weight", (d,)), ("norm1.bias", (d,)),
            ("attn.qkv.weight", (3 * d, d)), ("attn.qkv.bias", (3 * d,)),
            ("attn.proj.weight", (d, d)), ("attn.proj.bias", (d,)),
            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
            ("mlp.fc1.weight", (4 * d, d)), ("mlp.fc1.bias", (4 * d,)),
            ("mlp.fc2.weight", (d, 4 * d)), ("mlp.fc2.bias", (d,)))})
    return sd


def test_vit_carrier_inverts_import_vit():
    """timm keys -> JAX ``import_vit`` -> ``vit_state_dict_from_jax``
    gives every tensor back, to the bit; the tree loads strictly."""
    jm = jax_vit(2)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    sd = timm_vit_state_dict(2, 17)
    params, n = import_vit(sd, jax.tree.map(np.asarray, variables["params"]))
    assert n == len(sd) + 2 * 4   # qkv weight and bias each fill q, k, v
    back = vit_state_dict_from_jax(params)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert np.array_equal(back[k].numpy(), v), k
    port_vit(2, image_size=(32, 32)).load_state_dict(back, strict=True)


@pytest.mark.parametrize("strip,hw", [(False, (32, 32)), (True, (32, 32)),
                                      (False, HW)])
def test_vit_checkpoint_loads_as_jax(strip, hw, tmp_path):
    """``load_checkpoint_into`` of a timm-keyed ViT file (with and without
    ``strip_head``; at 32x24 its 17-token ``pos_embed`` is skipped with a
    warning) gives the model that JAX's ``load_checkpoint_into_variables``
    gives, carried over."""
    jm = jax_vit(2)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(3),
                                                          jnp.zeros((1, *hw, 3))))
    sd = timm_vit_state_dict(2, 17, seed=12)
    path = str(tmp_path / "vit.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    loaded = load_checkpoint_into_variables(path, variables, "vit_tiny_patch16_224",
                                            strip_head=strip)
    model = port_vit(2, image_size=hw)
    model.load_state_dict(vit_state_dict_from_jax(variables["params"]), strict=True)
    n = load_checkpoint_into(model, path, strip_head=strip)
    assert n == len(sd) - 2 * strip - (hw != (32, 32))
    want = vit_state_dict_from_jax(loaded["params"])
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# --------------------------------------------------------------- factory
def test_list_models_matches_jax():
    assert list_models() == jax_list_models()


@pytest.mark.parametrize("name", jax_list_models() + ["vit_base_patch16_224.augreg_in21k"])
def test_create_model_builds_every_name(name):
    """Shapes only (the meta device): every name JAX lists builds, with
    deep supervision; ViT sizes its position embedding from image_size."""
    cfg = Config(model_name=name, num_classes=44, image_size=(64, 32),
                 drop_rate=0.1, drop_path_rate=0.1).validate()
    with torch.device("meta"):
        bundle = create_model(cfg)
    assert bundle.deep_supervised and bundle.name == name
    if name.startswith(("vit_", "deit_")):
        vit = bundle.module.backbone
        assert tuple(vit.pos_embed.shape) == (1, 4 * 2 + 1, vit.dim)
        assert not bundle.has_batch_stats


@pytest.mark.parametrize("name", ["deit_base_patch16_224",
                                  "vit_base_patch16_224.augreg_in21k"])
def test_vit_b_keys_and_shapes_match_jax(name):
    """ViT-B/16 and DeiT-B/16 at 224 with deep supervision: the carrier's
    keys and shapes on JAX's tree (``jax.eval_shape``) are the port's."""
    jcfg = JaxConfig(model_name=name, image_size=(224, 224)).validate()
    shapes = jax.eval_shape(jax_create_model(jcfg).init, jax.random.key(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    ref = state_dict_from_jax(zeros)
    with torch.device("meta"):
        ours = create_model(Config(model_name=name, image_size=(224, 224)).validate())
    assert {k: tuple(v.shape) for k, v in ours.module.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert ref["backbone.pos_embed"].shape == (1, 197, 768)
    assert jax_build_vit(name, 44).depth == len(ours.module.backbone.blocks) == 12


# --------------------------------------------- ConvNeXt's drop and tanh routes
ATTO = "convnext_atto"
CNX_HW = (32, 32)


class CountingBlockMlp:
    """Counts the fused block-tail calls (``models/convnext.py`` imports
    ``ops.block_mlp`` by name)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = port_convnext.block_mlp

        def counted(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(port_convnext, "block_mlp", counted)


@pytest.mark.parametrize("over", [dict(drop_path_rate=0.1, drop_rate=0.2),
                                  dict(gelu_approximate=True)])
def test_convnext_drop_and_tanh_routes_match_jax(over, monkeypatch):
    """ConvNeXt-atto with drop-path and head dropout (train mode, on the
    masks JAX asked for, in its order: 11 DropPaths, block 0's rate being
    0, then the head's Dropout), and with tanh GELU (no sites): logits and
    the gradient of sum(logits * R) against ``jax.grad`` (jitted), then
    eval mode. Routing: with drop-path only block 0 takes the fused tail;
    with tanh GELU none."""
    x = inputs(7, hw=CNX_HW)
    jm = jax_build_convnext(ATTO, NUM_CLASSES, dtype=jnp.float32, **over)
    variables = init(jm, x)
    r = loss_weights(x.shape[0])
    cap = MaskInjector(monkeypatch, seed=4)

    def loss_j(params):
        logits = jm.apply({"params": params}, jnp.asarray(x), deterministic=False,
                          rngs={"dropout": jax.random.key(4)})
        return jnp.sum(logits * r), logits

    (lj, logits_j), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        variables["params"])
    model = build_convnext(ATTO, NUM_CLASSES, dtype=torch.float32, **over)
    model.load_state_dict(convnext_state_dict_from_jax(variables["params"]), strict=True)
    sites = drop_sites(model)
    blocks = [b for s in model.stages for b in s.blocks]
    if "drop_path_rate" in over:
        assert [type(s).__name__ for s in sites] == ["DropPath"] * 11 + ["Dropout"]
        assert [m.shape for m in cap.masks] == [(4, 1, 1, 1)] * 11 + [(4, 320)]
        assert [b.fused for b in blocks] == [True] + [False] * 11
    else:
        assert sites == [] and cap.masks == [] and not any(b.fused for b in blocks)
    counter = CountingBlockMlp(monkeypatch)
    model.train()
    with drop_masks(sites, port_masks(cap.masks, sites)):
        logits = model(torch.from_numpy(x))
    assert counter.calls == (1 if "drop_path_rate" in over else 0)
    loss = (logits * torch.from_numpy(r)).sum()
    loss.backward()
    rel_close(logits.detach().numpy(), logits_j, FWD_TOL, "logits")
    assert float(loss.detach()) == pytest.approx(float(lj), rel=FWD_TOL, abs=FWD_TOL)
    ref = convnext_state_dict_from_jax(jax.tree.map(np.asarray, gj))
    ours = port_grads(model)
    for name, g in ref.items():
        rel_close(ours[name], g.numpy(), GRAD_TOL, name)
    with torch.no_grad():
        rel_close(model.eval()(torch.from_numpy(x)).numpy(),
                  jax.jit(jm.apply)(variables, jnp.asarray(x)), FWD_TOL, "eval logits")


def test_drop_path_is_per_sample_on_the_map():
    """The composed route's DropPath acts on the (B, H, W, C) view: one mask
    entry per sample, as JAX reshapes to 4-D before it."""
    block = port_convnext.ConvNeXtBlock(8, drop_path=0.5).train()
    assert block.drop_path.mask_shape(3) == (3,) and isinstance(block.drop_path, DropPath)
    x = torch.randn(3, 5, 4, 8, generator=torch.Generator().manual_seed(0))
    with drop_masks([block.drop_path], (torch.tensor([True, False, True]),)):
        y = block(x)
    assert torch.equal(y[1], x[1]) and not torch.equal(y[0], x[0])
