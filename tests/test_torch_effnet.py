"""The port's EfficientNet, its BatchNorm, dropout and drop-path against the
JAX package's, in f32 on the CPU, on the same weights (moved by
``efficientnet_state_dict_from_jax``) and the same numpy inputs.

flax draws its masks inside ``make_rng("dropout")``; these tests capture
them by wrapping ``jax.random.bernoulli`` (unjitted: the masks in call
order), or hand both sides the same masks by replacing it (under ``jit``),
and give the port the same masks through ``layers.drop_masks``.

Tolerances: f32 on both sides, sums in another order (cuDNN-free CPU convs
against XLA's), through up to ~20 conv + BN layers. BatchNorm renormalises
each layer, so errors do not grow with depth: logits and features agree to
~1e-6 absolute, running statistics to ~1e-7 relative; the bounds are 1e-4
and 1e-5.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from image_classification_tpu.models.efficientnet import EfficientNet as JaxEffNet
from image_classification_tpu.models.efficientnet import StageSpec as JaxStageSpec
from image_classification_tpu.models.efficientnet import build_efficientnet as jax_build
from image_classification_tpu.models.layers import DropPath as JaxDropPath
from image_classification_tpu.models.layers import drop_path_rates as jax_drop_path_rates
from image_classification_tpu.models.pretrained import export_efficientnet
from image_classification_tpu_torch.models.efficientnet import (
    EfficientNet,
    StageSpec,
    build_efficientnet,
)
from image_classification_tpu_torch.models.layers import (
    BatchNorm,
    DropPath,
    Dropout,
    drop_masks,
    drop_path_rates,
    drop_sites,
    same_pads,
)
from image_classification_tpu_torch.models.pretrained import (
    efficientnet_state_dict_from_jax,
    load_checkpoint_into,
)
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

NUM_CLASSES = 7
TOL = 1e-4
STATS_RTOL = 1e-5
# (expand, channels, blocks, stride, kernel, fused, se), stem 16, at 44x36:
# ConvBnAct with residuals; EdgeResidual + SE, k3/2 on 22x18 (even); a
# depthwise-separable k5 block with SE and a residual; InvertedResidual +
# SE, k5/2 on 11x9 (odd); InvertedResidual without SE, k3/2 on 6x5.
STAGES = ((1, 16, 2, 1, 3, True, False), (4, 24, 2, 2, 3, True, True),
          (1, 24, 1, 1, 5, False, True), (6, 32, 2, 2, 5, False, True),
          (3, 40, 1, 2, 3, False, False))
HW = (44, 36)
STEM, HEAD = 16, 64


def jax_small(drop_rate=0.0, drop_path_rate=0.0):
    return JaxEffNet(num_classes=NUM_CLASSES, stages=tuple(JaxStageSpec(*s) for s in STAGES),
                     stem_ch=STEM, head_ch=HEAD, drop_rate=drop_rate,
                     drop_path_rate=drop_path_rate, dtype=jnp.float32)


def port_small(drop_rate=0.0, drop_path_rate=0.0, dtype=torch.float32):
    return EfficientNet(NUM_CLASSES, tuple(StageSpec(*s) for s in STAGES), STEM, HEAD,
                        drop_rate, drop_path_rate, dtype)


def randomized(variables, seed=1):
    """flax init, then BN scale/bias, conv biases and the running
    statistics redrawn from a numpy seed, so eval mode is not the identity
    normalisation."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name, shape = jax.tree_util.keystr(path), np.shape(leaf)
        if "scale" in name:
            return (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        if "bias" in name or "'mean'" in name:
            return (0.2 * rng.normal(size=shape)).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(redraw, jax.tree.map(np.asarray, variables))


@pytest.fixture(scope="module")
def small():
    jm = jax_small(0.3, 0.25)
    variables = randomized(jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, *HW, 3))))
    x = np.random.default_rng(2).normal(size=(4, *HW, 3)).astype(np.float32)
    return jm, variables, x


def load_port(model, variables):
    model.load_state_dict(efficientnet_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    return model


class BernoulliCapture:
    """Wraps ``jax.random.bernoulli`` and records its results in call
    order (unjitted callers only)."""

    def __init__(self, monkeypatch):
        self.masks = []
        real = jax.random.bernoulli

        def capture(*args, **kwargs):
            out = real(*args, **kwargs)
            self.masks.append(np.asarray(out))
            return out

        monkeypatch.setattr(jax.random, "bernoulli", capture)


def inject_bernoulli(monkeypatch, masks):
    """Replace ``jax.random.bernoulli`` by the given masks, in turn (traced
    callers see them as constants)."""
    calls = []

    def fixed(key, p=0.5, shape=None, **kwargs):
        m = masks[len(calls) % len(masks)]
        calls.append(1)
        return jnp.asarray(np.asarray(m).reshape(shape))

    monkeypatch.setattr(jax.random, "bernoulli", fixed)
    return calls


def port_masks(masks, sites):
    return tuple(torch.from_numpy(m.reshape(s.mask_shape(m.shape[0])))
                 for m, s in zip(masks, sites))


def close(ours, theirs, atol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=0, atol=atol,
                               err_msg=what)


def stats_of(model) -> dict:
    return {k: v.numpy() for k, v in model.state_dict().items() if "running_" in k}


def jax_stats(variables) -> dict:
    sd = efficientnet_state_dict_from_jax(variables["params"], variables["batch_stats"])
    return {k: v.numpy() for k, v in sd.items() if "running_" in k}


# ------------------------------------------------------------------ layers
def test_same_pads_are_flax_same():
    """Stride-2 convs on even sides pad more at the bottom/right."""
    assert same_pads(60, 3, 2) == (0, 1) and same_pads(30, 5, 2) == (1, 2)
    assert same_pads(61, 3, 2) == (1, 1) and same_pads(31, 5, 2) == (2, 2)
    assert same_pads(17, 3, 1) == (1, 1) and same_pads(9, 1, 1) == (0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_flax(dtype):
    """Train mode: output, the input and parameter gradients (the port's
    closed-form backward against autodiff of flax's), the running
    statistics after (biased variance, momentum 0.9, eps 1e-3); then eval
    mode on the updated statistics. Channel 0 is a constant 4.1 + a 1e-4
    ripple, whose E[x^2] - E[x]^2 rounds below 0 in f32 and is clipped.
    bf16: the output within one bf16 ulp of flax's, the statistics (f32
    from the bf16 input) to 1e-6."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 4, 6)).astype(np.float32) * 2 + 0.5
    x[..., 0] = 4.1 + 1e-4 * rng.normal(size=x.shape[:-1])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(x, jdt)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3, dtype=jdt)
    scale = (1 + 0.3 * rng.normal(size=6)).astype(np.float32)
    bias = (0.3 * rng.normal(size=6)).astype(np.float32)
    mean0 = (0.1 * rng.normal(size=6)).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 6).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}
    gy = rng.normal(size=x.shape).astype(np.float32)

    def f(params, xx):
        y, upd = bn.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return y, upd

    y_j, pull = jax.vjp(lambda p, xx: f(p, xx)[0], v["params"], xj)
    upd = f(v["params"], xj)[1]["batch_stats"]
    gp_j, gx_j = pull(jnp.asarray(gy, jdt))

    m = BatchNorm(6)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = m.train()(xt)
    assert y.dtype == tdt and m.running_var.dtype == torch.float32
    y.backward(torch.from_numpy(gy).to(tdt))
    if dtype == "float32":
        close(y.detach().numpy(), y_j, 1e-5, "y")
        close(xt.grad.numpy(), gx_j, 1e-4, "dx")
        close(m.weight.grad.numpy(), gp_j["scale"], 1e-4, "dscale")
        close(m.bias.grad.numpy(), gp_j["bias"], 1e-4, "dbias")
    else:
        ours, theirs = y.detach().float().numpy(), np.asarray(y_j, np.float32)
        assert np.all(np.abs(ours - theirs) <= 2.0 ** -7 * np.abs(theirs) + 1e-6)
    np.testing.assert_allclose(m.running_mean.numpy(), upd["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), upd["var"], rtol=1e-6, atol=1e-7)
    # eval mode, on the statistics just updated
    bn_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-3,
                            dtype=jnp.float32)
    y_e = bn_eval.apply({"params": v["params"], "batch_stats": upd}, jnp.asarray(x))
    with torch.no_grad():
        close(m.eval()(torch.from_numpy(x)).numpy(), y_e, 1e-5, "eval")


def test_batchnorm_clips_negative_variance():
    """A constant channel's E[x^2] - E[x]^2 rounds below 0 in f32 for some
    constants: flax clips it to 0, so the running variance only decays."""
    x = np.full((2, 3, 3, 1), 0.1, np.float32)
    xf = torch.from_numpy(x)
    raw = float((xf * xf).mean() - xf.mean() ** 2)
    m = BatchNorm(1).train()
    m(xf)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    _, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    assert float(m.running_var[0]) == pytest.approx(float(upd["batch_stats"]["var"][0]))
    assert float(m.running_var[0]) == pytest.approx(0.9) and raw != 0.0


def test_drop_layers_and_rates_match_jax(monkeypatch):
    """DropPath (one mask entry per sample) and flax Dropout (one per
    element) on masks captured from JAX; ``drop_path_rates``; eval mode
    and rate 0 are the identity."""
    cap = BernoulliCapture(monkeypatch)
    x = np.random.default_rng(4).normal(size=(6, 3, 2, 5)).astype(np.float32)
    f = np.random.default_rng(5).normal(size=(6, 9)).astype(np.float32)
    y_dp = JaxDropPath(0.3).apply({}, jnp.asarray(x), deterministic=False,
                                  rngs={"dropout": jax.random.key(1)})
    y_do = fnn.Dropout(0.4).apply({}, jnp.asarray(f), deterministic=False,
                                  rngs={"dropout": jax.random.key(2)})
    assert len(cap.masks) == 2
    dp, do = DropPath(0.3).train(), Dropout(0.4, 9).train()
    with drop_masks([dp, do], port_masks(cap.masks, [dp, do])):
        close(dp(torch.from_numpy(x)).numpy(), y_dp, 1e-6, "drop path")
        close(do(torch.from_numpy(f)).numpy(), y_do, 1e-6, "dropout")
    assert dp.mask is None
    with pytest.raises(RuntimeError, match="keep-mask"):
        dp(torch.from_numpy(x))
    assert torch.equal(dp.eval()(torch.from_numpy(x)), torch.from_numpy(x))
    assert drop_path_rates(0.1, (2, 3, 1)) == jax_drop_path_rates(0.1, (2, 3, 1))


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_small_efficientnet_matches_jax(small, mode, monkeypatch):
    """Every block form, SE on and off, k3 and k5 at stride 2 on odd and
    even sides, residuals with drop-path (rate 0.25 over 8 blocks) and head
    dropout (0.3): logits and the last three stages' features, and in
    train mode the running statistics after the forward."""
    jm, variables, x = small
    model = load_port(port_small(0.3, 0.25), variables)
    sites = drop_sites(model)
    assert [type(s).__name__ for s in sites] == ["DropPath"] * 4 + ["Dropout"]
    if mode == "eval":
        logits_j, feats_j = jax.jit(lambda v, xx: jm.apply(
            v, xx, deterministic=True, return_features=True))(variables, jnp.asarray(x))
        with torch.no_grad():
            logits, feats = model.eval()(torch.from_numpy(x), return_features=True)
    else:
        cap = BernoulliCapture(monkeypatch)
        (logits_j, feats_j), upd = jm.apply(
            variables, jnp.asarray(x), deterministic=False, return_features=True,
            rngs={"dropout": jax.random.key(7)}, mutable=["batch_stats"])
        assert len(cap.masks) == len(sites)
        assert any(not m.all() for m in cap.masks)
        model.train()
        with torch.no_grad(), drop_masks(sites, port_masks(cap.masks, sites)):
            logits, feats = model(torch.from_numpy(x), return_features=True)
        ours, theirs = stats_of(model), jax_stats({"params": variables["params"], **upd})
        assert set(ours) == set(theirs)
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=STATS_RTOL, atol=1e-6,
                                       err_msg=k)
    close(logits.numpy(), logits_j, what="logits")
    assert [f.shape[-1] for f in feats] == [24, 32, 40] == list(model.feature_dims)
    for a, b in zip(feats, feats_j):
        close(a.numpy(), b, what="features")


def test_efficientnet_b0_at_full_width_through_the_carrier():
    """B0 at 32 px (44 classes, 16 blocks, every V1 width): the carrier's
    keys and tensors equal ``export_efficientnet``'s and load strictly;
    eval logits agree."""
    jm = jax_build("efficientnet_b0", 44, drop_rate=0.0, dtype=jnp.float32)
    variables = randomized(jax.jit(jm.init)(jax.random.key(1), jnp.zeros((1, 32, 32, 3))))
    sd = efficientnet_state_dict_from_jax(variables["params"], variables["batch_stats"])
    ref = export_efficientnet(variables["params"], variables["batch_stats"])
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert np.array_equal(sd[k].numpy(), v), k
    model = build_efficientnet("efficientnet_b0", 44, drop_rate=0.0, dtype=torch.float32)
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(np.float32)
    logits_j = jax.jit(lambda v, xx: jm.apply(v, xx))(variables, jnp.asarray(x))
    with torch.no_grad():
        close(model.eval()(torch.from_numpy(x)).numpy(), logits_j, what="b0 logits")


@pytest.mark.parametrize("name", ["tf_efficientnetv2_s_in21ft1k", "efficientnet_b3"])
def test_state_dict_keys_and_shapes_match_export(name):
    """Key and shape agreement with ``export_efficientnet`` at full size
    (shapes only: ``jax.eval_shape``)."""
    jm = jax_build(name, 44, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = export_efficientnet(zeros["params"], zeros["batch_stats"])
    ours = build_efficientnet(name, 44).state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


def test_timm_checkpoint_with_num_batches_tracked_loads(small, tmp_path):
    """A timm-keyed EfficientNet checkpoint carries ``num_batches_tracked``:
    ``load_checkpoint_into`` skips it (as ``import_efficientnet`` does), and
    a strict ``load_state_dict`` drops it; ``strip_head`` keeps the
    classifier's init."""
    _, variables, _ = small
    sd = efficientnet_state_dict_from_jax(variables["params"], variables["batch_stats"])
    timm = dict(sd)
    for k in list(sd):
        if k.endswith("running_var"):
            timm[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    torch.save({"state_dict": timm}, tmp_path / "timm.pth")
    port_small().load_state_dict(timm, strict=True)
    for strip in (False, True):
        model = port_small()
        head = {k: v.clone() for k, v in model.state_dict().items() if "classifier" in k}
        n = load_checkpoint_into(model, str(tmp_path / "timm.pth"), strip_head=strip)
        assert n == len(sd) - 2 * strip
        got = model.state_dict()
        for k, v in sd.items():
            want = head[k] if strip and k.startswith("classifier") else v
            assert torch.equal(got[k], want), k
