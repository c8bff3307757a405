"""``block_remat`` on the port's ConvNeXt against the JAX package's, in f32
on the CPU at ``convnext_atto`` size and 32 px.

``"dots"`` and ``"full"`` change only what a block keeps for its backward,
so the loss and every gradient equal ``"none"``'s: against JAX's model in
the same mode (``tests/test_models.py:test_block_remat_matches`` holds
JAX's modes to one another), with drop-path masks, and in the port
against ``"none"`` through ``make_train_step`` under accumulation 2, the
case where a recompute in the backward must see the mask of its own
microbatch's forward.

Tolerances: JAX against the port is f32 on both sides with sums in another
order, at rtol 1e-5 and atol 1e-5 (the loss agreed to ~1e-7 relative, the
gradients to ~1e-6); the port's modes against one another are exact on the
CPU, held to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.models import convnext as port_convnext
from image_classification_tpu_torch.models.convnext import build_convnext
from image_classification_tpu_torch.models.factory import create_model
from image_classification_tpu_torch.models.layers import drop_masks, drop_sites
from image_classification_tpu_torch.models.pretrained import convnext_state_dict_from_jax
from image_classification_tpu_torch.train import loss as port_loss
from image_classification_tpu_torch.train import step as port_step
from image_classification_tpu_torch.train.loop import build_lr_schedule
from image_classification_tpu_torch.train.optim import build_optimizer
from image_classification_tpu_torch.train.train_state import create_train_state
from test_models import small_convnext
from test_torch_effnet import port_masks
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)
from test_torch_vit import MaskInjector, init, inputs, loss_weights
from torch_spawn import KernelCalls

ATTO = dict(depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
NUM_CLASSES = 7
HW = (32, 32)
MODES = ("none", "dots", "full")
DROP_PATH = 0.1
TOL = 1e-5          # JAX against the port
MODE_TOL = 1e-6     # the port's modes against one another


def port_run(params, x, r, mode, masks):
    """Loss and gradients of sum(logits * r) on the port's atto in train
    mode, on JAX's masks."""
    model = build_convnext("convnext_atto", NUM_CLASSES, dtype=torch.float32,
                           drop_path_rate=DROP_PATH, block_remat=mode)
    model.load_state_dict(convnext_state_dict_from_jax(params), strict=True)
    sites = drop_sites(model)
    model.train()
    with drop_masks(sites, port_masks(masks, sites)):
        logits = model(torch.from_numpy(x))
    loss = (logits * torch.from_numpy(r)).sum()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    names = [n for n, _ in model.named_parameters()]
    return float(loss.detach()), dict(zip(names, (g.numpy() for g in grads)))


@pytest.mark.parametrize("mode", MODES)
def test_remat_mode_matches_jax(mode, monkeypatch):
    """Each mode against JAX's ``small_convnext`` in the same mode, on the
    same weights and drop-path masks (rate 0.1): block 0, whose rate is 0,
    takes the fused tail, which ``"dots"`` recomputes whole, and every
    other block the composed one, whose matmuls ``"dots"`` keeps."""
    x = inputs(3, n=4, hw=HW)
    r = loss_weights(x.shape[0])
    jm = small_convnext(num_classes=NUM_CLASSES, block_remat=mode,
                        drop_path_rate=DROP_PATH, **ATTO)
    # remat leaves the parameter tree as it is
    params = init(small_convnext(num_classes=NUM_CLASSES, **ATTO), x)["params"]
    cap = MaskInjector(monkeypatch, seed=5)

    def loss_j(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), deterministic=False,
                          rngs={"dropout": jax.random.key(5)})
        return jnp.sum(logits * r)

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(params)
    assert len(cap.masks) == 11
    lp, gp = port_run(params, x, r, mode, cap.masks)
    ref = {k: v.numpy() for k, v in convnext_state_dict_from_jax(
        jax.tree.map(np.asarray, gj)).items()}
    assert set(ref) == set(gp)
    np.testing.assert_allclose(lp, float(lj), rtol=TOL, atol=TOL)
    for name, g in ref.items():
        np.testing.assert_allclose(gp[name], g, rtol=TOL, atol=TOL,
                                   err_msg=f"{mode} {name}")


def step_cfg(mode):
    return Config(
        model_name="convnext_atto", num_classes=NUM_CLASSES, image_size=HW,
        native_size=(24, 32), batch_size=8, gradient_accumulation_steps=2,
        aug_enabled=False, use_deep_supervision=True, compute_dtype="float32",
        drop_path_rate=DROP_PATH, use_ema=True, ema_decay=0.9, lr=1e-3, epochs=2,
        block_remat=mode).validate()


def run_step(mode, images, labels, monkeypatch):
    """One ``make_train_step`` from seed-0 weights on generator-1 draws:
    the gradients the fused update received, the loss and the parameters
    after it."""
    cfg = step_cfg(mode)
    bundle = create_model(cfg, generator=torch.Generator().manual_seed(0))
    tx = build_optimizer(cfg, build_lr_schedule(cfg, 4))
    state = create_train_state(bundle.module, use_ema=True)
    seen = {}
    real = port_step.fused_adamw_ema

    def capture(grads, *args, **kwargs):
        seen["grads"] = [g.clone() for g in grads]
        return real(grads, *args, **kwargs)

    monkeypatch.setattr(port_step, "fused_adamw_ema", capture)
    step = port_step.make_train_step(bundle, cfg, tx, port_loss.build_criterion(cfg))
    state, metrics = step(state, {"image": images, "label": labels},
                          generator=torch.Generator().manual_seed(1))
    return seen["grads"], float(metrics["loss"]), [p.detach().clone()
                                                   for p in bundle.module.parameters()]


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_train_step_with_drop_masks_matches_none(mode, monkeypatch):
    """Accumulation 2 with drop-path 0.1: each microbatch's masks are
    cleared when its forward's ``drop_masks`` block exits, before its
    backward recomputes the blocks, and the second microbatch's masks
    differ from the first's. A recompute that read the site's mask would
    raise, or take another microbatch's."""
    rng = np.random.default_rng(11)
    images = torch.from_numpy(rng.normal(size=(8, *HW, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=8))
    g0, l0, p0 = run_step("none", images, labels, monkeypatch)
    g1, l1, p1 = run_step(mode, images, labels, monkeypatch)
    assert l1 == pytest.approx(l0, rel=MODE_TOL)
    assert len(g0) == len(g1)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=MODE_TOL, atol=MODE_TOL)
    for a, b in zip(p1, p0):
        torch.testing.assert_close(a, b, rtol=MODE_TOL, atol=MODE_TOL)


@pytest.mark.parametrize("name", ["convnext_atto", "efficientnet_b0"])
@pytest.mark.parametrize("mode", MODES)
def test_factory_passes_block_remat(name, mode):
    """Every ConvNeXt block takes ``cfg.block_remat``, as JAX's factory
    passes it; EfficientNet has no blocks that take it, in JAX too."""
    cfg = Config(model_name=name, num_classes=NUM_CLASSES, image_size=HW,
                 block_remat=mode, use_deep_supervision=False).validate()
    module = create_model(cfg).module
    blocks = [m for m in module.modules() if isinstance(m, port_convnext.ConvNeXtBlock)]
    assert len(blocks) == (12 if name == "convnext_atto" else 0)
    assert all(b.block_remat == mode for b in blocks)


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the calls of each aten op under it."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_backward_recomputes_what_the_mode_drops(fused):
    """What each mode recomputes in the backward, counted by op: on the
    composed route ``"dots"`` runs no product again (both are kept) but
    LayerNorm again, ``"full"`` the products and the depthwise conv; on
    the fused route (on the CPU its plain version, LayerNorm's statistics
    by ``rsqrt``) both run the tail again, and ``"full"`` the conv."""
    block_rate = 0.0 if fused else 0.5
    x = torch.randn(2, 6, 5, 40, generator=torch.Generator().manual_seed(0))
    counts = {}
    for mode in MODES:
        torch.manual_seed(0)
        block = port_convnext.ConvNeXtBlock(40, drop_path=block_rate,
                                            block_remat=mode).train()
        assert block.fused == fused
        sites = drop_sites(block)
        masks = tuple(torch.tensor([True, False]) for _ in sites)
        with drop_masks(sites, masks):
            y = block(x.clone().requires_grad_())
        with _OpCounter() as c:
            y.sum().backward()
        counts[mode] = c.counts
    mm = torch.ops.aten.mm.default
    ln = torch.ops.aten.rsqrt.default if fused else torch.ops.aten.native_layer_norm.default
    conv = torch.ops.aten.convolution.default

    def extra(mode, op):
        return counts[mode].get(op, 0) - counts["none"].get(op, 0)

    assert extra("dots", ln) == extra("full", ln) == 1
    assert extra("dots", mm) == (2 if fused else 0) and extra("full", mm) == 2
    assert extra("dots", conv) == 0 and extra("full", conv) == 1


def test_remat_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="block_remat"):
        port_convnext.ConvNeXtBlock(8, block_remat="some")


@pytest.mark.parametrize("mode,drop_path_rate,freeze_stages", [
    ("none", 0.0, 0), ("dots", 0.0, 0), ("full", 0.0, 0),
    ("dots", DROP_PATH, 0), ("full", DROP_PATH, 0), ("full", DROP_PATH, 1)])
def test_launch_prediction_counts_the_recompute(mode, drop_path_rate, freeze_stages,
                                                monkeypatch):
    """``tools/parallel_check.py:model_launches``, which ``chip_smoke.py``
    holds the card's launch counts to, against the kernel entries one
    accumulation-2 step calls: the extra tail forwards of ``"dots"`` and
    ``"full"``, the extra depthwise forwards of ``"full"``, none in a
    frozen stage."""
    from image_classification_tpu_torch.tools.parallel_check import expected_launches

    cfg = step_cfg(mode).replace(drop_path_rate=drop_path_rate,
                                 freeze_stages=freeze_stages).validate()
    bundle = create_model(cfg, generator=torch.Generator().manual_seed(0))
    tx = build_optimizer(cfg, build_lr_schedule(cfg, 4))
    state = create_train_state(bundle.module, use_ema=True)
    step = port_step.make_train_step(bundle, cfg, tx, port_loss.build_criterion(cfg))
    rng = np.random.default_rng(12)
    batch = {"image": torch.from_numpy(rng.normal(size=(8, *HW, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, NUM_CLASSES, size=8))}
    calls = KernelCalls(monkeypatch)
    step(state, batch, generator=torch.Generator().manual_seed(1))
    want = expected_launches(cfg, 1, 0)
    want.pop("warp")     # the aug is off
    assert calls.counts == want
