"""The port's train and eval steps and their pieces against the JAX
package's, on the CPU in f32, from the same numpy inputs and one train state
moved by ``train_state_from_jax``.

The JAX model runs its XLA paths (lax conv, XLA block tail and GELU): in f32
they compute the same function as the Pallas kernels, whose VJPs
``test_torch_grads.py`` holds the port's plain backwards to, and they
compile in seconds where interpret mode takes minutes.

Tolerances: f32 on both sides with sums in another order. The loss agrees
to ~1e-6 relative. Adam moves each parameter by lr * m/(sqrt(v) + eps),
whatever the size of its gradient, and where v is small that quotient
magnifies f32 rounding of m and v: one update, and three steps through the
model, whose gradients differ in their last bits, agree to 1e-3 of lr
(measured <= 1.2e-7 at lr = 1e-3). The EMA moves by (1 - decay) of the
parameters' difference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.core.config import Config as JaxConfig
from image_classification_tpu.models.factory import ModelBundle as JaxBundle
from image_classification_tpu.models.factory import create_model as jax_create_model
from image_classification_tpu.models.layers import drop_path_rates as jax_drop_path_rates
from image_classification_tpu.train import loss as jax_loss
from image_classification_tpu.train.fused import _rebuild_opt_state
from image_classification_tpu.train.fused import fused_adamw_ema as jax_fused
from image_classification_tpu.train.loop import build_lr_schedule as jax_build_lr
from image_classification_tpu.train.loop import evaluate as jax_evaluate
from image_classification_tpu.train.optim import build_optimizer as jax_build_opt
from image_classification_tpu.train.schedule import PlateauScheduler as JaxPlateau
from image_classification_tpu.train.schedule import warmup_cosine_schedule as jax_wc
from image_classification_tpu.train.step import make_eval_step as jax_make_eval
from image_classification_tpu.train.step import make_train_step as jax_make_train
from image_classification_tpu.train.train_state import create_train_state as jax_create
from image_classification_tpu.utils import metrics as jax_metrics
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.models import ConvNeXt, DeepSupervisionModel
from image_classification_tpu_torch.models.factory import ModelBundle, create_model
from image_classification_tpu_torch.models.layers import drop_sites
from image_classification_tpu_torch.models.pretrained import (
    state_dict_from_jax,
    train_state_from_jax,
)
from image_classification_tpu_torch.train import loss
from image_classification_tpu_torch.train.fused import fused_adamw_ema
from image_classification_tpu_torch.train.loop import build_lr_schedule, evaluate
from image_classification_tpu_torch.train.optim import build_optimizer, set_learning_rate
from image_classification_tpu_torch.train.schedule import (
    PlateauScheduler,
    warmup_cosine_schedule,
)
from image_classification_tpu_torch.train.step import make_eval_step, make_train_step
from image_classification_tpu_torch.train.train_state import TrainState
from image_classification_tpu_torch.utils import metrics

from test_torch_model import DEPTHS, DIMS, NUM_CLASSES, jax_model, randomized_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

SIZE = 32
B, ACCUM = 8, 2
STEPS_PER_EPOCH = 10


def cfg_kwargs(**over):
    kw = dict(
        num_classes=NUM_CLASSES, image_size=(SIZE, SIZE), native_size=(24, 32),
        batch_size=B, gradient_accumulation_steps=ACCUM,
        grad_accum_reduction="sum", aug_enabled=False,
        use_deep_supervision=True, aux_weight=0.4, label_smoothing=0.1,
        compute_dtype="float32", lr=1e-3, weight_decay=1e-2,
        gradient_clip_val=1.0, epochs=4, use_ema=True, ema_decay=0.9,
        schedule="warmup_cosine", schedule_horizon="microbatches",
        warmup_ratio=0.1,
    )
    kw.update(over)
    return kw


def both_cfgs(**over):
    kw = cfg_kwargs(**over)
    return JaxConfig(**kw).validate(), Config(**kw).validate()


def _tree(rng, like, scale, positive=False):
    def draw(leaf):
        v = rng.normal(size=np.shape(leaf)) * scale
        return (np.abs(v) if positive else v).astype(np.float32)
    return jax.tree.map(draw, like)


def start_states(jcfg, seed=0, count=30):
    """The same non-trivial state on both sides: randomized params, an EMA
    off the params, random Adam moments with ``nu >= mu^2`` (as Adam's own
    moments are, so no step is a jump of many lr), count past warmup."""
    params = randomized_params(SIZE)
    rng = np.random.default_rng(seed)
    ema = jax.tree.map(lambda p, n: np.asarray(p) + n, params,
                       _tree(rng, params, 0.01))
    mu = _tree(rng, params, 1e-3)
    nu = jax.tree.map(lambda m, n: m * m + n, mu,
                      _tree(rng, params, 1e-6, positive=True))
    tx = jax_build_opt(jcfg, jax_build_lr(jcfg, STEPS_PER_EPOCH))
    jstate = jax_create({"params": params}, tx, use_ema=True)
    jstate = jstate.replace(
        step=jnp.asarray(count, jnp.int32), ema_params=ema,
        opt_state=_rebuild_opt_state(jstate.opt_state, jnp.asarray(count, jnp.int32),
                                     mu, nu))
    model = DeepSupervisionModel(
        ConvNeXt(NUM_CLASSES, DEPTHS, DIMS, dtype=torch.float32), NUM_CLASSES)
    state = train_state_from_jax(model, params, ema, mu, nu, count, count)
    return tx, jstate, state


def jax_bundle():
    return JaxBundle(name="tiny", module=jax_model("xla"), deep_supervised=True,
                     has_batch_stats=False, input_size=(SIZE, SIZE))


def port_params(state: TrainState):
    return {n: p.detach().numpy() for n, p in state.model.named_parameters()}


def jax_as_port(tree):
    from image_classification_tpu_torch.models.pretrained import (
        convnext_state_dict_from_jax,
    )
    return {k: v.numpy() for k, v in convnext_state_dict_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


def assert_trees_close(ours: dict, theirs: dict, atol, what, rtol=0.0):
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("reduction,clip", [("sum", 1.0), ("mean", 100.0)],
                         ids=["sum_clip_active", "mean_clip_inactive"])
def test_train_step_matches_jax_over_three_steps(reduction, clip):
    """Deep supervision, accumulation 2, the fused update with EMA, three
    optimizer steps from one carried state. The gradient norm is ~24 summed
    and ~12 averaged, so clip 1.0 acts and clip 100 does not."""
    jcfg, cfg = both_cfgs(grad_accum_reduction=reduction, gradient_clip_val=clip)
    tx_j, jstate, state = start_states(jcfg)
    rng = np.random.default_rng(3)
    images = rng.normal(size=(3, B, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, size=(3, B)).astype(np.int32)

    jstep = jax.jit(jax_make_train(jax_bundle(), jcfg, tx_j,
                                   jax_loss.build_criterion(jcfg)))
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    bundle = ModelBundle("tiny", state.model, True, (SIZE, SIZE))
    step = make_train_step(bundle, cfg, tx, loss.build_criterion(cfg))
    for t in range(3):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(images[t]),
                                    "label": jnp.asarray(labels[t])}, jax.random.key(0))
        state, m = step(state, {"image": torch.from_numpy(images[t]),
                                "label": torch.from_numpy(labels[t]).long()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, atol=1e-6)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    assert state.step == int(jstate.step) == 33 and state.count == 33
    atol = 1e-3 * cfg.lr
    assert_trees_close(port_params(state), jax_as_port(jstate.params), atol,
                       "params")
    names = state.names()
    assert_trees_close(dict(zip(names, (e.numpy() for e in state.ema))),
                       jax_as_port(jstate.ema_params), atol, "ema")


@pytest.mark.parametrize("clip", [1e-3, 1e3], ids=["clip_active", "clip_inactive"])
def test_fused_adamw_ema_matches_jax(clip):
    jcfg, cfg = both_cfgs(gradient_clip_val=clip)
    tx_j, jstate, state = start_states(jcfg, seed=1)
    grads = _tree(np.random.default_rng(2), jstate.params, 0.1)
    params, opt, ema = jax_fused(grads, jstate.opt_state, jstate.params,
                                 jstate.ema_params, schedule=tx_j.schedule, cfg=jcfg)
    tx = build_optimizer(cfg, build_lr_schedule(cfg, STEPS_PER_EPOCH))
    g = jax_as_port(grads)
    fused_adamw_ema([torch.from_numpy(g[n]) for n in state.names()], state,
                    tx=tx, cfg=cfg)
    assert state.count == 31
    atol = 1e-3 * cfg.lr
    assert_trees_close(port_params(state), jax_as_port(params), atol, "params")
    assert_trees_close(dict(zip(state.names(), (e.numpy() for e in state.ema))),
                       jax_as_port(ema), atol, "ema")
    jmu, jnu = (jax_as_port(jax.tree.map(np.asarray, t)) for t in
                (opt[1][0].mu, opt[1][0].nu))
    assert_trees_close(dict(zip(state.names(), (v.numpy() for v in state.mu))),
                       jmu, 1e-9, "mu", rtol=1e-6)
    assert_trees_close(dict(zip(state.names(), (v.numpy() for v in state.nu))),
                       jnu, 1e-12, "nu", rtol=1e-6)


def test_eval_step_and_evaluate_match_jax():
    """The masked eval step on the EMA weights (the last row is padding),
    and ``evaluate`` over two batches."""
    jcfg, cfg = both_cfgs()
    _, jstate, state = start_states(jcfg, seed=4)
    rng = np.random.default_rng(5)
    batches = [{"image": rng.integers(0, 256, (4, 24, 32, 3), dtype=np.uint8),
                "label": rng.integers(0, NUM_CLASSES, 4).astype(np.int32),
                "mask": np.array([True, True, True, i == 1])} for i in range(2)]
    jeval = jax.jit(jax_make_eval(jax_bundle(), jcfg))
    eval_step = make_eval_step(ModelBundle("tiny", state.model, True, (SIZE, SIZE)), cfg)
    jm = jeval(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
    m = eval_step(state, {"image": torch.from_numpy(batches[0]["image"]),
                          "label": torch.from_numpy(batches[0]["label"]),
                          "mask": batches[0]["mask"]})
    for k in ("loss_sum", "correct", "count", "confusion"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(m["count"]) == 3.0
    theirs = jax_evaluate(jeval, jstate, [{k: jnp.asarray(v) for k, v in b.items()}
                                          for b in batches])
    ours = evaluate(eval_step, state, [{"image": torch.from_numpy(b["image"]),
                                        "label": torch.from_numpy(b["label"]),
                                        "mask": b["mask"]} for b in batches])
    for k in ("loss", "accuracy", "macro_f1", "min_class_f1"):
        assert ours[k] == pytest.approx(theirs[k], rel=1e-5, abs=1e-6), k
    np.testing.assert_array_equal(ours["confusion"], theirs["confusion"])


def test_eval_step_scores_the_live_weights_without_ema():
    jcfg, cfg = both_cfgs()
    _, jstate, state = start_states(jcfg, seed=6)
    img = np.random.default_rng(7).integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    batch = {"label": np.array([0, 1, 2], np.int32), "mask": np.ones(3, bool)}
    jm = jax.jit(jax_make_eval(jax_bundle(), jcfg, use_ema=False))(
        jstate, {"image": jnp.asarray(img), **{k: jnp.asarray(v) for k, v in batch.items()}})
    m = make_eval_step(ModelBundle("tiny", state.model, True, (SIZE, SIZE)), cfg,
                       use_ema=False)(state, {"image": torch.from_numpy(img),
                                              "label": torch.from_numpy(batch["label"]),
                                              "mask": batch["mask"]})
    np.testing.assert_allclose(float(m["loss_sum"]), float(jm["loss_sum"]), rtol=1e-5)


# ------------------------------------------------------------------ losses
def _logits(n=6, k=5, seed=0):
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32) * 3


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_smoothed_cross_entropy_matches_jax(reduction, weighted):
    x, y = _logits(), np.array([0, 1, 2, 3, 4, 0])
    w = np.linspace(0.5, 2.0, 5).astype(np.float32) if weighted else None
    theirs = jax_loss.smoothed_cross_entropy(
        jnp.asarray(x), jnp.asarray(y), 0.1,
        None if w is None else jnp.asarray(w), reduction)
    ours = loss.smoothed_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(y), 0.1,
        None if w is None else torch.from_numpy(w), reduction)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)


def test_soft_target_and_focal_match_jax():
    x = _logits(seed=1)
    t = np.random.default_rng(2).dirichlet(np.ones(5), size=6).astype(np.float32)
    y = np.array([4, 3, 2, 1, 0, 1])
    alpha = np.linspace(1.0, 2.0, 5).astype(np.float32)
    pairs = [
        (loss.soft_target_cross_entropy(torch.from_numpy(x), torch.from_numpy(t), 0.1),
         jax_loss.soft_target_cross_entropy(jnp.asarray(x), jnp.asarray(t), 0.1)),
        (loss.focal_loss(torch.from_numpy(x), torch.from_numpy(y), 2.0,
                         torch.from_numpy(alpha)),
         jax_loss.focal_loss(jnp.asarray(x), jnp.asarray(y), 2.0, jnp.asarray(alpha))),
    ]
    for ours, theirs in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6)


@pytest.mark.parametrize("targets", ["int", "soft", "soft_kept"])
def test_deep_supervision_loss_matches_jax(targets):
    """Soft targets are argmaxed back to indices (the reference's quirk)
    unless ``soft_targets=True``."""
    outs = [_logits(seed=s) for s in range(4)]
    rng = np.random.default_rng(9)
    tgt = (rng.integers(0, 5, 6) if targets == "int"
           else rng.dirichlet(np.ones(5), size=6).astype(np.float32))
    keep = targets == "soft_kept"
    theirs = jax_loss.deep_supervision_loss([jnp.asarray(o) for o in outs],
                                            jnp.asarray(tgt), 0.6, 0.1, keep)
    ours = loss.deep_supervision_loss([torch.from_numpy(o) for o in outs],
                                      torch.from_numpy(tgt), 0.6, 0.1, keep)
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


@pytest.mark.parametrize("over", [{}, {"use_deep_supervision": False},
                                  {"use_focal_loss": True},
                                  {"use_weighted_loss": True}])
def test_build_criterion_matches_jax(over):
    jcfg, cfg = both_cfgs(**over)
    outs = [_logits(k=NUM_CLASSES, seed=s) for s in range(4)]
    y = np.array([0, 1, 2, 3, 4, 5])
    counts = np.arange(1, NUM_CLASSES + 1)
    theirs = jax_loss.build_criterion(jcfg, class_counts=jnp.asarray(counts))(
        tuple(jnp.asarray(o) for o in outs), jnp.asarray(y))
    ours = loss.build_criterion(cfg, class_counts=torch.from_numpy(counts))(
        tuple(torch.from_numpy(o) for o in outs), torch.from_numpy(y))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


# -------------------------------------------------------------- schedules
@pytest.mark.parametrize("horizon", ["microbatches", "steps"])
def test_lr_schedule_matches_jax(horizon):
    jcfg, cfg = both_cfgs(schedule_horizon=horizon, min_lr=1e-2)
    theirs, ours = jax_build_lr(jcfg, STEPS_PER_EPOCH), build_lr_schedule(cfg, STEPS_PER_EPOCH)
    for count in [0, 1, 3, 7, 8, 20, 39, 40, 79, 80, 200]:
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-6, abs=1e-12)
    assert build_lr_schedule(cfg.replace(schedule="none"), 5) == cfg.lr
    s, js = warmup_cosine_schedule(1.0, 0, 10, 0.3), jax_wc(1.0, 0, 10, 0.3)
    assert [s(c) for c in range(12)] == pytest.approx([float(js(c)) for c in range(12)])


def test_plateau_scheduler_matches_jax():
    ours, theirs = PlateauScheduler(1.0, 0.5, 1, 0.1), JaxPlateau(1.0, 0.5, 1, 0.1)
    for metric in [0.1, 0.2, 0.2, 0.1, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]:
        assert ours.step(metric) == theirs.step(metric)
    assert ours.state_dict() == theirs.state_dict()
    restored = PlateauScheduler(1.0)
    restored.load_state_dict(ours.state_dict())
    assert restored.state_dict() == ours.state_dict()


def test_optimizer_refuses_what_is_not_ported():
    jcfg, cfg = both_cfgs()
    # the plateau schedule is ported: a constant LR that the trainer resets
    plateau = build_optimizer(cfg.replace(schedule="plateau"), 1e-3)
    assert plateau.schedule(7) == 1e-3
    assert set_learning_rate(plateau, 2.5e-4).schedule(7) == 2.5e-4
    # freezing is ported: the frozen stages travel with the hyperparameters
    frozen = set_learning_rate(build_optimizer(cfg.replace(freeze_stages=1), 1e-3), 5e-4)
    assert frozen.freeze_stages == 1 and frozen.schedule(7) == 5e-4
    with pytest.raises(ValueError):
        build_optimizer(cfg.replace(optimizer="sgd"), 1e-3)
    # ViT and ConvNeXt's drop-path are ported: a deep-supervised ViT builds
    # with JAX's parameters (keys and shapes through the carrier), and
    # ConvNeXt's drop sites carry JAX's positive per-block rates, then the
    # head's dropout
    vit = "vit_tiny_patch16_224"
    shapes = jax.eval_shape(jax_create_model(jcfg.replace(model_name=vit)).init,
                            jax.random.key(0))["params"]
    ref = state_dict_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes))
    with torch.device("meta"):
        ours = create_model(cfg.replace(model_name=vit)).module.state_dict()
        atto = create_model(cfg.replace(model_name="convnext_atto", drop_path_rate=0.1,
                                        drop_rate=0.2)).module
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}
    rates = [r for stage in jax_drop_path_rates(0.1, (2, 2, 6, 2)) for r in stage if r > 0]
    assert [s.rate for s in drop_sites(atto)] == rates + [0.2]
    assert build_optimizer(cfg.replace(schedule="none"), 2e-3).schedule(7) == 2e-3


def test_f1_matches_jax():
    cm = np.array([[5, 1, 0, 0], [2, 3, 0, 0], [0, 0, 0, 0], [1, 0, 0, 4]], np.int64)
    np.testing.assert_allclose(metrics.per_class_f1(cm).numpy(),
                               np.asarray(jax_metrics.per_class_f1(cm)), rtol=1e-6)
    assert float(metrics.macro_f1(cm)) == pytest.approx(float(jax_metrics.macro_f1(cm)))
