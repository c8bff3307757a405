"""The port's data-parallel steps on 4 gloo ranks against the JAX package's
step on a ``mesh_data=4`` mesh (4 of the 8 virtual CPU devices), which
``tests/test_multichip.py`` holds to its one-device step: the same weights
(the test carriers), the same global batch and JAX's draws for it
(``test_torch_aug.jax_step_draws``; the drop masks in place of
``jax.random.bernoulli``, as ``test_torch_swa.py``). Each rank takes its
rows of the batch and of the draws. Then the port's 4 ranks against its
1 rank, and a 2-rank ``cli train`` against a 1-rank one.

Tolerances, in f32: the loss to 1e-5 relative (the ranks' partial sums add
in another order); parameters and EMA to 1e-3 of lr, as in
``test_torch_train.py`` (Adam's m / sqrt(v) magnifies f32 rounding where v
is small); running statistics to 1e-5 relative (``STATS_RTOL``) and 1e-6
absolute; the eval sums to 1e-5 relative and their counts exactly. The
ranks' states must be bit-identical. The 2-rank ``cli train`` is held to
the 1-rank one with ``test_torch_loop.py``'s ``REL`` = 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_classification_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from image_classification_tpu.parallel.mesh import batch_sharding
from image_classification_tpu.parallel.mesh import build_mesh as jax_build_mesh
from image_classification_tpu.parallel.shardings import state_shardings
from image_classification_tpu.train import loss as jax_loss
from image_classification_tpu.train.step import make_bn_update_step as jax_make_bn
from image_classification_tpu.train.step import make_eval_step as jax_make_eval
from image_classification_tpu.train.step import make_train_step as jax_make_train
from image_classification_tpu_torch import cli
from image_classification_tpu_torch.models.factory import ModelBundle
from image_classification_tpu_torch.models.layers import draw_drop_masks, drop_sites
from image_classification_tpu_torch.train.step import StepDraws
from image_classification_tpu_torch.utils import checkpoint as ckpt

import test_torch_swa as swa
import test_torch_train as tt
from test_torch_aug import NATIVE, jax_step_draws, u8_images
from test_torch_effnet import STATS_RTOL, inject_bernoulli
from test_torch_foldpar import write_folds_data
from test_torch_loop import REL, overrides, read_csv, read_metrics, settings
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)
from torch_spawn import cli_worker, load_ranks, run_ranks, steps_worker

WORLD = 4
B = 8


def jax_mesh():
    return jax_build_mesh(JaxMeshSpec(data=WORLD, model=1), jax.devices()[:WORLD])


def on_mesh(mesh, jstate, batches):
    """JAX's data-parallel inputs: the state replicated by its shardings,
    each batch split over the data axis."""
    s_shard = state_shardings(jstate, mesh)
    b_shard = batch_sharding(mesh)
    return (s_shard, jax.device_put(jstate, s_shard),
            [{k: jax.device_put(jnp.asarray(v), b_shard) for k, v in b.items()}
             for b in batches])


def eval_batches(seed, hw):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (B, *hw, 3), dtype=np.uint8),
             "label": rng.integers(0, tt.NUM_CLASSES, B).astype(np.int32),
             "mask": np.arange(B) < B - 1}]


def as_port(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k == "label" else torch.from_numpy(v)
            for k, v in b.items()}


def check_eval(ours: dict, theirs: dict) -> None:
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-5, err_msg=k)
    assert float(ours["count"]) == float(theirs["count"]) == B - 1
    np.testing.assert_array_equal(ours["confusion"].numpy(), np.asarray(theirs["confusion"]))


def check_ranks_identical(ranks: list[dict]) -> None:
    """Every rank ends with the same bits in every tensor of its state."""
    first = ranks[0]["state"]
    for r in ranks[1:]:
        for part in ("model", "buffers", "ema", "mu", "nu"):
            for k, v in (first[part] or {}).items():
                assert torch.equal(v, r["state"][part][k]), (part, k)
        assert r["metrics"] == ranks[0]["metrics"]


def run_port(tmp, world, *args) -> list[dict]:
    out = f"{tmp}/w{world}"
    run_ranks(steps_worker, world, out, out, *args)
    return load_ranks(out, world)


# ------------------------------------------------------------- ConvNeXt
@pytest.fixture(scope="module")
def convnext_case(tmp_path_factory):
    """ConvNeXt (``test_torch_train``'s, deep-supervised) with the aug and
    MixUp/CutMix on and accumulation 2: one JAX step on the 4-device mesh
    and the port's step on 4 ranks and on 1."""
    jcfg, cfg = tt.both_cfgs(aug_enabled=True, native_size=NATIVE)
    assert cfg.gradient_accumulation_steps == 2 and cfg.mixup_alpha > 0
    tx_j, jstate, state = tt.start_states(jcfg)
    img = u8_images(21)
    labels = np.random.default_rng(31).integers(0, tt.NUM_CLASSES, B).astype(np.int32)
    base = jax.random.key(4)
    draws = jax_step_draws(base, int(jstate.step), img.shape, jcfg)
    evals = eval_batches(5, NATIVE)

    mesh = jax_mesh()
    s_shard, js, (jb, je) = on_mesh(mesh, jstate, [{"image": img, "label": labels},
                                                   evals[0]])
    jstep = jax.jit(jax_make_train(tt.jax_bundle(), jcfg, tx_j,
                                   jax_loss.build_criterion(jcfg)),
                    out_shardings=(s_shard, None))
    js, jm = jstep(js, jb, base)
    jeval = jax.jit(jax_make_eval(tt.jax_bundle(), jcfg))(js, je)

    bundle = ModelBundle("tiny", state.model, True, (tt.SIZE, tt.SIZE))
    args = (bundle, state, cfg, tt.STEPS_PER_EPOCH, None,
            [as_port({"image": img, "label": labels})], [draws],
            [as_port(b) for b in evals], [])
    tmp = str(tmp_path_factory.mktemp("ddp_convnext"))
    return {"cfg": cfg, "jm": jm, "js": js, "jeval": jeval,
            "ranks": run_port(tmp, WORLD, *args), "one": run_port(tmp, 1, *args)}


def test_convnext_step_on_4_ranks_matches_jax_mesh_step(convnext_case):
    c = convnext_case
    ours = c["ranks"][0]
    m = ours["metrics"][0]
    np.testing.assert_allclose(m["loss"], float(c["jm"]["loss"]), rtol=1e-5)
    assert m["accuracy"] == float(c["jm"]["accuracy"])
    atol = 1e-3 * c["cfg"].lr
    tt.assert_trees_close({k: v.numpy() for k, v in ours["state"]["model"].items()},
                          tt.jax_as_port(c["js"].params), atol, "params")
    tt.assert_trees_close({k: v.numpy() for k, v in ours["state"]["ema"].items()},
                          tt.jax_as_port(c["js"].ema_params), atol, "ema")
    assert ours["state"]["step"] == int(c["js"].step)
    check_eval(ours["eval"][0], c["jeval"])


def test_convnext_4_ranks_match_1_rank_and_each_other(convnext_case):
    c = convnext_case
    check_ranks_identical(c["ranks"])
    four, one = c["ranks"][0], c["one"][0]
    np.testing.assert_allclose(four["metrics"][0]["loss"], one["metrics"][0]["loss"],
                               rtol=1e-5)
    assert four["metrics"][0]["accuracy"] == one["metrics"][0]["accuracy"]
    for part in ("model", "ema", "mu"):
        tt.assert_trees_close({k: v.numpy() for k, v in four["state"][part].items()},
                              {k: v.numpy() for k, v in one["state"][part].items()},
                              1e-3 * c["cfg"].lr, part)
    check_eval(four["eval"][0], {k: v.numpy() for k, v in one["eval"][0].items()})


# --------------------------------------------------------- EfficientNet
@pytest.fixture(scope="module")
def effnet_case(tmp_path_factory):
    """The small EfficientNet of ``test_torch_effnet`` (BatchNorm,
    drop-path 0.25, dropout 0.3), aug off, accumulation 2, class-weighted
    CE: one step with drop masks on both microbatches, the eval step, and
    the BN update step (the masks of a generator seeded 0 for the global
    batch)."""
    mp = pytest.MonkeyPatch()
    try:
        jm = swa.jax_small(0.3, 0.25)
        variables = swa.randomized(jax.jit(jm.init)(jax.random.key(0),
                                                   jnp.zeros((1, *swa.HW, 3))))
        jcfg, cfg = swa.cfgs(use_weighted_loss=True)
        counts = np.arange(1, swa.NUM_CLASSES + 1, dtype=np.float32)
        tx_j, jstate, jbundle, state, bundle = swa.fresh((jm, variables), jcfg)
        sites = drop_sites(bundle.module)
        masks = draw_drop_masks(torch.Generator().manual_seed(5), sites, B // swa.ACCUM)
        holder = [m.numpy() for m in masks]
        inject_bernoulli(mp, holder)
        rng = np.random.default_rng(3)
        batch = {"image": rng.normal(size=(B, *swa.HW, 3)).astype(np.float32),
                 "label": rng.integers(0, swa.NUM_CLASSES, B).astype(np.int32)}
        evals = eval_batches(6, swa.HW)
        bn_batch = swa.u8_batches(7, [B])[0]

        mesh = jax_mesh()
        s_shard, js, (jb, je, jbn_b) = on_mesh(mesh, jstate, [batch, evals[0], bn_batch])
        crit = jax_loss.build_criterion(jcfg, class_counts=jnp.asarray(counts))
        jstep = jax.jit(jax_make_train(jbundle, jcfg, tx_j, crit),
                        out_shardings=(s_shard, None))
        js, jmet = jstep(js, jb, jax.random.key(0))
        jeval = jax.jit(jax_make_eval(jbundle, jcfg))(js, je)
        holder[:] = [m.numpy() for m in swa.port_bn_masks(bundle.module, B)]
        jbs = jax.jit(jax_make_bn(jbundle, jcfg))(js.params, js.batch_stats, jbn_b)
    finally:
        mp.undo()
    args = (bundle, state, cfg, 1, torch.from_numpy(counts), [as_port(batch)],
            [StepDraws(None, None, (masks, masks))], [as_port(b) for b in evals],
            [as_port(bn_batch)])
    tmp = str(tmp_path_factory.mktemp("ddp_effnet"))
    return {"cfg": cfg, "jm": jmet, "js": js, "jeval": jeval, "jbs": jbs,
            "ranks": run_port(tmp, WORLD, *args), "one": run_port(tmp, 1, *args)}


def _running(state: dict) -> dict:
    return {k: v.numpy() for k, v in state["buffers"].items()}


def test_effnet_step_on_4_ranks_matches_jax_mesh_step(effnet_case):
    """The loss, the parameters and EMA after the step, the eval sums on the
    EMA weights with the running statistics the step left (global batch
    statistics through both microbatches), then the BN update step's."""
    c = effnet_case
    ours = c["ranks"][0]
    np.testing.assert_allclose(ours["metrics"][0]["loss"], float(c["jm"]["loss"]),
                               rtol=1e-5)
    assert ours["metrics"][0]["accuracy"] == float(c["jm"]["accuracy"])
    atol = 1e-3 * swa.LR
    swa.assert_close({k: v.numpy() for k, v in ours["state"]["model"].items()},
                     swa.jax_as_port(c["js"].params), atol, "params")
    swa.assert_close({k: v.numpy() for k, v in ours["state"]["ema"].items()},
                     swa.jax_as_port(c["js"].ema_params), atol, "ema")
    check_eval(ours["eval"][0], c["jeval"])
    swa.assert_close(_running(ours["state"]),
                     swa.jax_stats({"params": c["js"].params, "batch_stats": c["jbs"]}),
                     1e-6, "running stats after the BN update", rtol=STATS_RTOL)


def test_effnet_4_ranks_match_1_rank_and_each_other(effnet_case):
    c = effnet_case
    check_ranks_identical(c["ranks"])
    four, one = c["ranks"][0], c["one"][0]
    np.testing.assert_allclose(four["metrics"][0]["loss"], one["metrics"][0]["loss"],
                               rtol=1e-5)
    swa.assert_close(_running(four["state"]), _running(one["state"]), 1e-6,
                     "running stats", rtol=STATS_RTOL)
    for part in ("model", "ema"):
        swa.assert_close({k: v.numpy() for k, v in four["state"][part].items()},
                         {k: v.numpy() for k, v in one["state"][part].items()},
                         1e-3 * swa.LR, part)


# ------------------------------------------------------------- cli train
@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``cli train`` (aug off, 2 folds of ``test_torch_foldpar``'s data, 2
    epochs) on 1 process, on 2 gloo ranks of the data axis and on 2 of the
    model axis (``mesh_model=2``), then ``cli predict`` on the data-parallel
    run's checkpoints."""
    root = str(tmp_path_factory.mktemp("ddp_cli"))
    write_folds_data(root)
    one, two = settings(root, "one", epochs=2), settings(root, "two", epochs=2)
    tp = settings(root, "tp", epochs=2, mesh_data=1, mesh_model=2)
    cli.main(["train", "--device", "cpu", *overrides(one)])
    # one pair of processes runs both, each on its own mesh
    run_ranks(cli_worker, 2, f"{root}/spawn", ["train", "--device", "cpu", *overrides(two)],
              ["train", "--device", "cpu", *overrides(tp)])
    cli.main(["predict", "--device", "cpu", "--folds", "1,2", *overrides(two),
              f"submission_path={root}/two/predict.csv"])
    return root, one, two, tp


def assert_runs_match(one: dict, two: dict) -> None:
    """The same records (losses to ``REL``, counts exactly), best weights
    of the same names and whole shapes (to ``REL`` of each tensor's
    largest element) and the same submission."""
    a = read_metrics(f"{one['output_dir']}/metrics.jsonl")
    b = read_metrics(f"{two['output_dir']}/metrics.jsonl")
    assert [(m["fold"], m["epoch"]) for m in a] == [(m["fold"], m["epoch"]) for m in b]
    for x, y in zip(a, b):
        for key in ("train_loss", "val_loss"):
            assert y[key] == pytest.approx(x[key], rel=REL), key
        assert (y["val_acc"], y["train_acc"], y["steps"]) == \
            (x["val_acc"], x["train_acc"], x["steps"])
    for fold in (1, 2):
        for metric in ("acc", "loss"):
            mine, meta = ckpt.load_best(two["model_save_path"], fold, metric)
            ref, ref_meta = ckpt.load_best(one["model_save_path"], fold, metric)
            assert meta["val_acc"] == ref_meta["val_acc"] and set(mine) == set(ref)
            for k, v in ref.items():
                assert mine[k].shape == v.shape, k
                scale = max(float(v.abs().max()), 1e-3)
                assert float((mine[k] - v).abs().max()) <= REL * scale, k
    assert read_csv(two["submission_path"])[1:] == read_csv(one["submission_path"])[1:]


def test_cli_train_tensor_parallel_writes_the_unsplit_files(cli_runs):
    """``mesh_model=2`` splits every MLP pair of ``convnext_atto`` (its
    widths divide by 2); the checkpoints and train states hold the whole
    tensors, equal to the 1-process run's."""
    root, one, _, tp = cli_runs
    assert_runs_match(one, tp)
    for fold in (1, 2):
        a = torch.load(ckpt.resume_path(tp["output_dir"], fold), weights_only=True)
        b = torch.load(ckpt.resume_path(one["output_dir"], fold), weights_only=True)
        for part in ("model", "mu", "nu", "ema"):
            assert {k: v.shape for k, v in a[part].items()} == \
                {k: v.shape for k, v in b[part].items()}, part
    with open(f"{tp['output_dir']}/train.log") as f:
        assert "mesh (fold, data, model) (1, 1, 2)" in f.read()


def test_cli_train_on_2_ranks_matches_1_rank(cli_runs):
    root, one, two, _ = cli_runs
    assert_runs_match(one, two)
    assert read_csv(f"{root}/two/predict.csv")[1:] == read_csv(two["submission_path"])[1:]
    with open(f"{two['output_dir']}/train.log") as f:
        log = f.read()
    # one process wrote the log: each fold's summary line once
    assert log.count("fold 1 best val acc") == 1 and "mesh (fold, data, model) (1, 2, 1)" in log
