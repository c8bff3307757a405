"""The four-card run's set-up and the repairs that separate cards called
for, on the CPU in one process (``tools/run_multicard.py``,
``tools/parallel_check.py``, ``parallel/distributed.py``, the kernel and JPEG
builds): each plan's mesh against JAX's, the run's refusals, each rank's
share of the host's threads, one build a host, and the shared compare code
on a small ConvNeXt step."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from image_classification_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from image_classification_tpu.parallel.mesh import build_mesh as jax_build_mesh
from image_classification_tpu_torch.core.config import Config
from image_classification_tpu_torch.data import native
from image_classification_tpu_torch.ops import _build
from image_classification_tpu_torch.parallel import distributed
from image_classification_tpu_torch.parallel.mesh import MeshSpec, rank_coords
from image_classification_tpu_torch.tools import parallel_check as pc
from image_classification_tpu_torch.tools import run_multicard as rm
from image_classification_tpu_torch.train import kfold
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse, module scope)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = rm.plan_meshes()


# ------------------------------------------------------------------- meshes
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_plan_mesh_resolves_and_lays_ranks_out_as_jax(plan):
    fold, data, model = PLANS[plan]
    shape = MeshSpec(data, model, fold=fold).resolve(rm.WORLD)
    assert shape == JaxMeshSpec(data, model, fold=fold).resolve(rm.WORLD) == PLANS[plan]
    jmesh = jax_build_mesh(JaxMeshSpec(data, model, fold=fold), jax.devices()[:rm.WORLD])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(shape)
    for rank in range(rm.WORLD):
        assert ids[rank_coords(rank, shape)] == rank


def test_plans_cover_the_issue_table():
    steps = rm.step_plans(REPO)
    assert sorted(steps) == sorted(PLANS) == list(rm.PLANS)
    assert [len(steps[p]) for p in rm.PLANS] == [1, 1, 2, 2, 1, 1, 3]
    assert [j[2] for j in steps["g"]] == [["mesh_model=2", f"block_remat={m}"]
                                        for m in ("none", "dots", "full")]
    for jobs in steps.values():
        for job in jobs:
            assert os.path.exists(job[1]) and job[3] % PLANS["a"][1] == 0
    assert rm.entry_plans()["f"][1:3] == ["num_folds=2", "mesh_data=2"]
    # every fold's train set inside one multiple of the batch at 4 and 2 folds
    for k in (4, 2):
        per = rm.TRAIN_IMAGES * (k - 1) // k
        assert per % 32 >= 8 and per % 32 <= 24


# ----------------------------------------------------------------- refusals
@pytest.mark.parametrize("world,cards,backend,uuids,match", [
    (2, 4, None, None, "WORLD_SIZE is 2"),
    (8, 8, None, None, "WORLD_SIZE is 8"),
    (4, 3, None, None, "3 CUDA cards"),
    (4, 4, "gloo", ["a", "b", "c", "d"], "takes NCCL"),
    (4, 4, "nccl", ["a", "b", "a", "d"], "share a card"),
])
def test_setup_refuses(world, cards, backend, uuids, match):
    with pytest.raises(rm.SetupError, match=match):
        rm.check_setup(world, cards, backend, uuids)


def test_setup_accepts_four_distinct_cards_over_nccl():
    rm.check_setup(4, 4)
    rm.check_setup(4, 8, "nccl", ["a", "b", "c", "d"])


@pytest.mark.parametrize("world", ["1", "2", "4"])
def test_main_raises_before_joining_a_group(monkeypatch, world):
    """Not four processes, or no card (this host has none): the tool raises
    before any process group or kernel build."""
    monkeypatch.setenv("WORLD_SIZE", world)
    monkeypatch.setattr(distributed, "initialize",
                        lambda *a, **k: pytest.fail("joined a group"))
    with pytest.raises(rm.SetupError, match="WORLD_SIZE" if world != "4" else "cards"):
        rm.main([])


# ------------------------------------------------------------ thread share
@pytest.mark.parametrize("local,budget,share", [
    (None, 16, 16), ("1", 16, 16), ("4", 16, 4), ("4", 8, 2), ("4", 2, 1), ("3", 16, 5),
])
def test_host_share(monkeypatch, local, budget, share):
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert distributed.host_share(budget) == share


def test_rank_threads_share_the_cores(monkeypatch):
    cores = len(os.sched_getaffinity(0))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert distributed.rank_threads() == max(1, cores // 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert distributed.rank_threads() == cores


def test_initialize_takes_the_share_and_the_timeout(monkeypatch):
    """``initialize`` joins with the caller's timeout and caps torch's
    threads at the rank's share of the cores (the group faked: a second
    rank would block the rendezvous)."""
    import datetime

    import torch.distributed as dist

    joined = {}
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.update(backend=backend, **kw))
    for name, value in (("get_rank", 0), ("get_world_size", 2), ("get_backend", "gloo")):
        monkeypatch.setattr(dist, name, lambda v=value: v)
    before = torch.get_num_threads()
    share = max(1, len(os.sched_getaffinity(0)) // 2)
    try:
        torch.set_num_threads(2 * share)     # torch's default: every core
        distributed.initialize("cpu", timeout=datetime.timedelta(seconds=7))
        assert joined == {"backend": "gloo", "timeout": datetime.timedelta(seconds=7)}
        assert torch.get_num_threads() == share
        torch.set_num_threads(1)             # torchrun's OMP_NUM_THREADS=1 stays
        joined.clear()
        distributed.initialize("cpu")
        assert torch.get_num_threads() == 1 and "timeout" not in joined
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("primary,threads", [(True, 16), (False, 4)])
def test_decoder_threads_a_rank(monkeypatch, primary, threads):
    """Rank 0 decodes alone (the others wait) and takes the host's budget;
    the other ranks decode at once and share it."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(kfold, "is_primary", lambda: primary)
    assert kfold.decode_threads() == threads
    seen = {}
    monkeypatch.setattr(kfold, "ImageSource",
                        lambda *a, **k: seen.setdefault("threads", k["num_threads"]))
    manifest = type("Manifest", (), {"ids": np.array(["a"])})()
    kfold.build_source(Config(), manifest, "/nowhere", kfold.decode_threads())
    assert seen["threads"] == threads


# -------------------------------------------------------- one build a host
@pytest.mark.parametrize("which", ["kernels", "jpeg"])
def test_one_build_a_host(tmp_path, monkeypatch, which):
    """Four callers at once (four ranks' first kernel launch): one compiles,
    the others wait on the lock and load its library."""
    mod = _build if which == "kernels" else native
    so = tmp_path / "lib.so"
    monkeypatch.setattr(mod, "BUILD_DIR", tmp_path)
    calls = []

    def compile_(*args):
        calls.append(threading.get_ident())
        time.sleep(0.2)
        so.write_bytes(b"built")
        return 0.2

    monkeypatch.setattr(mod, "_compile", compile_)
    if which == "kernels":
        monkeypatch.setattr(mod, "library_path", lambda: so)
    else:
        monkeypatch.setattr(mod, "recipe", lambda: None)
        monkeypatch.setattr(mod, "library_path", lambda r: so)
    out = []
    threads = [threading.Thread(target=lambda: out.append(mod.build())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert sorted(s for _, s in out) == [0.0, 0.0, 0.0, 0.2]
    assert all(p == so for p, _ in out) and (tmp_path / "build.lock").exists()


# ------------------------------------------------------ the compare code
TINY = ["model_name=convnext_atto", "image_size=[32,32]"]


@pytest.fixture(scope="module")
def tiny_steps():
    """One small V4 step (aug, mix, accumulation 2, EMA) on the CPU, alone
    and followed by two timed steps."""
    cfg = os.path.join(REPO, "configs", "v4.json")
    job = pc.par_job(cfg, TINY, 8, seed=61, timed=0)
    once = pc.par_step(job, None, "cpu")
    timed = pc.par_step({**job, "timed": 2}, None, "cpu", profile=False)
    return once, timed


def test_par_step_keeps_the_compared_state(tiny_steps):
    """The state after the compared step, not after the timed ones: on the
    CPU ``.cpu()`` would alias the state that the timed steps update."""
    once, timed = tiny_steps
    assert timed["step_ms"] > 0 and once["step_ms"] is None
    assert once["digest"] == timed["digest"]
    assert all(torch.equal(a, b) for a, b in zip(once["params"], timed["params"]))
    assert once["launches"] == once["want"] == dict.fromkeys(pc.WRAPPERS, 0)
    assert np.isfinite(once["loss"]) and len(once["params"]) == len(once["ema"])


def test_par_compare_passes_equal_steps_and_catches_faults(tiny_steps):
    once, _ = tiny_steps
    res = pc.par_compare("same", [once, pc.summary(once)], once, pc.PAR_LOSS_REL_TOL, None)
    assert res["ranks_bit_identical"] and res["loss_rel"] == 0 and res["max_d_param"] == 0
    other = {**pc.summary(once), "digest": "0"}
    with pytest.raises(pc.CheckFailure, match="parameters differ"):
        pc.par_compare("digest", [once, other], once, pc.PAR_LOSS_REL_TOL, None)
    with pytest.raises(pc.CheckFailure, match="loss rel"):
        pc.par_compare("loss", [once], {**once, "loss": once["loss"] * 1.01},
                       pc.PAR_LOSS_REL_TOL, None)
    moved = {**once, "params": [p + 5 * once["lr"] for p in once["params"]]}
    with pytest.raises(pc.CheckFailure, match="4 lr"):
        pc.par_compare("params", [moved], once, pc.PAR_LOSS_REL_TOL, None)
    extra = {**pc.summary(once), "launches": {**once["launches"], "warp": 1}}
    with pytest.raises(pc.CheckFailure, match="launched warp 1 times"):
        pc.par_compare("launches", [once, extra], once, pc.PAR_LOSS_REL_TOL, None)
    with pytest.raises(pc.CheckFailure, match="statistics"):
        pc.par_compare("stats", [once], once, pc.PAR_LOSS_REL_TOL, pc.PAR_F32_STATS_REL_L2)


def test_remat_compare_holds_each_mode_to_none_on_every_rank(tiny_steps):
    once, _ = tiny_steps
    rank = pc.summary(once)
    same = {"none": [rank, rank], "dots": [rank, rank], "full": [rank, rank]}
    assert pc.remat_compare("same", same) == {"none": True, "dots": True, "full": True}
    for fault, match in (({"digest": "0"}, "block_remat=full differs"),
                         ({"loss": once["loss"] * (1 + 1e-7)}, "block_remat=full differs")):
        with pytest.raises(pc.CheckFailure, match=match):
            pc.remat_compare("fault", {**same, "full": [rank, {**rank, **fault}]})


@pytest.mark.parametrize("plans,ok", [(None, True), ("g", True), ("efg", True),
                                      ("", False), ("gh", False)])
def test_plans_option(plans, ok):
    argv = [] if plans is None else ["--plans", plans]
    if ok:
        assert rm.parse_args(argv).plans == (rm.PLANS if plans is None else plans)
    else:
        with pytest.raises(SystemExit):
            rm.parse_args(argv)


def test_compare_with_sequential():
    rec = [{"fold": k, "epoch": e, "train_loss": 2.0 + k + e, "steps": 10,
            "images_per_sec": 1.0, "val_acc": 0.5} for k in (1, 2) for e in (0, 1)]
    rels = pc.compare_with_sequential(rec, rec)
    assert rels == {"1/0": 0.0, "1/1": 0.0, "2/0": 0.0, "2/1": 0.0}
    off = [{**r, "train_loss": r["train_loss"] * (1 + 2e-3)} for r in rec]
    with pytest.raises(pc.CheckFailure, match="fold 1 epoch 1"):
        pc.compare_with_sequential(off, rec)
    with pytest.raises(pc.CheckFailure, match="fold 1 epoch 1"):
        pc.compare_with_sequential([{**r, "steps": 9} for r in rec], rec)
