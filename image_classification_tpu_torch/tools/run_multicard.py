"""The port's scale-out on four cards over NCCL, held to one process.

    torchrun --standalone --nproc_per_node=4 \\
        -m image_classification_tpu_torch.tools.run_multicard \\
        [--out output/multicard]

Four processes, one a card, join the group through
``parallel/distributed.py:initialize`` as ``cli train`` does (NCCL,
``cuda:LOCAL_RANK``). The run raises, and exits non-zero, unless
``WORLD_SIZE`` is 4, four cards are visible, the backend is NCCL and the
four ranks sit on four distinct cards (by UUID): no gloo, no CPU, no shared
card. Rank 0 prints the cards (``nvidia-smi``: index, name, power limit, PCI
bus) and which rank built the kernels.

Plans, each on a mesh (fold, data, model), against one process on rank 0's
card given the same weights, global batch and global draws
(``tools/parallel_check.py``, the code ``chip_smoke.py``'s phase
``parallel`` runs on one card):

- a (1, 4, 1): ``configs/v4.json`` as shipped (ConvNeXt-B with deep
  supervision at 260, batch 32, accumulation 2, aug + mix, EMA);
- b (1, 4, 1): a at ``batch_size=128``, 32 rows a rank; its step wall
  against one process at 32 prices the collectives;
- c (1, 4, 1): ``configs/v1_effb0.json`` (BatchNorm's sums across the four
  cards) in bf16 and f32;
- d (1, 2, 2): ViT-B/16 at 224 (``configs/v2_convbase.json``, batch 64)
  split over two cards of the model axis times two of the data axis, in
  bf16 and f32;
- e (4, 1, 1): V4's step on the fold mesh; then ``cli train
  fold_parallel=true num_folds=4 epochs=2`` on a hard synthetic set written
  as JPEGs (``data/synthetic_hard.py``); ``cli predict`` on its folds; the
  sequential ``cli train`` of the same folds on rank 0's card;
- f (2, 2, 1): e with ``num_folds=2 mesh_data=2``; its sequential run on
  rank 1's card, beside e's;
- g (1, 2, 2): a with its MLPs split over two cards of the model axis
  (``mesh_model=2``) times two of the data axis, under ``block_remat``
  ``none``, ``dots`` and ``full``: the recompute's collectives on the model
  group beside the data group's.

Held to (the bounds of ``tools/parallel_check.py``): a-d and the steps of
e-f the loss, the parameters and EMA within 4 lr, BatchNorm's statistics,
the four ranks' states bit-identical, each rank's kernel launches exact;
e-f each fold's train loss an epoch against the sequential run, the files
of the fold-parallel run written once, ``cli predict`` reproducing its
submission, each rank's launches exact; g's ``dots`` and ``full`` equal to
its ``none`` to the bit on every rank. Times: a rank's step wall and peak
memory, the device time and idle share of one profiled step on rank 0, its
gradient all-reduce's and model group's sums' device time, and for e-f each
fold's images/s from ``metrics.jsonl`` and the walls. Every plan of
``--plans`` (all by default) runs; a plan out of bound is printed and the
run exits non-zero at its end. The results go to ``{out}/multicard.json``.
"""

from __future__ import annotations

import argparse
import datetime
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

WORLD = 4
PLANS = "abcdefg"
# Plans e-f: a hard synthetic set of 8,032 train images (251 batches of 32:
# each fold's train set, ~6,024 at 4 folds and ~4,016 at 2, lies inside one
# multiple of 32, so the folds take equal steps and the fold-parallel run's
# least is each fold's own), 188 steps an epoch at 4 folds, ~30 s at ~200
# images/s on one card, so that start-up is not the whole wall.
TRAIN_IMAGES, TEST_IMAGES, EPOCHS = 8032, 512, 2
# Steps each rank times after the compared one: a host-bound V4 step varies
# by tens of ms from one to the next, and ten cost ~2 s a job.
TIMED_STEPS = 10
# The longest wait at a collective (rank 0's one-process steps, the data, a
# predict: a minute or two); a hang fails in this time. The ranks that wait
# for the sequential runs (~6 min) poll files instead.
GROUP_TIMEOUT_S = 420
TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                 "GROUP_WORLD_SIZE", "ROLE_RANK", "ROLE_WORLD_SIZE", "ROLE_NAME",
                 "MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RESTART_COUNT",
                 "TORCHELASTIC_MAX_RESTARTS", "TORCHELASTIC_RUN_ID",
                 "TORCHELASTIC_USE_AGENT_STORE", "TORCHELASTIC_ERROR_FILE",
                 "TORCH_NCCL_ASYNC_ERROR_HANDLING")
# The sequential cli train of plans e-f, one process on one card, its wall
# taken around cli.main (process start and imports left out, as they are
# from the fold-parallel run's).
SEQUENTIAL = (
    "import json, sys, time\n"
    "import torch\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "from image_classification_tpu_torch import cli\n"
    "t0 = time.perf_counter()\n"
    "cli.main(sys.argv[2:])\n"
    "with open(sys.argv[1], 'w') as f:\n"
    "    json.dump({'wall_s': time.perf_counter() - t0}, f)\n"
)


class SetupError(RuntimeError):
    pass


def check_setup(world: int, n_cards: int, backend: str | None = None,
                uuids: list[str] | None = None) -> None:
    """Raise unless this is four processes on four distinct cards over NCCL
    (``backend`` and ``uuids`` once the group is up)."""
    if world != WORLD:
        raise SetupError(f"WORLD_SIZE is {world}: this run takes {WORLD} processes, "
                         f"one a card (torchrun --nproc_per_node={WORLD})")
    if n_cards < WORLD:
        raise SetupError(f"{n_cards} CUDA cards visible: this run takes {WORLD}")
    if backend is not None and backend != "nccl":
        raise SetupError(f"backend {backend!r}: this run takes NCCL, one card a rank")
    if uuids is not None and len(set(uuids)) != len(uuids):
        raise SetupError(f"two ranks share a card: the ranks' card UUIDs are {uuids}")


def plan_meshes() -> dict[str, tuple[int, int, int]]:
    """Each plan's mesh spec (fold, data, model)."""
    return {"a": (1, 4, 1), "b": (1, 4, 1), "c": (1, 4, 1), "d": (1, 2, 2),
            "e": (4, 1, 1), "f": (2, 2, 1), "g": (1, 2, 2)}


def step_plans(repo: str) -> dict[str, list[tuple]]:
    """Plans a-d and the steps of e-f: per plan its jobs as (name, config,
    overrides, global batch, seed, compared against (a job's key), loss
    bound, statistics bound, timed steps)."""
    from image_classification_tpu_torch.tools.parallel_check import (
        PAR_BF16_STATS_REL_L2, PAR_F32_LOSS_REL_TOL, PAR_F32_STATS_REL_L2,
        PAR_LOSS_REL_TOL)

    v4 = os.path.join(repo, "configs", "v4.json")
    v1 = os.path.join(repo, "configs", "v1_effb0.json")
    v2 = os.path.join(repo, "configs", "v2_convbase.json")
    vit = ["ensemble_models=[]", "ensemble_weights=[]",
           "model_name=vit_base_patch16_224", "image_size=[224,224]"]
    t = TIMED_STEPS
    return {
        "a": [("V4 (ConvNeXt-B, 260, bf16, aug + mix, accum 2, EMA)", v4, [], 32, 61,
               "a0", PAR_LOSS_REL_TOL, None, t)],
        "b": [("V4 at batch_size=128", v4, ["batch_size=128"], 128, 64, "b0",
               PAR_LOSS_REL_TOL, None, t)],
        "c": [("V1 (EfficientNet-B0, 60x80, bf16, BatchNorm)", v1, [], 64, 62, "c0",
               PAR_LOSS_REL_TOL, PAR_BF16_STATS_REL_L2, t),
              ("V1 in f32", v1, ["compute_dtype=float32"], 64, 62, "c1",
               PAR_F32_LOSS_REL_TOL, PAR_F32_STATS_REL_L2, 0)],
        "d": [("ViT-B/16 (224, batch 64, bf16) on data 2 x model 2", v2, vit, 64, 63,
               "d0", PAR_LOSS_REL_TOL, None, t),
              ("ViT-B/16 in f32 on data 2 x model 2", v2,
               [*vit, "compute_dtype=float32"], 64, 63, "d1", PAR_F32_LOSS_REL_TOL,
               None, 0)],
        # each fold rank group steps plan a's job: one process' work (e), or
        # two ranks' of the data axis (f)
        "e": [("V4 step on the fold mesh (4, 1, 1)", v4, [], 32, 61, "a0",
               PAR_LOSS_REL_TOL, None, t)],
        "f": [("V4 step on the fold mesh (2, 2, 1)", v4, [], 32, 61, "a0",
               PAR_LOSS_REL_TOL, None, t)],
        # plan a's job with the MLPs split, under each block_remat mode
        "g": [(f"V4 on data 2 x model 2, block_remat={mode}", v4,
               ["mesh_model=2", f"block_remat={mode}"], 32, 61, "a0", PAR_LOSS_REL_TOL,
               None, t) for mode in ("none", "dots", "full")],
    }


def entry_plans() -> dict[str, list[str]]:
    """Plans e-f's ``cli train`` overrides."""
    return {"e": ["fold_parallel=true", "num_folds=4", f"epochs={EPOCHS}"],
            "f": ["fold_parallel=true", "num_folds=2", "mesh_data=2", f"epochs={EPOCHS}"]}


# ------------------------------------------------------------------ helpers
def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def gather(obj):
    """``obj`` (JSON) of every rank, in rank order."""
    from image_classification_tpu_torch.parallel.distributed import all_gather_json

    return all_gather_json(obj, dist.group.WORLD,
                           torch.device("cuda", torch.cuda.current_device()))


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


class Run:
    """This rank's state through the plans: its card, the meshes by spec,
    the one-process references (rank 0), the results and the failures."""

    def __init__(self, repo: str, out: str, work: str, device: torch.device):
        self.rank = dist.get_rank()
        self.device = device
        self.repo, self.out, self.work = repo, out, work
        self.meshes: dict = {}
        self.references: dict = {}
        self.results: dict = {}
        self.failures: list[str] = []

    def log(self, *args) -> None:
        if self.rank == 0:
            print(*args, flush=True)

    def mesh(self, spec: tuple[int, int, int]):
        from image_classification_tpu_torch.parallel.mesh import MeshSpec, build_mesh

        if spec not in self.meshes:   # every rank, in the same order
            fold, data, model = spec
            self.meshes[spec] = build_mesh(MeshSpec(data, model, fold=fold))
        return self.meshes[spec]

    def check(self, plan: str, fn, *args):
        """``fn(*args)`` on rank 0; a failed bound is recorded, and the plans
        go on (every rank runs the same collectives either way)."""
        from image_classification_tpu_torch.tools.parallel_check import CheckFailure

        if self.rank != 0:
            return None
        try:
            return fn(*args)
        except CheckFailure as e:
            self.failures.append(f"plan {plan}: {e}")
            print(f"OUT OF BOUND, plan {plan}: {e}", flush=True)
            return None

    # -------------------------------------------------------------- steps
    def step_plan(self, plan: str, spec: tuple[int, int, int], jobs: list[tuple]) -> None:
        from image_classification_tpu_torch.tools.parallel_check import (
            par_compare, par_job, par_step, summary)

        results = []
        for name, config, over, batch, seed, ref, loss_tol, stats_tol, timed in jobs:
            fold, data, model = spec
            job = par_job(config, over, batch, seed, spec=(data, model), timed=timed)
            if self.rank == 0 and ref not in self.references:
                t0 = time.perf_counter()
                self.references[ref] = par_step(job, None, self.device, profile=True)
                self.log(f"plan {plan}: one process on rank 0's card, {name}: "
                         f"{time.perf_counter() - t0:.1f} s")
                free_memory()
            dist.barrier()
            t0 = time.perf_counter()
            mine = par_step(job, self.mesh(spec), self.device, profile=self.rank == 0)
            wall = time.perf_counter() - t0
            ranks = gather(summary(mine))
            free_memory()
            if self.rank != 0:
                continue
            ranks[0] = mine
            one = self.references[ref]
            res = self.check(plan, par_compare, f"plan {plan}, {name}", ranks, one,
                             loss_tol, stats_tol) or {}
            res.update(name=name, mesh=list(spec), wall_s=wall,
                       launches=[r["launches"] for r in ranks],
                       ranks=[{k: r[k] for k in ("loss", "digest", "step_ms", "peak_mem_gib")}
                              for r in ranks],
                       profile=mine["profile"], one_process_profile=one["profile"])
            print(f"plan {plan} times, {name}: a rank's step "
                  f"{[r['step_ms'] for r in ranks]} ms (1 process {one['step_ms']} ms); "
                  f"each rank's peak {[r['peak_mem_gib'] for r in ranks]} GiB (1 process "
                  f"{one['peak_mem_gib']}); rank 0's profiled step {mine['profile']}; 1 "
                  f"process' {one['profile']}", flush=True)
            results.append(res)
            del ranks, mine
        self.results[plan] = {"steps": results}

    def remat_plan(self, plan: str) -> None:
        """Plan ``plan``'s jobs, one a ``block_remat`` mode, against its
        ``none`` job on every rank, to the bit (rank 0)."""
        from image_classification_tpu_torch.tools.parallel_check import remat_compare

        if self.rank != 0:
            return
        steps = self.results[plan]["steps"]
        modes = {r["name"].rsplit("=", 1)[1]: r["ranks"] for r in steps}
        self.results[plan]["bit_equal"] = self.check(plan, remat_compare, f"plan {plan}",
                                                     modes)

    # ------------------------------------------------------------ cli runs
    def data(self, n_train: int) -> dict:
        """Rank 0 writes the hard set as JPEGs and fills the decode caches;
        every rank gets the paths."""
        from image_classification_tpu_torch.core.config import load_config
        from image_classification_tpu_torch.data import Manifest, make_hard_synthetic_dataset
        from image_classification_tpu_torch.train.kfold import build_source

        root = os.path.join(self.work, "data")
        paths = {"train_csv": f"{root}/train.csv", "train_dir": f"{root}/train",
                 "test_csv": f"{root}/sample_submission.csv", "test_dir": f"{root}/test",
                 "cache_dir": f"{root}/cache"}
        info = None
        if self.rank == 0:
            t0 = time.perf_counter()
            made = make_hard_synthetic_dataset(root, n_train=n_train, n_test=TEST_IMAGES,
                                               native_size=(60, 80), seed=0)
            cfg = load_config(None, [f"{k}={v}" for k, v in paths.items()])
            t1 = time.perf_counter()
            for csv, d, test in ((cfg.train_csv, cfg.train_dir, False),
                                 (cfg.test_csv, cfg.test_dir, True)):
                build_source(cfg, Manifest.from_csv(csv, is_test=test), d)
            info = {"write_s": t1 - t0, "decode_s": time.perf_counter() - t1,
                    "seconds": made["seconds"]}
            print(f"hard set: {n_train} train / {TEST_IMAGES} test JPEGs written in "
                  f"{info['write_s']:.1f} s, decoded into the caches in "
                  f"{info['decode_s']:.1f} s", flush=True)
        dist.barrier()
        return {"paths": paths, "info": info}

    def overrides(self, paths: dict, tag: str) -> list[str]:
        d = os.path.join(self.work, tag)
        return [*(f"{k}={v}" for k, v in paths.items()), f"model_save_path={d}/models",
                f"output_dir={d}/out", f"submission_path={d}/submission.csv"]

    def argv(self, plan: str, paths: dict, tag: str, parallel: bool = True) -> list[str]:
        """``cli train`` of plan ``plan`` (fold-parallel, or the sequential
        run of the same folds)."""
        over = [o for o in entry_plans()[plan]
                if parallel or not (o == "fold_parallel=true" or o.startswith("mesh_"))]
        return ["train", "--config", os.path.join(self.repo, "configs", "v4.json"),
                "--device", str(self.device.type), *over, *self.overrides(paths, tag)]

    def cfg(self, argv: list[str]):
        from image_classification_tpu_torch.core.config import load_config

        return load_config(argv[argv.index("--config") + 1],
                           argv[argv.index("--device") + 2:])

    def fold_parallel(self, plan: str, paths: dict, tag: str) -> dict:
        """``cli train`` of plan ``plan`` on the four ranks; each rank's
        launches and wall."""
        from image_classification_tpu_torch import cli
        from image_classification_tpu_torch.tools.parallel_check import (
            read_launches, reset_launches)

        argv = self.argv(plan, paths, tag)
        free_memory()
        dist.barrier()
        reset_launches()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ranks = gather({"launches": read_launches(), "wall_s": wall,
                        "threads": torch.get_num_threads()})
        free_memory()
        return {"argv": argv, "ranks": ranks}

    def splits(self, cfg) -> list:
        """The folds of ``cfg``'s train set; raises unless each fold's train
        set gives the same steps, so that the fold-parallel run (every fold
        at the folds' least) and the sequential one train the same steps."""
        from image_classification_tpu_torch.data import Manifest
        from image_classification_tpu_torch.data.splits import stratified_kfold

        labels = Manifest.from_csv(cfg.train_csv, num_classes=cfg.num_classes).labels
        splits = list(stratified_kfold(labels, cfg.num_folds, cfg.fold_seed))
        sizes = [len(t) for t, _ in splits]
        if len({n // cfg.batch_size for n in sizes}) != 1:
            raise SetupError(f"the folds' train sets {sizes} give unequal steps at "
                             f"batch {cfg.batch_size}")
        return splits

    def expected(self, cfg, records: list[dict]) -> list[dict]:
        """Each rank's launches in a fold-parallel ``cli train`` of ``cfg``:
        its fold's steps and validation forwards, and on rank 0 the test
        set's forwards of every fold's model."""
        from image_classification_tpu_torch.parallel.mesh import rank_coords
        from image_classification_tpu_torch.tools.parallel_check import expected_launches

        splits = self.splits(cfg)
        val_batch = cfg.batch_size * cfg.val_batch_multiplier
        test_batches = -(-TEST_IMAGES // (cfg.batch_size * cfg.infer_batch_multiplier))
        shape = (cfg.num_folds, WORLD // cfg.num_folds, 1)
        want = []
        for rank in range(WORLD):
            fold = rank_coords(rank, shape)[0] + 1
            steps = sum(r["steps"] for r in records if r["fold"] == fold)
            forwards = EPOCHS * -(-len(splits[fold - 1][1]) // val_batch)
            if rank == 0:
                forwards += cfg.num_folds * test_batches
            want.append(expected_launches(cfg, steps, forwards))
        return want

    def entry_plan(self, plan: str, paths: dict) -> None:
        """Plan ``plan``'s fold-parallel ``cli train``, then ``cli predict``
        of its folds on rank 0; checked on rank 0."""
        from image_classification_tpu_torch import cli
        from image_classification_tpu_torch.tools.parallel_check import (
            check_fold_parallel_run, read_submission, require)

        self.splits(self.cfg(self.argv(plan, paths, "x")))
        run = self.fold_parallel(plan, paths, f"{plan}_par")
        self.results.setdefault(plan, {})["fold_parallel"] = run
        if self.rank == 0:
            argv = run["argv"]
            cfg = self.cfg(argv)
            records = self.check(plan, check_fold_parallel_run, cfg, cfg.num_folds,
                                 EPOCHS, plan_meshes()[plan], TEST_IMAGES) or []
            run["records"] = records
            if records:
                want = self.expected(cfg, records)

                def launches_exact():
                    for rank, (r, w) in enumerate(zip(run["ranks"], want)):
                        for key, n in w.items():
                            require(r["launches"][key] == n, f"rank {rank} launched "
                                    f"{key} {r['launches'][key]} times, expected {n}")
                    return True
                run["launches_exact"] = bool(self.check(plan, launches_exact))
            print(f"plan {plan}, fold-parallel cli train ({run['ranks'][0]['threads']} "
                  f"torch threads a rank): walls {[r['wall_s'] for r in run['ranks']]} s; "
                  f"each rank's launches {[r['launches'] for r in run['ranks']]}, exact: "
                  f"{run.get('launches_exact')}; images/s by (fold, epoch) "
                  f"{[(r['fold'], r['epoch'], r['images_per_sec']) for r in records]}",
                  flush=True)
            folds = ",".join(str(k) for k in range(1, cfg.num_folds + 1))
            at = argv.index("--device") + 2   # the overrides
            t0 = time.perf_counter()
            cli.main(["predict", *argv[1:at], "--folds", folds, *argv[at:],
                      f"submission_path={cfg.output_dir}/predict.csv"])
            run["predict_s"] = time.perf_counter() - t0

            def same_submission():
                require(read_submission(f"{cfg.output_dir}/predict.csv")[1:]
                        == read_submission(cfg.submission_path)[1:],
                        "cli predict on the fold-parallel checkpoints differs from "
                        "its submission")
            self.check(plan, same_submission)
            print(f"plan {plan}: cli predict on folds {folds}: {run['predict_s']:.1f} s",
                  flush=True)
        free_memory()
        dist.barrier()

    def _sequential(self, plan: str, argv: list[str]) -> None:
        """Plan ``plan``'s sequential ``cli train`` in a process of its own on
        this rank's card (the group's variables left out, so it is one
        process); its wall to ``sequential_{plan}.json``, its end marked in
        ``sequential_{plan}.done``."""
        env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
        # the fold-parallel ranks' torch threads, so that the two runs differ
        # in their processes alone
        env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        local = int(os.environ["LOCAL_RANK"])
        env["CUDA_VISIBLE_DEVICES"] = visible.split(",")[local] if visible else str(local)
        wall_json = os.path.join(self.work, f"sequential_{plan}.json")
        log = os.path.join(self.out, f"sequential_{plan}.log")
        status = "failed"
        try:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", SEQUENTIAL, wall_json, *argv],
                                  env=env, cwd=self.repo, capture_output=True, text=True)
            with open(log, "w") as f:
                f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"plan {plan}: the sequential cli train failed "
                                   f"(rc {proc.returncode}); its output: {log}")
            with open(wall_json) as f:
                wall = json.load(f)["wall_s"]
            with open(wall_json, "w") as f:
                json.dump({"wall_s": wall, "process_s": time.perf_counter() - t0}, f)
            status = "ok"
        finally:
            with open(os.path.join(self.work, f"sequential_{plan}.done"), "w") as f:
                f.write(status)

    def sequential(self, runs: dict[str, tuple[int, list[str]]]) -> None:
        """The sequential ``cli train`` of each plan in ``runs`` (plan ->
        (rank, argv)), one process on that rank's card, at once; then each
        fold-parallel run against it, on rank 0."""
        from image_classification_tpu_torch.tools.parallel_check import (
            compare_with_sequential)

        for plan, (rank, argv) in runs.items():
            if rank == self.rank:
                self._sequential(plan, argv)
        # the ranks without a run wait here, not at a collective
        marks = [os.path.join(self.work, f"sequential_{plan}.done") for plan in runs]
        while not all(os.path.exists(m) for m in marks):
            time.sleep(1)
        for m in marks:
            with open(m) as f:
                if f.read() != "ok":
                    raise RuntimeError(f"{m}: the sequential cli train failed")
        dist.barrier()
        if self.rank != 0:
            return
        for plan, (_, argv) in runs.items():
            cfg = self.cfg(argv)
            with open(os.path.join(cfg.output_dir, "metrics.jsonl")) as f:
                seq = [json.loads(line) for line in f]
            with open(os.path.join(self.work, f"sequential_{plan}.json")) as f:
                walls = json.load(f)
            par = self.results[plan]["fold_parallel"]
            print(f"plan {plan}: fold-parallel cli train vs sequential, each fold's "
                  f"train loss an epoch:", flush=True)
            rels = self.check(plan, compare_with_sequential, par.get("records", []), seq)
            self.results[plan]["sequential"] = {"records": seq, **walls,
                                                "train_loss_rel": rels}
            print(f"plan {plan} walls: fold-parallel cli train "
                  f"{max(r['wall_s'] for r in par['ranks']):.1f} s, sequential "
                  f"{walls['wall_s']:.1f} s "
                  f"(its process {walls['process_s']:.1f} s); sequential images/s "
                  f"{[(r['fold'], r['epoch'], r['images_per_sec']) for r in seq]}",
                  flush=True)


# --------------------------------------------------------------------- main
def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="run_multicard")
    p.add_argument("--out", default=os.path.join("output", "multicard"))
    p.add_argument("--plans", default=PLANS,
                   help=f"the plans to run, in order (a subset of {PLANS!r})")
    args = p.parse_args(argv)
    if not args.plans or set(args.plans) - set(PLANS):
        p.error(f"--plans takes letters of {PLANS!r}, not {args.plans!r}")
    return args


def main(argv=None) -> int:
    from image_classification_tpu_torch.ops import _build
    from image_classification_tpu_torch.parallel import distributed

    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    check_setup(world, n_cards)
    torchrun_threads = torch.get_num_threads()
    distributed.initialize("cuda", timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    device = torch.device("cuda", torch.cuda.current_device())
    uuids = gather(str(torch.cuda.get_device_properties(device).uuid))
    check_setup(world, n_cards, dist.get_backend(), uuids)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    repo = os.getcwd()
    os.makedirs(args.out, exist_ok=True)
    work = gather(tempfile.mkdtemp(prefix="ic_multicard_") if rank == 0 else None)[0]
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    _, compile_s = _build.build()
    builds = gather({"compile_s": compile_s, "wall_s": time.perf_counter() - t0})
    run = Run(repo, args.out, work, device)
    if rank == 0:
        print(f"world {world}, backend {dist.get_backend()}, NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}; cards by rank (UUID) {uuids}", flush=True)
        print(nvidia_smi("index,name,power.limit,pci.bus_id"), flush=True)
        print(f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} to this "
              f"process; OMP_NUM_THREADS={os.environ.get('OMP_NUM_THREADS')}; torch "
              f"threads a rank: {torchrun_threads} as started, "
              f"{torch.get_num_threads()} after initialize (at most "
              f"{distributed.rank_threads()}, its share)", flush=True)
        print(f"kernels: each rank's (compile s, wall s) "
              f"{[(b['compile_s'], b['wall_s']) for b in builds]}", flush=True)
    steps = step_plans(repo)
    sequential = {}
    paths = None
    for plan in args.plans:
        t_plan = time.perf_counter()
        run.step_plan(plan, plan_meshes()[plan], steps[plan])
        if plan == "g":
            run.remat_plan(plan)
        if plan in "ef" and paths is None:
            made = run.data(TRAIN_IMAGES)
            paths = made["paths"]
            run.results["data"] = made["info"]
        if plan in "ef":
            run.entry_plan(plan, paths)
            # e's sequential run on rank 0's card, f's on rank 1's
            sequential[plan] = (len(sequential),
                                run.argv(plan, paths, f"{plan}_seq", parallel=False))
        run.log(f"plan {plan}: {time.perf_counter() - t_plan:.1f} s")
    t0 = time.perf_counter()
    run.sequential(sequential)
    run.log(f"sequential runs: {time.perf_counter() - t0:.1f} s")
    failures = gather(len(run.failures))[0]
    if rank == 0:
        report = {"plans": args.plans, "world": world, "uuids": uuids,
                  "cards": nvidia_smi("index,name,power.limit,pci.bus_id"),
                  "builds": builds,
                  "torch_threads": [torchrun_threads, torch.get_num_threads()],
                  "results": run.results, "failures": run.failures,
                  "wall_s": time.perf_counter() - t_start}
        with open(os.path.join(args.out, "multicard.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"run_multicard: plans {args.plans} in {report['wall_s']:.1f} s; "
              f"{len(run.failures)} out of bound: {run.failures}", flush=True)
        shutil.rmtree(work, ignore_errors=True)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
