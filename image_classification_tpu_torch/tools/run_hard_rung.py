"""A rung of the hard ladder (``RESULTS.md``) through the port's ``cli
train``, from JPEG files the port writes.

    PYTHONPATH=. python image_classification_tpu_torch/tools/run_hard_rung.py \
        [--rung RUNG] [--root DIR] [--budget-s SECONDS] [--resume] \
        [--render-only] [key=value ...]

Renders the seed-0 hard set (``data/synthetic_hard.py``: 35,551 train and
2,000 test images at 60x80, the default ``HardTaskSpec``) as q90 JPEGs
under ``--root`` once (a marker file records a complete set) with the
decode caches of its train and test images, then runs ``cli train`` with
the JAX package's configuration of the rung (``tools/run_hard_ladder.py``'s
stage through ``tools/train_demo_tpu.py hard=true``: ``folds=`` becomes
``num_folds=``, ``config=`` the config file, and a stage without one trains
``model_name=convnext_base`` on ``Config()`` defaults; ``key=value``
arguments are appended, so ``seed=1`` reseeds the port's run, where the
JAX tool's ``seed=`` would draw another data set):

- ``v4_emaoff`` (the default; stage ``abl_noema``): ``Config()`` defaults
  with ``model_name=convnext_base epochs=30 patience=10 split_mode=holdout
  val_fraction=0.5 use_ema=false save_state_every=0``; JAX's curve is
  ``docs/results/hard_ladder_metrics.jsonl`` lines 74-103 (555 steps an
  epoch);
- ``v1`` (stage ``v1``): ``configs/v1_effb0.json`` with ``epochs=12
  num_folds=2``; lines 1-24 (2 folds, 277 steps an epoch);
- ``v3_1`` (stage ``v3_1``): ``configs/v3_1.json`` with ``epochs=12
  num_folds=2 swa_start_epoch=8 patience=8 save_state_every=0``; lines
  134-157 (2 folds, 138 steps an epoch), and each fold's SWA validation
  from ``train.log``;
- ``v4_long`` (stage ``v4_long``): ``v4_emaoff`` with EMA on, so it
  validates the EMA weights; lines 44-73;
- ``abl_nomix`` (stage ``abl_nomix``): ``v4_long`` with ``mixup_alpha=0.0
  cutmix_alpha=0.0 mix_prob=0.0``; lines 104-133;
- ``abl_v1_nosampler`` (stage ``abl_v1_nosampler``): ``v1`` with
  ``use_sampler=false oversample_min_samples=0 save_state_every=0``; lines
  158-181;
- ``abl_v1_noaug`` (stage ``abl_v1_noaug``): ``v1`` with ``hflip_prob=0.0
  ssr_prob=0.0 rotate_limit=0.0 color_jitter_prob=0.0 save_state_every=0``;
  lines 182-205.

Rungs can run side by side, one process a card or several on one card:
render the set once with ``--render-only`` first (the marker and the
decode caches would race), then start each rung with its own
``CUDA_VISIBLE_DEVICES`` and ``OMP_NUM_THREADS``; each rung writes its own
``out_<rung>``, ``models_<rung>`` and submission under ``--root``.

As ``metrics.jsonl`` grows it prints each epoch's val accuracy beside the
JAX package's, and at the end one JSON line with both curves and the best
of each fold over the epochs run.

``--budget-s`` stops ``cli train`` once the next epoch would end past that
many seconds from the start; the schedule keeps its 30-epoch horizon, so the
epochs run are the first epochs of the full rung. ``--resume`` passes
``--resume`` to ``cli train``, which continues from
``train_state_fold1.pt``; that needs ``save_state_every=1`` in the run that
wrote it (ConvNeXt-B's train state is ~1 GB). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

N_TRAIN, N_TEST = 35551, 2000
JAX_METRICS = os.path.join(REPO, "docs", "results", "hard_ladder_metrics.jsonl")
# rung -> (its name, the config file or None for Config() defaults, its
# overrides, the JAX curve's lines in JAX_METRICS, folds, epochs)
RUNGS = {
    "v4_emaoff": ("abl_noema (V4, EMA off, 50% holdout)", None,
                  ["model_name=convnext_base", "epochs=30", "patience=10",
                   "split_mode=holdout", "val_fraction=0.5", "use_ema=false",
                   "save_state_every=0"], (74, 103), 1, 30),
    "v1": ("v1 (configs/v1_effb0.json, 2 folds)", "configs/v1_effb0.json",
           ["epochs=12", "num_folds=2"], (1, 24), 2, 12),
    "v3_1": ("v3_1 (configs/v3_1.json, 2 folds, SWA from epoch 8)", "configs/v3_1.json",
             ["epochs=12", "num_folds=2", "swa_start_epoch=8", "patience=8",
              "save_state_every=0"], (134, 157), 2, 12),
    "v4_long": ("v4_long (V4, EMA on, 50% holdout)", None,
                ["model_name=convnext_base", "epochs=30", "patience=10",
                 "split_mode=holdout", "val_fraction=0.5", "save_state_every=0"],
                (44, 73), 1, 30),
    "abl_nomix": ("abl_nomix (V4, mix off, 50% holdout)", None,
                  ["model_name=convnext_base", "epochs=30", "patience=10",
                   "split_mode=holdout", "val_fraction=0.5", "mixup_alpha=0.0",
                   "cutmix_alpha=0.0", "mix_prob=0.0", "save_state_every=0"],
                  (104, 133), 1, 30),
    "abl_v1_nosampler": ("abl_v1_nosampler (V1, sampler off, 2 folds)",
                         "configs/v1_effb0.json",
                         ["epochs=12", "num_folds=2", "use_sampler=false",
                          "oversample_min_samples=0", "save_state_every=0"],
                         (158, 181), 2, 12),
    "abl_v1_noaug": ("abl_v1_noaug (V1, aug off, 2 folds)", "configs/v1_effb0.json",
                     ["epochs=12", "num_folds=2", "hflip_prob=0.0", "ssr_prob=0.0",
                      "rotate_limit=0.0", "color_jitter_prob=0.0",
                      "save_state_every=0"], (182, 205), 2, 12),
}


def jax_curve(rung: str) -> dict[tuple[int, int], dict]:
    """The JAX package's records of the rung, by (fold, epoch)."""
    _, _, _, (first, last), folds, epochs = RUNGS[rung]
    with open(JAX_METRICS) as f:
        lines = f.read().splitlines()[first - 1:last]
    curve = {(r.get("fold", 1), r["epoch"]): r for r in map(json.loads, lines)}
    if set(curve) != {(f, e) for f in range(1, folds + 1) for e in range(epochs)}:
        raise ValueError(f"{JAX_METRICS}:{first}-{last}: not rung {rung}'s "
                         f"{folds} x {epochs} epochs")
    return curve


def render(root: str) -> dict:
    """Write the set once, then build (or reuse) the decode caches of its
    train and test images under ``root/.cache``, where every rung's ``cli
    train`` finds them complete."""
    from image_classification_tpu_torch.data import make_hard_synthetic_dataset
    from image_classification_tpu_torch.data.manifest import Manifest
    from image_classification_tpu_torch.data.source import ImageSource

    marker = os.path.join(root, f".done_{N_TRAIN}")
    made = {"render_s": 0.0, "encode_s": 0.0}
    if not os.path.exists(marker):
        seconds = make_hard_synthetic_dataset(root, n_train=N_TRAIN, n_test=N_TEST,
                                              native_size=(60, 80), seed=0)["seconds"]
        made = {"render_s": seconds["render"], "encode_s": seconds["encode"]}
        with open(marker, "w") as f:
            f.write("ok")
    t0 = time.perf_counter()
    for csv, folder, test in (("train.csv", "train", False),
                              ("sample_submission.csv", "test", True)):
        ids = Manifest.from_csv(os.path.join(root, csv), is_test=test).ids
        ImageSource(os.path.join(root, folder), ids, native_size=(60, 80),
                    cache_dir=os.path.join(root, ".cache"))
    return {**made, "cache_s": round(time.perf_counter() - t0, 1)}


def read_records(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rung", choices=sorted(RUNGS), default="v4_emaoff")
    p.add_argument("--root", default=os.path.join(REPO, "demo_data_hard_torch"))
    p.add_argument("--budget-s", type=float, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--render-only", action="store_true",
                   help="write the set and its decode caches, then exit")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args()
    t_start = time.perf_counter()
    root = os.path.abspath(args.root)
    name, config, rung_args, _, folds, _ = RUNGS[args.rung]
    reference = jax_curve(args.rung)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    made = render(root)
    print(f"hard set under {root}: render {made['render_s']:.1f} s, encode "
          f"{made['encode_s']:.1f} s, decode caches {made['cache_s']:.1f} s; on {smi}",
          flush=True)
    if args.render_only:
        return 0
    suffix = "" if args.rung == "v4_emaoff" else f"_{args.rung}"
    out_dir = os.path.join(root, f"out{suffix}")
    over = [*rung_args, f"train_dir={root}/train", f"test_dir={root}/test",
            f"train_csv={root}/train.csv", f"test_csv={root}/sample_submission.csv",
            f"submission_path={root}/submission{suffix}.csv",
            f"model_save_path={root}/models{suffix}",
            f"output_dir={out_dir}", f"cache_dir={root}/.cache", *args.overrides]
    metrics = os.path.join(out_dir, "metrics.jsonl")
    seen = len(read_records(metrics)) if args.resume else 0
    if not args.resume and os.path.exists(metrics):
        os.remove(metrics)
    cmd = [sys.executable, "-m", "image_classification_tpu_torch.cli", "train",
           *(["--resume"] if args.resume else []),
           *([] if config is None else ["--config", os.path.join(REPO, config)]), *over]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, *filter(None, [os.environ.get("PYTHONPATH")])])}
    proc = subprocess.Popen(cmd, cwd=REPO, env=env)
    rows, stopped = [], False
    last = time.perf_counter()
    try:
        while True:
            done = proc.poll() is not None
            records = read_records(metrics)
            for r in records[seen:]:
                now = time.perf_counter()
                ref = reference.get((r["fold"], r["epoch"]), {})
                rows.append({"fold": r["fold"], "epoch": r["epoch"], "val_acc": r["val_acc"],
                             "jax_val_acc": ref.get("val_acc"), "train_loss": r["train_loss"],
                             "val_loss": r["val_loss"], "images_per_sec": r["images_per_sec"],
                             "duty_cycle": r["duty_cycle"], "epoch_s": round(now - last, 1)})
                print(f"fold {r['fold']} epoch {r['epoch']:2d}: val acc "
                      f"{r['val_acc']:.4f} (JAX "
                      f"{ref.get('val_acc', float('nan')):.4f}), train loss "
                      f"{r['train_loss']:.4f}, {r['images_per_sec']} images/s, duty cycle "
                      f"{r['duty_cycle']}, {now - last:.1f} s", flush=True)
                last = now
            seen = len(records)
            if done:
                break
            if args.budget_s is not None and len(rows) >= 2:
                epoch_s = max(row["epoch_s"] for row in rows[1:])
                if time.perf_counter() - t_start + epoch_s > args.budget_s:
                    print(f"budget: the next epoch (~{epoch_s:.0f} s) would end past "
                          f"{args.budget_s:.0f} s; stopping cli train", flush=True)
                    stopped = True
                    break
            time.sleep(5)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if proc.returncode != 0 and not stopped:
        print(f"cli train exited with {proc.returncode}", flush=True)
        return 1
    log_path = os.path.join(out_dir, "train.log")
    swa = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            swa = [ln.split(" - ")[-1] for ln in f.read().splitlines() if " SWA (" in ln]
    per_fold = {}
    for fold in range(1, folds + 1):
        mine = [row for row in rows if row["fold"] == fold]
        theirs = [r for (f, _), r in reference.items() if f == fold]
        per_fold[fold] = {
            "epochs_run": len(mine),
            "best_val_acc": max((row["val_acc"] for row in mine), default=None),
            "jax_best_val_acc_same_epochs": max(
                (reference[(fold, row["epoch"])]["val_acc"] for row in mine
                 if (fold, row["epoch"]) in reference), default=None),
            "jax_best_val_acc_all_epochs": max(r["val_acc"] for r in theirs),
        }
    summary = {
        "rung": name, "device": smi, "epochs_run": len(rows),
        "stopped_by_budget": stopped, "per_fold": per_fold, "swa": swa,
        "seconds": round(time.perf_counter() - t_start, 1), **made, "epochs": rows}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
