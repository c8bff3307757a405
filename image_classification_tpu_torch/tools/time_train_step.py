"""Wall and host CPU time a train step, for one checkout.

    python image_classification_tpu_torch/tools/time_train_step.py CHECKOUT

Runs ``make_train_step`` of ``CHECKOUT``'s package on ``configs/v4.json``
as it is (aug and MixUp/CutMix on, batch 32, accumulation 2) for ConvNeXt-B
and then ConvNeXt-L, seeded weights and uint8 60x80 inputs from
``CHECKOUT``'s ``chip_smoke.py``: 3 warm-up steps, then 20 timed, ending in
a synchronise. Prints one JSON line: images/s, wall ms and host CPU ms a
step (``time.process_time``). Where the CPU time equals the wall time, the
host, not the card, sets the step's pace. To compare two checkouts, run
them in turns in one call on the card (earlier, this, this, earlier), each
with ``PYTHONPATH=CHECKOUT``. Needs one CUDA card.
"""
import json
import os
import sys
import time

WARMUP, STEPS = 3, 20


def main() -> int:
    ck = os.path.abspath(sys.argv[1])
    sys.path.insert(0, ck)       # the checkout's package and chip_smoke.py
    import torch

    import chip_smoke as cs
    from image_classification_tpu_torch.core.config import load_config
    from image_classification_tpu_torch.train.loop import build_lr_schedule
    from image_classification_tpu_torch.train.loss import build_criterion
    from image_classification_tpu_torch.train.optim import build_optimizer
    from image_classification_tpu_torch.train.step import make_train_step
    from image_classification_tpu_torch.train.train_state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"checkout": ck}
    for model in ("convnext_base", "convnext_large"):
        cfg = load_config(os.path.join(ck, "configs", "v4.json")).replace(model_name=model)
        bundle = cs.train_model(cfg, "cuda")
        tx = build_optimizer(cfg, build_lr_schedule(cfg, 100))
        step = make_train_step(bundle, cfg, tx, build_criterion(cfg))
        gen = torch.Generator(device="cuda").manual_seed(5)
        state = create_train_state(bundle.module)
        n = WARMUP + STEPS
        images, labels = cs.train_inputs(cfg, n * cfg.batch_size, seed=21)
        batches = [{"image": images[i::n].cuda(), "label": labels[i::n].cuda()}
                   for i in range(n)]
        for b in batches[:WARMUP]:
            state, _ = step(state, b, generator=gen)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for b in batches[WARMUP:]:
            state, _ = step(state, b, generator=gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS
        cpu = (time.process_time() - c0) / STEPS
        out[model] = {"images_per_s": cfg.batch_size / wall, "wall_ms": wall * 1e3,
                      "host_cpu_ms": cpu * 1e3}
        del bundle, state, step, batches
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
