"""LR monitor, port of ``image_classification_tpu/utils/lr_monitor.py``:
record (step, lr) pairs and plot them to a PNG. ``plot`` imports matplotlib
when it is called (the machine the port targets may not have it; the trainer
catches the failure)."""

from __future__ import annotations

import os


class LRMonitor:
    def __init__(self) -> None:
        self.steps: list[int] = []
        self.lrs: list[float] = []

    def record(self, step: int, lr: float) -> None:
        self.steps.append(int(step))
        self.lrs.append(float(lr))

    def plot(self, path: str) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(self.steps, self.lrs)
        ax.set_yscale("log")
        ax.set_xlabel("step")
        ax.set_ylabel("learning rate")
        ax.set_title("LR schedule")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path
