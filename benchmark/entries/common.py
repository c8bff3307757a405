"""What the entries share: the program's Config from a configuration
file, a step-end marker on the device's stream, and the release of the
program's memory before the reference runs."""

from __future__ import annotations

import gc
import time

import torch

from benchmark.inputs import derive_seed
from benchmark.timing import intervals_between


def program_config(cfg_doc: dict, seed: int, **overrides):
    """The port's ``Config`` as the configuration file states it, with the
    run's seed (the sampler's order and the fold split follow it)."""
    from image_classification_tpu_torch.core.config import Config

    d = dict(cfg_doc["config"])
    d.update(overrides)
    d["seed"] = derive_seed(seed, "config") % (2**31)
    return Config.from_dict(d).validate()


class Marks:
    """Times on the device's stream: a CUDA event at each mark, read once
    the window has closed (the host never waits on one); on the CPU the
    host clock, where every op has finished when it returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        """The times between consecutive marks, in ms."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return intervals_between([1e3 * t for t in self.marks])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def peak_bytes(device: torch.device) -> int | None:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
