"""The run's surroundings: the program's caches inside the checkout, the
check that nothing of JAX is loaded, and what the card and the host are."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

# top-level module names that may not be loaded: JAX and its libraries, and
# the JAX package the port was made from (compared whole: the port's name
# begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "image_classification_tpu")
PROGRAM = "image_classification_tpu_torch"


def set_caches(root: Path) -> None:
    """Triton's cache at a fixed directory inside the checkout (the nvcc
    library builds under the port's own ``_build/`` there); and nothing
    that would load JAX through a library's optional backend."""
    os.environ["TRITON_CACHE_DIR"] = str(root / ".bench_cache" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The loaded modules whose top-level name is one of ``forbidden``."""
    names = list(sys.modules if modules is None else modules)
    return sorted({n for n in names if n.split(".", 1)[0] in forbidden})


def require_no_jax() -> None:
    found = loaded_forbidden()
    if found:
        raise RuntimeError(f"JAX or the JAX package is loaded: {found}")


def smi(fields: str) -> list[str]:
    """``nvidia-smi``'s reading of ``fields``, one line a card ([] where
    it cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def host_line() -> str:
    """The cards' names, power limits and clocks, the host's load and the
    cores this process may use: printed before the result."""
    cards = smi("name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu")
    load = os.getloadavg()
    cores = sorted(os.sched_getaffinity(0))
    return (f"cards: {cards}; load average: {load[0]:.2f} {load[1]:.2f} {load[2]:.2f}; "
            f"cores: {len(cores)} ({cores[0]}-{cores[-1]})")
