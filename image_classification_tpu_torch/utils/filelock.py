"""An exclusive lock between processes on one host: ``flock`` on a lock
file, which the kernel releases when its holder exits, a crash included.
The kernel and JPEG builds take it, so that under ``torchrun`` the first
rank to need a library builds it and the others wait and load it."""

from __future__ import annotations

import contextlib
import fcntl
from pathlib import Path


@contextlib.contextmanager
def exclusive(path: str | Path):
    """Hold the lock on ``path`` (created if missing) for the block."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)
