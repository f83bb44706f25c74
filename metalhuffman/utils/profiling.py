"""Timing and device profiling helpers.

The reference's only observability is printf + Xcode GPU frame capture labels
(SURVEY.md section 5). Replacements here: wall-clock timers that
block on device completion, decoded-bytes bandwidth accounting, and
`jax.profiler` trace capture for Perfetto/XProf.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    """Accumulating wall-clock timer with GB/s accounting."""

    name: str = "timer"
    total_s: float = 0.0
    count: int = 0
    bytes_processed: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total_s += time.perf_counter() - self._t0
        self.count += 1
        return False

    def add_bytes(self, n: int) -> None:
        self.bytes_processed += n

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)

    @property
    def gbps(self) -> float:
        return self.bytes_processed / max(self.total_s, 1e-12) / 1e9

    def report(self) -> str:
        s = f"{self.name}: {self.mean_s*1e3:.3f} ms/iter x{self.count}"
        if self.bytes_processed:
            s += f", {self.gbps:.3f} GB/s"
        return s


def time_fn(fn, *args, iters: int = 10, warmup: int = 2, payload_bytes: int = 0):
    """Time a device function: returns (mean_seconds, GB/s). Blocks via
    ``block_until_ready`` so device work is fully counted."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / iters
    return dt, (payload_bytes / dt / 1e9 if payload_bytes else 0.0)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/mht_trace"):
    """Capture a jax.profiler trace viewable in Perfetto/XProf."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
