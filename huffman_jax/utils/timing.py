"""Timing / throughput harness.

Role of the reference's ad-hoc timer layers (`gpuhd/include/cuhd_util.h:24-41`
chrono macros, `Huffman_coding_Gap_arrays/*/include/cu_timer.h` cudaEvent
timers) with the Yamamoto benchmark discipline of warmup + repeated timed
runs averaging the tail (`decoder/src/decoder.cu:760-803`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax

__all__ = ["BenchResult", "bench_fn", "GB"]

GB = 1e9


@dataclasses.dataclass
class BenchResult:
    name: str
    bytes_processed: int
    times_s: list
    # seconds
    @property
    def best_s(self) -> float:
        return min(self.times_s)

    @property
    def mean_s(self) -> float:
        return sum(self.times_s) / len(self.times_s)

    @property
    def gbps(self) -> float:
        """GB/s at the *median* time (robust to stragglers)."""
        ts = sorted(self.times_s)
        med = ts[len(ts) // 2]
        return self.bytes_processed / med / GB

    def __str__(self) -> str:
        return (
            f"{self.name}: {self.gbps:.3f} GB/s "
            f"(median of {len(self.times_s)}, best {self.bytes_processed / self.best_s / GB:.3f})"
        )


def bench_fn(
    name: str,
    fn: Callable,
    bytes_processed: int,
    *,
    warmup: int = 2,
    repeat: int = 5,
) -> BenchResult:
    """Time ``fn()`` (which must return a JAX array or pytree) with device
    synchronization via ``block_until_ready``."""

    def run_once():
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        return time.perf_counter() - t0

    for _ in range(warmup):
        run_once()
    times = [run_once() for _ in range(repeat)]
    return BenchResult(name=name, bytes_processed=bytes_processed, times_s=times)
