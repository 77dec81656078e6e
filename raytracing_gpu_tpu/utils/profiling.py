"""Profiling & timing helpers — the observability the reference lacks.

The reference's tracing story is nvcc `-lineinfo` for nsight plus ad-hoc
printf around kernel launches (SURVEY §5). Equivalents here:

- `trace(dir)`: context manager around `jax.profiler.trace` (view with
  tensorboard / xprof).
- `Timer`: block_until_ready-bracketed wall timing with warmup/repeats —
  the measurement discipline every bench in this repo uses.
- `annotate(name)`: `jax.profiler.TraceAnnotation` for custom trace spans.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    return jax.profiler.TraceAnnotation(name)


@dataclass
class Timer:
    """Best-of-N wall timing of jax computations (device-synchronized)."""

    warmup: int = 1
    repeats: int = 5
    times: dict = field(default_factory=dict)

    def measure(self, name: str, fn, *args, **kwargs) -> float:
        for _ in range(self.warmup):
            jax.block_until_ready(fn(*args, **kwargs))
        best = float("inf")
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args, **kwargs))
            best = min(best, time.perf_counter() - t0)
        self.times[name] = best
        return best

    def report(self) -> str:
        width = max((len(k) for k in self.times), default=0)
        return "\n".join(
            f"{k:<{width}s} {v * 1000:10.3f} ms" for k, v in self.times.items()
        )
