"""Timing and tracing (PyTorch port).

Counterpart: altro_tpu/profiling.py (`time_fn`, `benchmark_solves`,
`trace`): wall-clock statistics of a callable, synchronized on the card
when CUDA is in use (the JAX module's block_until_ready), solves per
second, and a trace context over torch.profiler (the JAX module's
jax.profiler), written to a directory as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["time_fn", "benchmark_solves", "trace"]


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> Dict[str, float]:
    """Run fn(*args) `iters` times (after `warmup` runs); returns wall-clock
    statistics in milliseconds (p50 / p90 / p99 / mean)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        samples.append((time.perf_counter() - t0) * 1e3)
    s = np.asarray(samples)
    return {
        "p50_ms": float(np.percentile(s, 50)),
        "p90_ms": float(np.percentile(s, 90)),
        "p99_ms": float(np.percentile(s, 99)),
        "mean_ms": float(s.mean()),
        "iters": iters,
    }


def benchmark_solves(fn: Callable, *args, batch: int, iters: int = 10) -> Dict[str, float]:
    """Timing statistics plus solves/s for a batched solve callable."""
    stats = time_fn(fn, *args, iters=iters)
    stats["solves_per_s"] = batch / (stats["p50_ms"] / 1e3)
    stats["batch"] = batch
    return stats


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler session (CPU, and CUDA when available) whose Chrome
    trace is written to logdir/trace.json at the end."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
