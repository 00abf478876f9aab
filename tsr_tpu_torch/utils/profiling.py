"""Tracing and timing: a ``torch.profiler`` trace context and a wall-clock
timer that waits for the card.

Port of ``tsr_tpu/utils/profiling.py``'s :func:`trace` and
:func:`device_time`. Its ``honor_cpu_request`` and
``enable_compilation_cache`` configure JAX alone and have no counterpart
here: the scripts' ``--device`` flag chooses the device, and the built
kernels are kept under ``build/`` at the root of the checkout
(``kernels/_build.py``), which is what a persistent compilation cache
gives the JAX package.

No module or script of the port calls :func:`trace` or
:func:`device_time`. In the repository only ``benchmarks/`` calls the
JAX package's ``device_time``, and nothing calls its ``trace``;
``benchmarks/`` is not ported, and ``chip_smoke.py`` times kernels with
CUDA events of its own. They are the library's API, for users who
profile the port.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str = "tsr_trace"):
    """``with trace(logdir): ...`` profiles the block (host, and the card's
    kernels when CUDA is available) and writes a Chrome trace,
    ``<logdir>/trace_<pid>_<n>.json``, readable in Perfetto or
    ``chrome://tracing``. Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    n = sum(1 for f in os.listdir(logdir) if f.startswith("trace_"))
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def _sync(out) -> None:
    """Wait for the card if any tensor of ``out`` lives on it."""
    leaves = out if isinstance(out, (list, tuple)) else (
        list(out.values()) if isinstance(out, dict) else [out])
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


def device_time(fn: Callable, *args, reps: int = 3,
                reduce: str = "min") -> float:
    """Wall seconds of ``fn(*args)``: one warm-up call, then ``reps`` timed
    calls, each closed by ``torch.cuda.synchronize()`` when its output is
    on the card. Returns the min (or, with ``reduce="mean"``, the mean)."""
    _sync(fn(*args))  # warm-up: kernel builds, cuDNN's choice of algorithm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times) if reduce == "min" else float(np.mean(times))
