"""Measure per-iteration DEVICE time from a short ``torch.profiler`` trace.

Port of ``rrtmg_lw_tpu.utils.device_time`` (``device_seconds_per_iter``,
``:76``).  A step's wall time holds the host's dispatch (on the H100 the
L=60 forward cells are 32-48% idle behind it), so a kernel regression
can hide in the wall's spread.  This traces a few iterations under
``torch.profiler`` and takes the device's busy time: the union of the
CUDA kernel, memcpy and memset intervals (``profiling._union_ms``, the
cells' own measure) divided by the iteration count, which host gaps do
not enter.

Take device times in a fresh process: in a long one the profiler's
traces can hold fewer launches than were made (on the H100, 3 of 5
launches of a kernel late in ``chip_smoke.py``'s run), which the busy
time would silently lose.  ``detail["launches_per_iter"]`` shows it.
"""

from __future__ import annotations

import os

import torch

from .profiling import _device_work, glue_ops


def device_seconds_per_iter(run_iter, iters=3, logdir=None):
    """Trace ``iters`` calls of ``run_iter()`` (each one step; the caller
    owns the warm-up) and return (device seconds per iteration | None,
    detail).  ``detail``: ``busy_ms`` (the whole trace, as the JAX
    package's), ``iters``, ``launches_per_iter``, ``kernel_ms`` (the
    hand-written kernels) and ``glue_ops`` (the largest other ops), ms
    per iteration.  A trace with no CUDA events (a CPU step) gives
    (None, {"error": ...}).  ``logdir``: also write the Chrome trace
    there (``trace.json``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(iters):
            run_iter()
        if cuda:
            torch.cuda.synchronize()
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    busy, kernels, events, glue = _device_work(prof, iters)
    if not events:
        return None, {"error": "no CUDA events in the trace"}
    return busy / 1e3, {"busy_ms": busy * iters, "iters": iters,
                        "launches_per_iter": len(events) / iters,
                        "kernel_ms": kernels, "glue_ops": glue_ops(glue)}
