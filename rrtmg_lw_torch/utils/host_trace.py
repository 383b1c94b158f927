"""Where the host holds a gradient step back on the card.

    PYTHONPATH=<checkout> python rrtmg_lw_torch/utils/host_trace.py \\
        [--cell maxrand_cloudy_grad] [--steps 40] [--traced 8] \\
        [--sync-count] [--out trace.json]

Runs one cell of ``utils/profiling.py`` (default ``maxrand_cloudy_grad``,
B=16384, L=60) from the checkout first on ``PYTHONPATH`` (the imports are
absolute, so a parent checkout's package can be measured by this file),
each step followed by ``torch.cuda.synchronize``.  Host-timed steps give
the wall (to the end of the synchronize) and the host's dispatch time
(until the step returns: the forward, and autograd's backward, which
returns once every kernel of it is launched).  Then ``torch.profiler``
with CPU and CUDA activities over ``--traced`` steps, each inside a
``record_function`` range, gives per step: device busy ms (the union of
the kernel and memcpy/memset intervals), its idle ms, split into the
forward (up to K1's start), the middle (to the end of the step's
largest kernel, K6) and the tail (after it); the CUDA launches; the host
ms spent in the runtime's synchronizing calls (``cudaEventSynchronize``,
``cudaStreamSynchronize``, ...), and the device idle ms that follow
them until the next kernel starts (a wait that drains the queue).

``--sync-count`` (a checkout whose model starts ``rtrn_cuda.KeptCount``
as it forms the overlap rows): the count of the maxrand state's slots is
made where K1 allocates the state instead, a wait on the card there;
the same launches.  Prints one JSON line (medians over the steps).  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import time

import torch

from rrtmg_lw_torch.parallel import make_grad_step
from rrtmg_lw_torch.utils.profiling import CELLS, NCOL, cell_inputs, ddt_loss

K1_SYMBOL = "rt_kernel<"
STEP = "host_step"          # the record_function range of a traced step


def _union(intervals):
    """The union of (start, end) intervals, as a sorted disjoint list."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(union, lo, hi):
    """The length of ``union`` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union)


def defer_count():
    """The model's early count of the state's slots made at the
    allocation instead (a wait on the card there)."""
    from rrtmg_lw_torch.models import radiation
    from rrtmg_lw_torch.ops import rtrn_cuda
    if not hasattr(radiation, "KeptCount"):
        raise SystemExit("--sync-count: this checkout's model starts no "
                         "early count")

    class Deferred:
        def __init__(self, rows_t):
            self.rows_t = rows_t

        def value(self):
            return rtrn_cuda.KeptCount(self.rows_t).value()
    radiation.KeptCount = Deferred


def step_trace(prof, traced):
    """Per traced step (the ``STEP`` ranges), the metrics of the module
    docstring, from the profiler's events (``prof.events()``), in ms: their
    medians over the steps."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = list(prof.events())
    # the range on the host; its twin on the device timeline (a user
    # annotation, not work) is left out of the device's events
    steps = sorted((e.time_range.start, e.time_range.end) for e in ev
                   if e.name == STEP and e.device_type == cpu)
    if len(steps) != traced:
        raise RuntimeError(f"{len(steps)} host ranges of {traced} steps")
    dev = [e for e in ev if e.device_type == cuda and e.name != STEP
           and not getattr(e, "is_user_annotation", False)]
    syncs = [e for e in ev if e.device_type == cpu
             and e.name.startswith("cuda") and "Synchronize" in e.name]
    rows = []
    for i, (s, e) in enumerate(steps):
        nxt = steps[i + 1][0] if i + 1 < len(steps) else float("inf")
        d = [x for x in dev if s <= x.time_range.start < nxt]
        iv = [(x.time_range.start, x.time_range.end) for x in d]
        busy = _union(iv)
        end = max(b for _, b in iv)
        k1 = min(x.time_range.start for x in d if K1_SYMBOL in x.name)
        big = max(d, key=lambda x: x.time_range.elapsed_us())
        k6 = big.time_range.end

        def idle(lo, hi):
            return (hi - lo) - _covered(busy, lo, hi)
        waits = [x for x in syncs if s <= x.time_range.start < e]
        after = 0.0
        for w in waits:
            lo = w.time_range.start
            hi = min((a for a, _ in iv if a >= w.time_range.end), default=end)
            after += idle(lo, hi)
        rows.append(dict(
            host_traced_ms=(e - s) / 1e3, wall_traced_ms=(end - s) / 1e3,
            busy_ms=_covered(busy, s, end) / 1e3,
            idle_ms=idle(s, end) / 1e3, idle_fwd_ms=idle(s, k1) / 1e3,
            idle_mid_ms=idle(k1, k6) / 1e3, idle_tail_ms=idle(k6, end) / 1e3,
            largest_kernel=big.name[:60], launches=len(d),
            sync_calls=len(waits),
            sync_ms=sum(w.time_range.elapsed_us() for w in waits) / 1e3,
            idle_after_sync_ms=after / 1e3))
    return {k: statistics.median(r[k] for r in rows) if k != "largest_kernel"
            else rows[0][k] for k in rows[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="maxrand_cloudy_grad",
                    choices=[c for c, v in CELLS.items() if v.grad])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--traced", type=int, default=8)
    ap.add_argument("--sync-count", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_trace needs a CUDA device")
    if args.sync_count:
        defer_count()
    device = torch.device("cuda", 0)
    c = CELLS[args.cell]
    step = make_grad_step(c.make_model(device), ddt_loss(NCOL, c.nlay, device)
                          if c.ddt else None, c.cloud_grads)
    atm, clouds = cell_inputs(args.cell, device)
    for _ in range(3):
        step(atm, clouds)
    torch.cuda.synchronize()
    walls, hosts = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(atm, clouds)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        hosts.append((t1 - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.traced):
            with torch.profiler.record_function(STEP):
                step(atm, clouds)
            torch.cuda.synchronize()
    q = statistics.quantiles
    out = dict(cell=args.cell, sync_count=args.sync_count,
               device=torch.cuda.get_device_name(0),
               power_limit=subprocess.run(
                   ["nvidia-smi", "--query-gpu=power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True).stdout.strip(),
               wall_ms=statistics.median(walls),
               wall_ms_q1_q3=[q(walls, n=4)[0], q(walls, n=4)[2]],
               host_ms=statistics.median(hosts),
               host_ms_q1_q3=[q(hosts, n=4)[0], q(hosts, n=4)[2]],
               **step_trace(prof, args.traced))
    out["idle_share"] = 1.0 - out["busy_ms"] / out["wall_ms"]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(line + "\n")


if __name__ == "__main__":
    main()
