"""The prefetching stream's copy path, and K9's wrapper, on the card.

    python -m rrtmg_lw_torch.utils.stream_variants [--batches 10]
        [--rounds 2] [--out stream.json]

(1) The copy path.  The stream cells of ``utils/profiling.py`` are bound
by the host's batch making, which hides what the copy path costs; here
each cell's batches (``gcm_step``: the (Atmosphere, McicaCloudsCompact)
pair, ``wire_stream``: the coded WireBatch pair; B=16384, L=60) are made
once and held in host memory, then streamed through the entry point's
step by three forms, in turns (each round: every form, then every form
in reverse order):

* ``inline``: ``prefetch(depth=0)``, each batch placed by ``shard_batch``
  on the consumer's thread, its copies on the compute stream;
* ``pinned``: ``parallel.prefetch(depth=2)`` as the package has it (the
  worker copies each leaf into a rotating pinned buffer and starts its
  copy on the copy stream);
* ``pageable``: ``pageable_prefetch(depth=2)`` below, the same worker
  and consumer without the pinned slots: the worker calls
  ``shard_batch`` under the copy stream (pageable copies, the worker
  waiting on each), records an event, and the consumer waits on it.

Each form is timed with the step and with no step (the copies alone):
wall ms a batch, host clock to ``synchronize`` at the stream's end over
``--batches`` batches, the median over the rounds.

(2) K9's wrapper.  Host ms a call of the streamed step's sanitized
atmosphere decode (``decode_atmosphere``, 15.06 M codes), split: the
channel walk (``parallel.wire._channels``: the fallback rows, the refs'
``to_device``), the output allocations, the descriptor table
(``ops.wire_cuda.descriptors``: the ``_build.check`` of every code,
ref, range and fallback tensor, the ctypes fields) and the launch; the
median of ``--calls`` calls each, the card synchronized every 20.

Prints one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import torch

FORMS = ("inline", "pinned", "pageable")


def pageable_prefetch(batches, mesh, depth=2):
    """``parallel.prefetch`` without the pinned slots: the worker places
    each batch with ``shard_batch`` under a copy stream and records an
    event; the consumer makes the compute stream wait on it and calls
    ``record_stream`` on every tensor."""
    from ..parallel.mesh import shard_batch
    from ..parallel.stream import _tensors
    it = iter(batches)
    copy_stream = torch.cuda.Stream(device=mesh.device)
    stop = object()

    def feed():
        try:
            nxt = next(it)
        except StopIteration:
            return stop
        with torch.cuda.device(mesh.device), torch.cuda.stream(copy_stream):
            out = shard_batch(nxt, mesh)
            event = torch.cuda.Event()
            event.record(copy_stream)
        return out, event

    ex = ThreadPoolExecutor(max_workers=1)
    queue = collections.deque(ex.submit(feed) for _ in range(depth))
    try:
        while queue:
            ready = queue.popleft().result()
            if ready is stop:
                break
            queue.append(ex.submit(feed))
            batch, event = ready
            compute = torch.cuda.current_stream(mesh.device)
            compute.wait_event(event)
            for t in _tensors(batch):
                t.record_stream(compute)
            yield batch
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def stream_ms(form, batches, mesh, step):
    """Wall ms a batch of ``batches`` through ``step`` (None: the copies
    alone) by ``form``."""
    from ..parallel import prefetch
    src = (prefetch(batches, mesh, depth=0) if form == "inline" else
           prefetch(batches, mesh, depth=2) if form == "pinned" else
           pageable_prefetch(batches, mesh, depth=2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in src:
        if step is not None:
            step(*b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def copy_forms(cell, mesh, nbatch, rounds):
    """{form: {"step": ms, "copies": ms}} of one stream cell, and its
    host bytes a batch."""
    from .profiling import batch_bytes, stream_parts
    step, make = stream_parts(cell, mesh)
    batches = list(make(nbatch))
    for form in FORMS:                                  # warm-up
        stream_ms(form, batches[:2], mesh, step)
    times = {(f, s): [] for f in FORMS for s in ("step", "copies")}
    for _ in range(rounds):
        for order in (FORMS, FORMS[::-1]):
            for form in order:
                for what in ("step", "copies"):
                    times[form, what].append(stream_ms(
                        form, batches, mesh, step if what == "step" else None))
    out = {f: {s: statistics.median(times[f, s]) for s in ("step", "copies")}
           for f in FORMS}
    out["runs"] = {f"{f} {s}": v for (f, s), v in times.items()}
    return out, batch_bytes(batches[0])


def k9_wrapper_parts(mesh, calls):
    """Host ms a call of the sanitized atmosphere decode, and of its
    parts (medians)."""
    import numpy as np
    from ..ops import wire_cuda
    from ..parallel import shard_batch, wire as w
    from .profiling import NCOL
    from .synthetic import make_atmosphere
    L = 60
    ea = shard_batch(w.encode_atmosphere(make_atmosphere(
        NCOL, L, seed=0, dtype=np.float32), schema="coded"), mesh)
    taua = torch.zeros((NCOL, L, 16), device=mesh.device)
    dev, dt = mesh.device, torch.float32

    def shape_of(name):
        return {"tsfc": (NCOL,), "emis": (NCOL, 16), "plev": (NCOL, L + 1),
                "tlev": (NCOL, L + 1)}.get(name, (NCOL, L))

    def channels():
        return w._channels(w.ATM_FIELDS, ea, shape_of, dt, dev,
                           w._ATM_FLOORS, w._atm_fallback)
    chans = channels()

    def alloc():
        return {c.name: torch.empty(c.shape, dtype=dt, device=dev)
                for c in chans}
    outs = alloc()
    parts = dict(
        total=lambda: w.decode_atmosphere(ea, taua, sanitize=True),
        channels=channels,
        wrapper=lambda: wire_cuda.wire_decode(chans, dt, dev, NCOL, True),
        allocations=alloc,
        descriptors=lambda: wire_cuda.descriptors(chans, outs, dt, dev))
    res = {}
    for name, fn in parts.items():
        fn()
        ts = []
        for i in range(calls):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
            if i % 20 == 19:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        res[name] = statistics.median(ts)
    res["launch_and_rest"] = (res["wrapper"] - res["allocations"]
                              - res["descriptors"])
    res["channels_n"] = len(chans)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_variants needs a CUDA device")
    from ..parallel import make_mesh
    mesh = make_mesh()
    out = dict(device=torch.cuda.get_device_name(0), cells={})
    for cell in ("gcm_step", "wire_stream"):
        forms, nbytes = copy_forms(cell, mesh, args.batches, args.rounds)
        out["cells"][cell] = dict(forms, host_bytes_a_batch=nbytes)
        torch.cuda.empty_cache()
        print(f"{cell} ({nbytes / 1e6:.1f} MB a batch): " + ", ".join(
            f"{f} {forms[f]['step']:.2f} ms a batch ({forms[f]['copies']:.2f}"
            " copies alone)" for f in FORMS), flush=True)
    out["k9_wrapper_ms"] = k9_wrapper_parts(mesh, args.calls)
    print("k9 wrapper host ms a call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out["k9_wrapper_ms"].items()
        if k != "channels_n"), flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(line + "\n")


if __name__ == "__main__":
    main()
