"""Where the time of a step goes on the card.

    python -m rrtmg_lw_torch.utils.profiling [--out profile.json]
        [--cells CELL ...]

For each cell (``CELLS``, at ``NCOL`` columns: the forward step, or the
gradient step of
``parallel.make_grad_step`` for the ``*_grad`` cells, also with respect
to the clouds' fields ``Cell.cloud_grads``, of the default loss or, the
``*_ddt_grad`` cells, of ``ddt_loss``, which reads the d/dT outputs;
for the ``mcica_generate*`` cells the generate-then-radiate step,
``generate_step``: K8 samples the compact int8 mask from the (B, L)
cloud profile, then the forward step):
for the stream cells (``gcm_step``, ``wire_stream``: the
entry points of ``rrtmg_lw_torch.examples`` on a one-rank mesh)
``profile_stream``; else the median and
quartiles of 20 host-timed steps (host clock around work that ends in ``torch.cuda.synchronize``),
then ``torch.profiler`` over 5 steps: device busy ms per step (the union
of the CUDA kernel and memcpy/memset intervals), the idle share
``1 - busy / wall``, device ms per step of each hand-written kernel (by
its symbol) and of everything else ("glue"), the CUDA launches per step,
and the peak device memory.  Prints one JSON line per cell.  Needs a
CUDA device.  ``cell_inputs`` makes each cell's synthetic inputs and
``Cell.make_model`` its model (a cell with ``spec`` set builds it under
``RRTMG_SPEC_DTYPE``, the reduced spectral storage, on an atmosphere with
aerosol); the repository's
``chip_smoke.py`` runs its cells on the same ones.  Beside the device
ms of the named kernels, each line carries ``glue_ops``: the device ms
per step of the ``GLUE_OPS`` largest other CUDA ops, by name.

The observability utilities of ``rrtmg_lw_tpu.utils.profiling``, with
its signatures and return contracts, for users' own loops:

  * ``ThroughputMeter``: columns per second over steps, the clock
    stopped after the device of the step's result has finished;
  * ``StageTimer``: named stage timing with warm-up discard and a device
    sync, the minimum over calls;
  * ``trace``: ``torch.profiler`` (CPU and, on a CUDA device, CUDA
    activities) around a block, a Chrome trace written into ``logdir``;
  * ``device_memory_stats``: bytes in use, peak and the card's total,
    None for a CPU device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import os
import pathlib
import statistics
import tempfile
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..parallel.api import CLOUD_GRADS, MCICA_GRADS, RADII_GRADS


def _sync(tree):
    """Wait for the devices of the CUDA tensors in ``tree`` (tensors,
    NamedTuples, tuples, lists and dicts of them) to finish; -> tree."""
    devices, stack = set(), [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


@dataclasses.dataclass
class ThroughputMeter:
    """Accumulates columns processed / wall seconds across steps.

    Store the step's output in the yielded holder so the meter can wait
    for the device before stopping the clock; otherwise only the
    asynchronous launches are timed::

        meter = ThroughputMeter()
        for atm, clouds in stream:
            with meter.step(ncols=atm.play.shape[0]) as h:
                h["result"] = model(atm, clouds)   # synced on exit
        print(meter.columns_per_sec)
    """

    columns: int = 0
    steps: int = 0
    seconds: float = 0.0

    @contextlib.contextmanager
    def step(self, ncols: int, result=None):
        t0 = time.perf_counter()
        holder = {}
        if result is not None:
            holder["result"] = result
        try:
            yield holder
        finally:
            if "result" in holder:
                _sync(holder["result"])
            self.seconds += time.perf_counter() - t0
            self.columns += int(ncols)
            self.steps += 1

    @property
    def columns_per_sec(self) -> float:
        return self.columns / self.seconds if self.seconds else 0.0

    def report(self) -> Dict[str, float]:
        return {"columns": self.columns, "steps": self.steps,
                "seconds": round(self.seconds, 4),
                "columns_per_sec": round(self.columns_per_sec, 1)}


class StageTimer:
    """Per-stage wall timing with device sync and warm-up discard."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: Dict[str, list] = {}

    def measure(self, name: str, fn, *args, iters: int = 10):
        out = _sync(fn(*args))
        for _ in range(max(self.warmup - 1, 0)):
            _sync(fn(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _sync(out)
        dt = (time.perf_counter() - t0) / iters
        self._times.setdefault(name, []).append(dt)
        return out

    def report(self) -> Dict[str, float]:
        return {k: round(min(v) * 1e3, 3) for k, v in self._times.items()}

    def __str__(self):
        return "\n".join(f"{k:12s} {v:8.3f} ms"
                         for k, v in self.report().items())


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(),
                                     "rrtmg_lw_trace"), device=None):
    """Trace the enclosed block with ``torch.profiler`` (CPU activities,
    and CUDA's on a CUDA ``device``, the card when None) and write a
    Chrome trace (``trace_<pid>_<ns>.json``, for chrome://tracing or
    Perfetto) into ``logdir`` on exit.  Yields ``logdir``.  Wrap a few
    warmed-up steps only: a first call's kernel build fills the trace."""
    device = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Device allocation snapshot (bytes) of one CUDA device (the card
    when None): ``bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``peak_bytes_in_use`` (``max_memory_allocated``), ``bytes_limit``
    (the card's total, ``mem_get_info``); None for a CPU device, as the
    JAX package's where the backend has no memory stats."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
            "bytes_limit": int(torch.cuda.mem_get_info(device)[1])}


NCOL = 16384            # columns of every cell
# the aerosol of the reduced-storage cells: K1 adds it inside the kernel
# there, after the decode (make_atmosphere's column od per band)
AOD_SPEC = 0.1


class Cell(NamedTuple):
    icld: int
    imca: int
    clouds: Optional[str]      # cloud generator (``cell_inputs``);
    #                            "profile": the McICA generator's inputs
    nlay: int
    grad: bool = False         # the gradient step
    inflag: int = 2
    idrv: int = 0
    spec: str = ""             # RRTMG_SPEC_DTYPE of its model
    aod: float = 0.0           # aerosol od of its atmosphere
    cloud_grads: tuple = ()    # grad cells: the cloud fields differentiated
    ddt: bool = False          # grad cells: the loss is ddt_loss

    def config(self, **kw):
        """The cell's LWConfig (float32, no lookup tables)."""
        from .. import LWConfig
        return LWConfig(icld=self.icld, imca=self.imca, inflag=self.inflag,
                        idrv=self.idrv, dtype="float32",
                        use_lut=False).replace(**kw)

    def make_model(self, device, spec=None, **kw):
        """The cell's model on ``device``, ``kw`` overriding its config,
        built with ``RRTMG_SPEC_DTYPE`` set to ``spec`` (default: the
        cell's)."""
        from .. import make_model
        with spec_env(self.spec if spec is None else spec):
            return make_model(self.config(**kw), device=device)


@contextlib.contextmanager
def spec_env(spec: str):
    """``RRTMG_SPEC_DTYPE`` set to ``spec`` inside the block, restored
    after."""
    old = os.environ.get("RRTMG_SPEC_DTYPE")
    os.environ["RRTMG_SPEC_DTYPE"] = spec
    try:
        yield
    finally:
        if old is None:
            del os.environ["RRTMG_SPEC_DTYPE"]
        else:
            os.environ["RRTMG_SPEC_DTYPE"] = old


CELLS = {"clear": Cell(0, 1, None, 60),
         "mcica_cloudy": Cell(2, 1, "mcica", 60),
         "band_cloudy": Cell(1, 0, "band", 60),
         "maxrand_cloudy": Cell(2, 0, "band", 60),
         "mcica_blocked": Cell(2, 1, "mcica_blocked", 60),
         "mcica_tauc": Cell(2, 1, "mcica_tauc", 60, inflag=0),
         "clear_idrv": Cell(0, 1, None, 60, idrv=1),
         "mcica_cloudy_idrv": Cell(2, 1, "mcica", 60, idrv=1),
         "maxrand_cloudy_idrv": Cell(2, 0, "band", 60, idrv=1),
         "band_cloudy_idrv": Cell(1, 0, "band", 60, idrv=1),
         "mcica_blocked_idrv": Cell(2, 1, "mcica_blocked", 60, idrv=1),
         "mcica_tauc_idrv": Cell(2, 1, "mcica_tauc", 60, inflag=0, idrv=1),
         "clear_logu16": Cell(0, 1, None, 60, spec="logu16",
                              aod=AOD_SPEC),
         "mcica_cloudy_logu16": Cell(2, 1, "mcica", 60, spec="logu16",
                                     aod=AOD_SPEC),
         "mcica_cloudy_deep": Cell(2, 1, "mcica", 140),
         # generate then radiate: K8 samples the sub-columns inside the step
         "mcica_generate": Cell(2, 1, "profile", 60),
         "mcica_generate_icld4": Cell(4, 1, "profile", 60),
         # the entry points over a prefetched stream of host batches: the
         # GCM step (McICA compact, half the columns clear, aerosol) and
         # the wire-format stream (K9 decodes, K8 samples)
         "gcm_step": Cell(2, 1, "gcm_stream", 60, aod=0.3),
         "wire_stream": Cell(2, 1, "wire_stream", 60),
         "mcica_cloudy_grad": Cell(2, 1, "mcica", 60, True),
         "clear_grad": Cell(0, 1, None, 60, True),
         "maxrand_cloudy_grad": Cell(2, 0, "band", 60, True,
                                     cloud_grads=CLOUD_GRADS),
         "band_cloudy_grad": Cell(1, 0, "band", 60, True,
                                  cloud_grads=CLOUD_GRADS + RADII_GRADS),
         "mcica_blocked_grad": Cell(2, 1, "mcica_blocked", 60, True,
                                    cloud_grads=MCICA_GRADS),
         "mcica_tauc_grad": Cell(2, 1, "mcica_tauc", 60, True, inflag=0,
                                 cloud_grads=("cldfmc", "taucmc")),
         # at idrv=1 with a loss that reads duflx_dt and duflxc_dt: K6's
         # instantiation with the d/dT adjoint in each mode
         "clear_ddt_grad": Cell(0, 1, None, 60, True, idrv=1, ddt=True),
         "mcica_cloudy_ddt_grad": Cell(2, 1, "mcica", 60, True, idrv=1,
                                       ddt=True),
         "band_cloudy_ddt_grad": Cell(1, 0, "band", 60, True, idrv=1,
                                      ddt=True,
                                      cloud_grads=CLOUD_GRADS + RADII_GRADS),
         "maxrand_cloudy_ddt_grad": Cell(2, 0, "band", 60, True, idrv=1,
                                         ddt=True, cloud_grads=CLOUD_GRADS),
         "mcica_blocked_ddt_grad": Cell(2, 1, "mcica_blocked", 60, True,
                                        idrv=1, ddt=True,
                                        cloud_grads=MCICA_GRADS),
         "mcica_tauc_ddt_grad": Cell(2, 1, "mcica_tauc", 60, True, inflag=0,
                                     idrv=1, ddt=True,
                                     cloud_grads=("cldfmc", "taucmc"))}
# the outputs ddt_loss reads
DDT_LOSS = ("uflx", "duflx_dt", "duflxc_dt")
# fragment of the demangled symbol -> kernel (csrc/*.cu); K1's third
# template argument and K2's only one are the storage (csrc/spec.cuh),
# K1's fourth whether it keeps the radiances for K6 ("save", float32):
# 1 by scalar stores, 2 by bulk tensor stores, 0 not (a checkout from
# before the two store paths: true or false)
SPEC_NAMES = ("", " bf16", " f16", " logu16")
K6_G_MODES = {2: "banded", 4: "fused", 5: "cldf_od"}
SAVE_ARGS = {"0": "", "1": " save", "2": " save", "false": "", "true": " save"}
KERNEL_SYMBOLS = tuple(
    (f"rt_kernel<{m}, {b}, {s}, {arg}>",
     f"K1 {name}{' idrv' if b == 'true' else ''}{SPEC_NAMES[s]}{save}")
    for m, name in enumerate(("clear", "compact", "banded", "maxrand",
                              "fused", "cldf_od"))
    for b in ("false", "true") for s in range(4)
    for arg, save in SAVE_ARGS.items()
    if not save or s == 0
) + tuple(
    (f"taumol_kernel<{s}>", "K2" + SPEC_NAMES[s]) for s in range(4)) + (
    ("planck_kernel", "K3"),
    ("cldcoef_kernel", "K4"), ("cldcoef_bwd_kernel", "K4b"),
    ("overlap_kernel", "overlap"),
    ("overlap_bwd_kernel", "overlap bwd"), ("rt_bwd_kernel", "K6"),
    ("rt_bwd_mr_kernel", "K6 maxrand"), ("rt_bwd_ddt_kernel", "K6 ddt"),
    # compact's d/dT, on K6-g's tile
    ("rt_bwd_g_ddt_kernel<1>", "K6 ddt"),
    ("rt_bwd_mr_ddt_kernel", "K6 maxrand ddt")) + tuple(
    (f"rt_bwd_g{d}_kernel<{m}>", f"K6 {name}{d.replace('_', ' ')}")
    for m, name in K6_G_MODES.items() for d in ("", "_ddt")) + (
    ("taumol_bwd_kernel", "K5"), ("planck_bwd_kernel", "K3b"),
    ("mcica_kernel", "K8"), ("wire_decode_kernel", "K9"),
    ("wire_unpack_kernel", "K9 unpack"))
# the stream cells' batches a timed stream, and profiled
STREAM_STEPS, STREAM_TRACED = 6, 3
# the glue ops a JSON line names (the largest by device ms), and the
# characters of an op's name kept there
GLUE_OPS, GLUE_NAME = 15, 160


def cell_inputs(cell, device, aod=None):
    """(Atmosphere, clouds or None) of ``cell``, float32 on ``device``:
    the atmosphere from seed 0 with the aerosol od ``aod`` (default the
    cell's), McICA clouds from seed 2 (compact with
    an int8 mask; "mcica_blocked" the per-g arrays; "mcica_tauc" these
    with an input cloud od taucmc = cldfmc x (0.05 ciwpmc + 0.1
    clwpmc)), band clouds from seed 1."""
    from ..types import (Atmosphere, BandClouds, McicaCloudsBlocked,
                         McicaCloudsCompact)
    from .synthetic import (make_atmosphere, make_band_clouds,
                            make_mcica_clouds)
    c = CELLS[cell]
    atm = Atmosphere.from_numpy(
        make_atmosphere(NCOL, c.nlay, seed=0,
                        aod=c.aod if aod is None else aod),
        device, torch.float32)
    if c.clouds == "mcica":
        return atm, McicaCloudsCompact.from_numpy(
            make_mcica_clouds(NCOL, c.nlay, seed=2, mask_dtype=np.int8),
            device, torch.float32)
    if c.clouds in ("mcica_blocked", "mcica_tauc"):
        cl = McicaCloudsBlocked.from_numpy(
            make_mcica_clouds(NCOL, c.nlay, seed=2, dtype=np.float32,
                              layout="blocked"), device, torch.float32)
        if c.clouds == "mcica_tauc":
            cl = cl._replace(taucmc=cl.cldfmc * (0.05 * cl.ciwpmc
                                                 + 0.1 * cl.clwpmc))
        return atm, cl
    if c.clouds == "band":
        return atm, BandClouds.from_numpy(
            make_band_clouds(NCOL, c.nlay, seed=1), device, torch.float32)
    if c.clouds == "profile":
        return atm, cloud_profile(atm, c.icld, device)
    return atm, None


def cloud_profile(atm, icld, device, seed=0):
    """The McICA generator's (B, L) inputs for ``atm``'s columns
    (``make_cloud_profile_fields`` from ``seed``, float32 on ``device``),
    with, for icld 4/5, ``alpha`` from ``mcica.get_alpha`` of the layers'
    hypsometric thickness (R_d / g = 29.27 m/K)."""
    from ..ops import mcica
    from .synthetic import make_cloud_profile_fields
    B, L = atm.tlay.shape
    fields = {k: torch.as_tensor(v, device=device) for k, v in
              make_cloud_profile_fields(B, L, seed=seed).items()}
    dz = 29.27 * atm.tlay * torch.log(atm.plev[:, :-1] / atm.plev[:, 1:])
    fields["alpha"] = (mcica.get_alpha(dz, icld, cldfrac=fields["cldfrac"])
                       if icld in (4, 5) else None)
    return fields


def generate_step(model, seed=0):
    """The generate-then-radiate step of ``model`` (McICA, compact int8
    mask): ``step(atm, fields)`` samples the sub-columns of the
    ``cloud_profile`` ``fields`` with the key of ``seed`` folded with the
    call's count (``mcica.mcica_subcol_lw_compact``: K8 on the card), then
    runs the model on them."""
    from ..ops import mcica
    calls = itertools.count()

    def step(atm, fields):
        k = mcica.fold_in(mcica.key(seed), next(calls))
        return model(atm, mcica.mcica_subcol_lw_compact(
            k, model.config.icld, **fields, mask_dtype=torch.int8))
    return step


def _union_ms(intervals):
    """Total length of the union of (start, end) intervals, in ms."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def ddt_loss(ncol, nlay, device, seed=7):
    """A loss linear in ``DDT_LOSS``, uflx and the d/dT outputs duflx_dt,
    duflxc_dt (idrv=1), with seeded weights (ncol, nlay + 1) each: the
    ``*_ddt_grad`` cells' (a sensitivity of the fluxes to the surface
    temperature, or a learned-physics term on it)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = [torch.randn(ncol, nlay + 1, generator=gen, device=device)
         for _ in DDT_LOSS]
    return lambda f: sum((c * getattr(f, n)).sum() for c, n in zip(w,
                                                                   DDT_LOSS))


def _device_work(prof, traced):
    """(busy ms, {kernel: ms}, the CUDA events, {glue op: ms}) a step of a
    trace of ``traced`` steps: busy the union of the CUDA kernel, memcpy
    and memset intervals; the hand-written kernels by ``KERNEL_SYMBOLS``;
    every other CUDA op grouped by name (``glue_ops``)."""
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in dev_events]) / traced
    kernels = dict.fromkeys((k for _, k in KERNEL_SYMBOLS), 0.0)
    glue = collections.Counter()
    for e in dev_events:
        k = next((k for sym, k in KERNEL_SYMBOLS if sym in e.name), None)
        ms = e.time_range.elapsed_us() / 1e3 / traced
        if k is not None:
            kernels[k] += ms
        else:
            glue[e.name] += ms
    return (busy, {k: v for k, v in kernels.items() if v}, dev_events,
            dict(glue))


def glue_ops(glue):
    """The ``GLUE_OPS`` largest ops of ``_device_work``'s glue, {name:
    ms}, largest first, each name without its leading ``void `` and cut to
    ``GLUE_NAME`` characters (ops whose cut names meet are summed)."""
    out = collections.Counter()
    for name, ms in sorted(glue.items(), key=lambda kv: -kv[1])[:GLUE_OPS]:
        out[name.removeprefix("void ")[:GLUE_NAME]] += ms
    return dict(out.most_common())


def stream_parts(cell, mesh):
    """(step, batches(n): a fresh stream of n host batches) of a stream
    cell, on ``mesh``: the examples' own."""
    from .. import make_model
    from ..examples import gcm_step, wire_streaming
    if cell == "gcm_step":
        _, step = gcm_step.build(mesh)
        return step, lambda n: gcm_step.host_batches(NCOL, CELLS[cell].nlay,
                                                     n)
    model = make_model(wire_streaming.CONFIG, device=mesh.device)
    L = CELLS[cell].nlay
    return (wire_streaming.make_step(model, mesh, NCOL, L),
            lambda n: wire_streaming.host_batches(NCOL, L, n))


def batch_bytes(batch) -> int:
    """Host bytes of a batch (a WireBatch's: ``wire.wire_bytes``)."""
    from ..parallel import wire
    if isinstance(batch, (wire.WireBatch, wire.CompactCloudsWire)):
        return wire.wire_bytes(batch)
    if isinstance(batch, (tuple, list)):
        return sum(batch_bytes(b) for b in batch)
    return 0 if batch is None else int(np.asarray(batch).nbytes)


def profile_stream(cell, device, steps=STREAM_STEPS, traced=STREAM_TRACED):
    """A stream cell: the wall of ``steps`` host batches through the
    entry point's step over ``prefetch`` at depth 2 (host clock to
    ``synchronize`` at the stream's end, a step's share), the same stream
    at depth 0 (inline copies on the compute stream: the prefetch
    overlap), the host ms to make one batch, then ``torch.profiler`` over
    ``traced`` batches at depth 2: busy, idle share, kernels, launches and
    copies a step, peak memory, host bytes a column."""
    from ..parallel import make_mesh, prefetch
    mesh = make_mesh(device=device)
    step, batches = stream_parts(cell, mesh)

    def stream(n, depth):
        t0 = time.perf_counter()
        for b in prefetch(batches(n), mesh, depth=depth):
            step(*b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n
    stream(2, 2)                                         # warm-up
    t0 = time.perf_counter()
    first = next(batches(1))
    gen_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    wall = stream(steps, 2)
    wall0 = stream(steps, 0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        traced_wall = stream(traced, 2)
    busy, kernels, dev_events, glue = _device_work(prof, traced)
    copies = sum(1 for e in dev_events if "Memcpy" in e.name)
    return dict(cell=cell, ncol=NCOL, nlay=CELLS[cell].nlay,
                device=torch.cuda.get_device_name(0), steps=steps,
                wall_ms=wall, wall_ms_depth0=wall0,
                prefetch_gain=1.0 - wall / wall0, traced_wall_ms=traced_wall,
                cols_per_sec=NCOL / (wall * 1e-3), host_batch_ms=gen_ms,
                busy_ms=busy, idle_share=1.0 - busy / traced_wall,
                kernel_ms=kernels, glue_ms=busy - sum(kernels.values()),
                glue_ops=glue_ops(glue),
                launches_per_step=len(dev_events) / traced,
                copies_per_step=copies / traced,
                bytes_per_col=batch_bytes(first) / NCOL,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def profile_cell(cell, device, steps=20, traced=5):
    from ..parallel import make_grad_step
    c = CELLS[cell]
    if c.clouds in ("gcm_stream", "wire_stream"):
        return profile_stream(cell, device)
    model = c.make_model(device)
    step = generate_step(model) if c.clouds == "profile" else model
    if c.grad:
        step = make_grad_step(model, ddt_loss(NCOL, c.nlay, device)
                              if c.ddt else None, c.cloud_grads)
    atm, clouds = cell_inputs(cell, device)
    for _ in range(2):                                   # warm-up
        step(atm, clouds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(atm, clouds)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(walls, n=4)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(traced):
            step(atm, clouds)
        torch.cuda.synchronize()
    busy, kernels, dev_events, glue = _device_work(prof, traced)
    return dict(cell=cell, ncol=NCOL, nlay=c.nlay, device=torch.cuda.
                get_device_name(0), wall_ms_median=med, wall_ms_q1=q1,
                wall_ms_q3=q3, cols_per_sec=NCOL / (med * 1e-3),
                busy_ms=busy, idle_share=1.0 - busy / med,
                kernel_ms=kernels, glue_ms=busy - sum(kernels.values()),
                glue_ops=glue_ops(glue),
                launches_per_step=len(dev_events) / traced,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--cells", nargs="+", choices=tuple(CELLS),
                    default=tuple(CELLS), help="profile only these cells")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    device = torch.device("cuda", 0)
    lines = []
    for cell in args.cells:
        lines.append(json.dumps(profile_cell(cell, device)))
        print(lines[-1], flush=True)
        torch.cuda.empty_cache()
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
