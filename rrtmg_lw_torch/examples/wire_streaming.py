"""Production streaming with the compressed wire format.

Port of ``examples/wire_streaming.py:41-119``.  In a streaming deployment
the host link, not the card, bounds the sustained columns/s, so the host
ships compact codes:

  host thread:  generate (or load) this rank's columns of the (B, L)
                profile and cloud fields
                -> wire-encode (uint16 codes + per-batch reference
                   profiles; the C++ encoder where it builds)
                -> prefetch (double-buffered, pinned, a copy stream)
  device step:  decode (K9, one launch a WireBatch, sanitized: the ok
                flags land in ``Fluxes.wire_ok``) -> McICA sub-column
                masks (K8, int8) -> the model (K2, K3, K4, K1 compact)

    python -m rrtmg_lw_torch.examples.wire_streaming [--ncol 16384]
        [--steps 16]
    torchrun --nproc_per_node=N -m rrtmg_lw_torch.examples.wire_streaming
    python -m rrtmg_lw_torch.examples.wire_streaming --ncol 64 --nlay 20 \\
        --steps 3 --device cpu
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

from .. import LWConfig, make_model
from .. import parallel as par
from ..ops import mcica
from ..parallel import wire as w
from ..utils.synthetic import make_atmosphere, make_cloud_profile_fields
from ._dist import all_finite, process_group

CONFIG = LWConfig(icld=2, imca=1, dtype="float32", use_lut=False)
SEED = 7


def host_batches(ncol, nlay, steps, rank=None):
    """The host side: generate ``ncol`` columns (a rank's own shard:
    seeds (i, ``rank``)), then wire-encode; it runs on the prefetch worker
    thread, overlapped with the device.  ``schema="coded"`` pins the
    WireBatch's structure: with auto-detection a channel could flip
    between zero, uniform and coded from batch to batch.  Each rank
    encodes its columns against its own per-batch references: the decode
    is the rank's own, so they need not agree across ranks."""
    for i in range(steps):
        seed = i if rank is None else [i, rank]
        atm = make_atmosphere(ncol, nlay, seed=seed, dtype=np.float32)
        yield (w.encode_atmosphere(atm, schema="coded"),
               w.encode_cloud_profiles(make_cloud_profile_fields(ncol, nlay,
                                                                 seed),
                                       schema="coded"))


def make_step(model, mesh, ncol, nlay, sample=None):
    """``step(ea, ec) -> Fluxes`` on this rank's shard of the encoded
    atmosphere and cloud profiles: the sanitized decode (K9), its ok flags in ``Fluxes.wire_ok``; the sub-columns
    (``sample(i, profiles)``, default K8 with the key of ``SEED`` folded
    with the call's count and, on a mesh of several ranks, the rank: each
    rank draws its own columns); the model.  The device-resident aerosol
    state is zero, as in the JAX example."""
    dtype = model.config.torch_dtype
    taua0 = par.shard_batch(np.zeros((ncol, nlay, 16), np.float32), mesh)
    calls = itertools.count()

    def k8(i, cp):
        k = mcica.fold_in(mcica.key(SEED), i)
        if mesh.world > 1:
            k = mcica.fold_in(k, mesh.rank)
        return mcica.mcica_subcol_lw_compact(
            k, 2, cp["cldfrac"], cp["ciwp"], cp["clwp"], cp["rei"],
            cp["rel"], mask_dtype=torch.int8)
    sample = k8 if sample is None else sample

    def step(ea, ec):
        i = next(calls)
        atm, ok_a = w.decode_atmosphere(ea, taua0, dtype, sanitize=True)
        cp, ok_c = w.decode_cloud_profiles(ec, dtype, like=atm.play,
                                           sanitize=True)
        return model(atm, sample(i, cp))._replace(wire_ok=ok_a & ok_c)
    return step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=16384)
    ap.add_argument("--nlay", type=int, default=60)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; default this rank's GPU")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2 (the first step is the warm-up, "
                 "outside the clock)")
    B, L = args.ncol, args.nlay
    with process_group(args.device):
        mesh = par.make_mesh(device=args.device)
        model = make_model(CONFIG, device=mesh.device)
        step = make_step(model, mesh, B, L)
        # this rank's own columns, placed whole after one check of the
        # ranks' shards; the warm-up lands outside the clock
        rows = mesh.rows(B)
        batches = host_batches(rows.stop - rows.start, L, args.steps,
                               mesh.rank if mesh.world > 1 else None)
        first, _ = par.global_batch_from_host_shards(mesh, next(batches))
        out = step(*first)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        for batch in par.prefetch(batches, mesh, depth=args.depth,
                                  local=True):
            out = step(*batch)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        done = (args.steps - 1) * B
        olr = par.make_metrics_fn(mesh)(out)["olr_mean"]
        finite = all_finite(out.uflx, mesh)
        if mesh.rank == 0:
            print(f"{done} columns in {wall:.2f}s ({done / wall:,.0f} cols/s "
                  f"sustained, {done / wall / mesh.world:,.0f}/GPU); OLR mean "
                  f"{float(olr):.2f} W/m2; all finite: {finite}; wire ok: "
                  f"{bool(out.wire_ok.all())}")
        if not finite:
            raise SystemExit("non-finite fluxes")
    return dict(columns=done, seconds=wall, finite=finite)


if __name__ == "__main__":
    main()
