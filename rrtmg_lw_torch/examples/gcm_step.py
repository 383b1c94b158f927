"""The GCM-mode step: large mixed clear/cloudy column batches with aerosols,
sharded over every GPU of the process group, with double-buffered
host->device streaming.

Port of ``examples/gcm_step.py:31-95``: the production shape of the
reference's GCM entry point (rrtmg_lw_rad.f90:99 ``rrtmg_lw``, called per
column block from a host model).  Each rank makes its own column shard of
every global batch, as a GCM's rank owns its own columns (placed by
``global_batch_from_host_shards``, which checks the ranks' shards, then
streamed whole), and radiates it (``make_sharded_step``); the input
pipeline keeps ``--depth`` batches in flight (``run_epoch`` over
``prefetch``) so the cards do not wait on the host link.  Half the columns are clear (a zero
McICA mask), the clouds compact with an int8 mask (the port's main
path: K2, K3, K4 and K1 compact), the aerosol on the per-band taua.

    python -m rrtmg_lw_torch.examples.gcm_step [--ncol 16384] [--steps 10]
    torchrun --nproc_per_node=N -m rrtmg_lw_torch.examples.gcm_step
    python -m rrtmg_lw_torch.examples.gcm_step --ncol 64 --nlay 20 \\
        --steps 3 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import LWConfig, make_model
from .. import parallel as par
from ..utils.synthetic import make_atmosphere, make_mcica_clouds
from ._dist import all_finite, process_group

CONFIG = LWConfig(icld=2, imca=1, iaer=10, dtype="float32", use_lut=False)


def host_batches(ncol, nlay, steps, cloud_frac=0.5, rank=None):
    """Host batches (Atmosphere, McicaCloudsCompact) of ``ncol`` columns,
    of seeds 0 .. steps - 1 (a rank's own shards: seeds (i, ``rank``)):
    aerosol od 0.3, ``cloud_frac`` of the columns with McICA clouds, an
    int8 mask."""
    for i in range(steps):
        seed = i if rank is None else [i, rank]
        atm = make_atmosphere(ncol, nlay, seed=seed, dtype=np.float32,
                              aod=0.3)
        clouds = make_mcica_clouds(ncol, nlay, seed=seed, dtype=np.float32,
                                   mask_dtype=np.int8,
                                   clear_frac=1.0 - cloud_frac)
        yield atm, clouds


def synchronize(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def build(mesh, config=CONFIG):
    """(model, the sharded step) on ``mesh``."""
    model = make_model(config, device=mesh.device)
    return model, par.make_sharded_step(model, mesh)


def run(mesh, step, ncol, nlay, steps, depth=2, cloud_frac=0.5):
    """The stream of ``steps`` batches of ``ncol`` global columns through
    ``step`` after one warm-up step outside the clock, each rank making
    its own columns (``mesh.rows(ncol)``; on one rank the global batches
    themselves) -> (the last Fluxes, host seconds to the stream's end)."""
    rows = mesh.rows(ncol)
    n, rank = rows.stop - rows.start, mesh.rank if mesh.world > 1 else None
    first = next(host_batches(n, nlay, 1, cloud_frac, rank))
    (atm0, cl0), _ = par.global_batch_from_host_shards(mesh, first)
    step(atm0, cl0)
    synchronize(mesh)
    t0 = time.perf_counter()
    out = par.run_epoch(step, host_batches(n, nlay, steps, cloud_frac, rank),
                        mesh, depth=depth, local=True)
    synchronize(mesh)
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=16384,
                    help="columns per step (global, across the ranks)")
    ap.add_argument("--nlay", type=int, default=60)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--depth", type=int, default=2,
                    help="prefetch depth (batches in flight)")
    ap.add_argument("--cloud-frac", type=float, default=0.5,
                    help="fraction of columns with McICA clouds")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; default this rank's GPU")
    args = ap.parse_args(argv)
    with process_group(args.device):
        mesh = par.make_mesh(device=args.device)
        _, step = build(mesh)
        out, dt = run(mesh, step, args.ncol, args.nlay, args.steps,
                      args.depth, args.cloud_frac)
        stats = par.make_metrics_fn(mesh)(out)
        finite = all_finite(out.uflx, mesh)
        total = args.steps * args.ncol
        if mesh.rank == 0:
            print(f"mesh: {mesh.world} x {mesh.device.type}")
            print(f"{total} columns in {dt:.3f}s -> {total / dt:,.0f} cols/s "
                  f"({total / dt / mesh.world:,.0f}/GPU)")
            print("TOA uflx mean:", float(stats["olr_mean"]),
                  "W/m2; all finite:", finite)
    return dict(columns=total, seconds=dt, finite=finite)


if __name__ == "__main__":
    main()
