"""The sharded steps on several ranks against the one-device step.

    torchrun --standalone --nproc_per_node=2 \\
        -m rrtmg_lw_torch.utils.dist_check
    torchrun --standalone --nproc_per_node=2 \\
        -m rrtmg_lw_torch.utils.dist_check --device cpu --ncol 64 \\
        --ncol-grad 32 --nlay 12

Each rank makes the same global batch (``examples.gcm_step.host_batches``:
McICA compact clouds with an int8 mask on half the columns, aerosol od
0.3), places its own columns (``parallel.shard_batch``) and runs
``make_sharded_step`` on them (on the card in float32: K2, K3, K4, K1
compact; on the CPU in float64); it also runs the one-device step on the
whole batch, placed the same way, on its own device.
Its shard of the fluxes, and the fluxes gathered from every rank
(``gather_fluxes``), must be bitwise the one-device step's.  Then
``make_sharded_grad_step`` (the default loss of the gathered fluxes)
against ``make_grad_step`` on the whole batch, under deterministic
algorithms: the loss and this rank's gradient rows within ``TOL_GRAD``
of the one-device step's (of max |grad| per Atmosphere field).  Rank 0
prints one JSON line with each check's worst value over the ranks; any
failure raises.  NCCL on the card, gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

TOL_GRAD = 1e-6         # sharded vs one-device grad, of max |grad| per field
FLUX_NAMES = ("uflx", "dflx", "hr", "uflxc", "dflxc", "hrc")


def worst(x: float, mesh) -> float:
    """The largest ``x`` over the ranks."""
    t = torch.tensor([float(x)], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t)


def run(mesh, ncol, ncol_grad, nlay) -> dict:
    """The checks on ``mesh`` (see the module docstring) -> their worst
    values over the ranks; raises on a failure."""
    from .. import make_model
    from .. import parallel as par
    from ..examples import gcm_step
    from ..parallel.api import gather_fluxes
    from ..parallel.mesh import map_batch

    dev = mesh.device
    # float64 on the CPU: its vectorized float32 math rounds an element by
    # where it falls in the tensor, so float32 shards differ in the last
    # bits there
    cpu = dev.type == "cpu"
    model = make_model(gcm_step.CONFIG.replace(
        dtype="float64" if cpu else "float32"), device=dev)
    one = par.Mesh(None, 0, 1, dev)         # the whole batch on this device

    def host(ncol):
        batch = next(gcm_step.host_batches(ncol, nlay, 1))
        if not cpu:
            return batch
        return map_batch(batch, None, lambda x, _, axis: (
            x.astype(np.float64) if x.dtype == np.float32 else x))

    def whole(batch):
        return par.shard_batch(batch, one)

    batch = host(ncol)
    rows = mesh.rows(ncol)
    fl = par.make_sharded_step(model, mesh)(*par.shard_batch(batch, mesh))
    ref = model(*whole(batch))
    gathered = gather_fluxes(fl, mesh)
    shard_equal = all(torch.equal(getattr(fl, n), getattr(ref, n)[rows])
                      for n in FLUX_NAMES)
    gather_equal = all(torch.equal(getattr(gathered, n), getattr(ref, n))
                       for n in FLUX_NAMES)
    finite = bool(torch.isfinite(fl.uflx).all())
    if worst(0.0 if shard_equal and gather_equal and finite else 1.0,
             mesh):
        raise RuntimeError(
            f"rank {mesh.rank}: make_sharded_step's fluxes at B={ncol} not "
            f"bitwise the one-device step's (shard {shard_equal}, gathered "
            f"{gather_equal}, finite {finite})")
    del fl, ref, gathered

    batch = host(ncol_grad)
    rows = mesh.rows(ncol_grad)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ls, gs = par.make_sharded_grad_step(model, mesh)(
            *par.shard_batch(batch, mesh))
        l1, g1 = par.make_grad_step(model)(*whole(batch))
    finally:
        torch.use_deterministic_algorithms(False)
    gerr = max(float((a - b[rows]).abs().max()
                     / b.abs().max().clamp(min=1e-30))
               for a, b in zip(gs, g1))
    lerr = float((ls - l1).abs() / l1.abs())
    res = dict(world=mesh.world, device=str(dev), ncol=ncol,
               ncol_grad=ncol_grad, nlay=nlay, fluxes_bitwise=True,
               grad_rel_err=worst(gerr, mesh), loss_rel_err=worst(lerr, mesh))
    if res["grad_rel_err"] > TOL_GRAD or res["loss_rel_err"] > TOL_GRAD:
        raise RuntimeError(f"make_sharded_grad_step against make_grad_step "
                           f"at B={ncol_grad}: {res}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=16384,
                    help="global columns of the forward check")
    ap.add_argument("--ncol-grad", type=int, default=4096,
                    help="global columns of the gradient check")
    ap.add_argument("--nlay", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo on the CPU; default this rank's GPU")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit("run under torchrun (--nproc_per_node=N)")
    from .. import parallel as par
    from ..examples._dist import process_group
    if args.device is None and int(os.environ.get("LOCAL_RANK", 0)) == 0:
        from .. import _build
        _build.build()          # once, before the other ranks load it
    with process_group(args.device):
        dist.barrier()
        mesh = par.make_mesh(device=args.device)
        res = run(mesh, args.ncol, args.ncol_grad, args.nlay)
        if mesh.rank == 0:
            print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
