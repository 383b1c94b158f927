"""One rank of tests/test_torch_distributed.py's two-process run (a
script, not a test): a gloo process group over TCP on localhost, the
port's column mesh on the CPU, and for each global batch of the inputs
file (float64 atmosphere and compact McICA clouds, every rank the same
arrays) this rank's shard through ``make_sharded_step``, the mesh-global
metrics and ``make_sharded_grad_step``; it saves its rows, fluxes,
metrics, loss and gradients for the parent to check.  Imports no JAX.

Usage: python torch_dist_worker.py <rank> <world> <port> <dir>
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], pathlib.Path(sys.argv[4]))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        from rrtmg_lw_torch import (Atmosphere, LWConfig, McicaCloudsCompact,
                                    make_model)
        from rrtmg_lw_torch import parallel as par
        mesh = par.make_mesh(device="cpu")
        assert (mesh.rank, mesh.world) == (rank, world)
        saved = {"spec_raises": np.array(0)}
        try:
            par.make_mesh(spec=2, device="cpu")
        except NotImplementedError:
            saved["spec_raises"] = np.array(1)
        model = make_model(LWConfig(icld=2, imca=1, use_lut=False),
                           device="cpu")
        for path in sorted(out.glob("inputs_*.npz")):
            z = np.load(path)
            atm = Atmosphere(*(z[f"atm_{k}"] for k in Atmosphere._fields))
            cl = McicaCloudsCompact(*(z[f"cl_{k}"]
                                      for k in McicaCloudsCompact._fields))
            tag = path.stem.split("_")[1]
            a, c = par.shard_batch((atm, cl), mesh)
            rows = mesh.rows(atm.tsfc.shape[0])
            local = (atm._replace(**{k: v[rows] for k, v in
                                     atm._asdict().items()}),
                     cl._replace(cldfmc=cl.cldfmc[..., rows],
                                 **{k: getattr(cl, k)[rows]
                                    for k in cl._fields[1:]}))
            (a2, c2), got = par.global_batch_from_host_shards(mesh, local)
            assert got == rows, (got, rows)
            assert all(torch.equal(x, y) for x, y in zip((*a, *c),
                                                         (*a2, *c2)))
            fl = par.make_sharded_step(model, mesh)(a, c)
            stats = par.make_metrics_fn(mesh)(fl)
            loss, grads = par.make_sharded_grad_step(model, mesh)(a, c)
            saved[f"{tag}_rows"] = np.array([rows.start, rows.stop])
            for k in ("uflx", "dflx", "uflxc", "dflxc", "hr"):
                saved[f"{tag}_{k}"] = getattr(fl, k).numpy()
            for k, v in stats.items():
                saved[f"{tag}_metric_{k}"] = v.numpy()
            saved[f"{tag}_loss"] = loss.numpy()
            for k, g in zip(Atmosphere._fields, grads):
                saved[f"{tag}_grad_{k}"] = g.numpy()
        np.savez(out / f"rank{rank}.npz", **saved)
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()
