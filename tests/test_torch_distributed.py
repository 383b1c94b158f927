"""The port's column mesh across a process boundary: two processes
(``tests/torch_dist_worker.py``) form a two-rank gloo group over TCP on
localhost (a free port), after tests/test_parallel.py:158-225, and run
two float64 global batches, B=16 and B=15 (shards of 8 + 8 and 7 + 8
columns), L=26, McICA compact clouds, the trace gases off the reference
ratios (tests/test_torch_grad.py's ``noisy_atmosphere``).  Held against
the JAX package in this process:

* each rank's shard of the fluxes equals the JAX single-process model's
  rows within 1e-12 (relative);
* the metrics are bitwise equal on both ranks and within 1e-12 of JAX's
  ``make_metrics_fn`` on the global batch (means of unequal shards
  included);
* ``make_sharded_grad_step``'s gradients, the ranks' shards joined,
  equal ``jax.value_and_grad`` of the default loss on the global batch
  within 1e-10 of max |grad| per field, and the loss is the same on both
  ranks: no factor of the world size.

* ``make_mesh(spec=2)`` raises NotImplementedError on the two-rank
  group too (the spectral partition is not ported).

The two entry points (``rrtmg_lw_torch.examples.gcm_step``,
``wire_streaming``) also run as two gloo ranks on the CPU (the
environment ``torchrun`` sets, B=15, L=8, 3 steps): each rank makes its
own columns, and the printed mesh-global OLR mean equals that of the
model run in this process on the ranks' own last batches, joined.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu import parallel as jpar
from rrtmg_lw_tpu.utils import synthetic as jsyn

L = 26
SIZES = (16, 15)
GASES = ("h2ovmr", "co2vmr", "o3vmr", "n2ovmr", "covmr", "ch4vmr", "o2vmr")
FLUXES = ("uflx", "dflx", "uflxc", "dflxc")
REPO = pathlib.Path(__file__).resolve().parents[1]


def _inputs(B):
    atm = jsyn.make_atmosphere(B, L)
    rng = np.random.default_rng(7)
    atm = atm._replace(**{k: getattr(atm, k) * (
        1.0 + 0.05 * rng.standard_normal((B, L))) for k in GASES})
    return atm, jsyn.make_mcica_clouds(B, L, layout="compact")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two workers' saved results, {rank: npz}."""
    d = tmp_path_factory.mktemp("dist")
    for B in SIZES:
        atm, cl = _inputs(B)
        np.savez(d / f"inputs_{B}.npz",
                 **{f"atm_{k}": np.asarray(v) for k, v in atm._asdict().items()},
                 **{f"cl_{k}": np.asarray(v) for k, v in cl._asdict().items()})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dist_worker.py"),
         str(r), "2", port, str(d)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, cwd=str(REPO), env=env) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"
    return {r: np.load(d / f"rank{r}.npz") for r in range(2)}


@pytest.fixture(scope="module")
def jax_ref():
    """{B: (fluxes, metrics, loss, grads)} of the JAX model on the
    global batch, float64."""
    model = jmake_model(JConfig(icld=2, imca=1, use_lut=False,
                                taumol_impl="xla", rt_impl="xla"))
    jmesh = jpar.make_mesh(jax.devices()[:1])

    def loss_fn(fl):
        return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()
    out = {}
    for B in SIZES:
        atm, cl = _inputs(B)
        atm = jax.tree_util.tree_map(jnp.asarray, atm)

        def obj(a):
            fl = model(a, cl)
            return loss_fn(fl), fl
        (loss, fl), g = jax.jit(jax.value_and_grad(obj, has_aux=True))(atm)
        out[B] = (fl, jpar.make_metrics_fn(jmesh)(fl), loss, g)
    return out


@pytest.mark.parametrize("B", SIZES)
def test_shards_equal_jax_rows(ranks, jax_ref, B):
    fl = jax_ref[B][0]
    covered = np.zeros(B, bool)
    for r, z in ranks.items():
        lo, hi = z[f"{B}_rows"]
        assert (lo, hi) == (r * B // 2, (r + 1) * B // 2)
        for k in FLUXES:
            np.testing.assert_allclose(z[f"{B}_{k}"], np.asarray(
                getattr(fl, k))[lo:hi], rtol=1e-12, atol=0,
                err_msg=f"rank {r} {k}")
        covered[lo:hi] = True
    assert covered.all()


@pytest.mark.parametrize("B", SIZES)
def test_metrics_agree_across_ranks_and_with_jax(ranks, jax_ref, B):
    ref = jax_ref[B][1]
    keys = [k for k in ranks[0].files if k.startswith(f"{B}_metric_")]
    assert len(keys) == len(ref)
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        name = k[len(f"{B}_metric_"):]
        np.testing.assert_allclose(ranks[0][k], np.asarray(ref[name]),
                                   rtol=1e-12, atol=0, err_msg=name)
    assert float(ranks[0][f"{B}_metric_ncol"]) == B


@pytest.mark.parametrize("B", SIZES)
def test_sharded_grads_equal_jax(ranks, jax_ref, B):
    _, _, loss, g = jax_ref[B]
    for r in ranks:
        np.testing.assert_allclose(ranks[r][f"{B}_loss"], float(loss),
                                   rtol=1e-12, atol=0)
    for k in g._fields:
        ref = np.asarray(getattr(g, k))
        got = np.concatenate([ranks[r][f"{B}_grad_{k}"] for r in (0, 1)])
        scale = max(np.abs(ref).max(), 1e-300)
        assert np.abs(got - ref).max() <= 1e-10 * scale, (
            k, np.abs(got - ref).max() / scale)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _run_ranks(argv, world=2):
    """``argv`` in ``world`` processes under the environment torchrun
    sets -> rank 0's output."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, *argv], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, cwd=str(REPO),
        env=dict(os.environ, OMP_NUM_THREADS="1", RANK=str(r),
                 LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o[-3000:]}"
    return outs[0]


@pytest.mark.parametrize("name", ["gcm_step", "wire_streaming"])
def test_entry_points_on_two_ranks(name):
    import importlib
    import re
    import torch
    from rrtmg_lw_torch import make_model
    from rrtmg_lw_torch import parallel as par
    torch.set_num_threads(1)
    B, nlay, steps = 15, 8, 3
    ex = importlib.import_module(f"rrtmg_lw_torch.examples.{name}")
    out = _run_ranks(["-m", f"rrtmg_lw_torch.examples.{name}", "--device",
                      "cpu", "--ncol", str(B), "--nlay", str(nlay),
                      "--steps", str(steps)])
    assert "all finite: True" in out, out
    model = make_model(ex.CONFIG, device="cpu")
    olr = []
    for r in range(2):
        mesh = par.Mesh(None, r, 2, torch.device("cpu"))
        rows = mesh.rows(B)
        batches = list(ex.host_batches(rows.stop - rows.start, nlay, steps,
                                       rank=r))
        if name == "gcm_step":
            fl = model(*par.shard_batch(batches[-1], mesh._replace(
                rank=0, world=1)))
        else:
            step = ex.make_step(model, mesh, B, nlay)
            for b in batches:          # K8's key folds in the step's count
                fl = step(*par.shard_batch(b, mesh._replace(rank=0,
                                                            world=1)))
            assert bool(fl.wire_ok.all())
        olr.append(fl.uflx[:, -1])
    want = float(torch.cat(olr).double().mean())
    if name == "gcm_step":
        assert "mesh: 2 x cpu" in out and f"{B * steps} columns" in out, out
        got = float(re.search(r"TOA uflx mean: (\S+)", out).group(1))
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    else:
        assert f"{B * (steps - 1)} columns" in out, out
        got = float(re.search(r"OLR mean (\S+) W", out).group(1))
        assert abs(got - want) <= 0.005 + 1e-6 * abs(want), (got, want)


def test_spectral_mesh_raises_on_the_group(ranks):
    assert all(int(z["spec_raises"]) == 1 for z in ranks.values())
