"""The port's parallel layer (``rrtmg_lw_torch.parallel``) on one rank, on
the CPU, against the JAX package's where it has a counterpart.

* ``shard_batch`` cuts each leaf in its layout (batch-first on axis 0,
  the compact and blocked per-g arrays and the packed mask bits on their
  last axis, a WireBatch's codes on axis 0 and its refs whole), for a
  rank of a three-rank mesh; ``global_batch_from_host_shards`` keeps a
  one-rank shard whole and refuses mixed column counts.
* ``make_sharded_step`` equals the model bitwise; ``make_sharded_grad_step``
  equals ``make_grad_step`` without a process group.
* ``make_metrics_fn`` against JAX's ``make_metrics_fn`` on the same
  float64 fluxes, within 1e-12.
* ``prefetch``: FIFO order, a source's exception at the consumer, an
  early exit that leaves no worker behind (each under a timeout of its
  own); ``run_epoch`` with NamedTuple batches.
* The streamed wire step (``examples.wire_streaming.make_step``) at B=16,
  L=21 in float64 against JAX's decode then model on the same codes, the
  sub-column mask fixed (JAX's uniforms given to the port's generator,
  as tests/test_torch_mcica.py), within 1e-10 W/m2.
* ``make_mesh(spec=2)`` raises NotImplementedError.
"""

import concurrent.futures
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu import parallel as jpar
from rrtmg_lw_tpu.ops import mcica as jm
from rrtmg_lw_tpu.parallel import wire as jw
from rrtmg_lw_tpu.types import Fluxes as JFluxes
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import Atmosphere, LWConfig, make_model
from rrtmg_lw_torch import parallel as par
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.examples import wire_streaming
from rrtmg_lw_torch.ops import mcica as tm
from rrtmg_lw_torch.parallel import wire as tw
from rrtmg_lw_torch.types import Fluxes, McicaCloudsCompact
from rrtmg_lw_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CPU = torch.device("cpu")
TIMEOUT = 60.0


def _within(fn, seconds=TIMEOUT):
    """``fn()`` on a thread, failing if it takes longer than
    ``seconds``."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        return ex.submit(fn).result(timeout=seconds)


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh(device="cpu")


@pytest.fixture(scope="module")
def model():
    return make_model(LWConfig(icld=2, imca=1, use_lut=False), device="cpu")


def test_mesh_shape_and_spec(mesh):
    assert mesh.shape == {par.COLUMNS: 1, par.SPEC: 1}
    assert (mesh.rank, mesh.world, mesh.device, mesh.group) == (0, 1, CPU,
                                                                None)
    with pytest.raises(NotImplementedError, match="spectral partition"):
        par.make_mesh(spec=2, device="cpu")


def test_make_mesh_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        par.make_mesh()


def test_shard_batch_layouts():
    third = par.Mesh(None, 1, 3, CPU)          # rank 1 of 3: columns 5:10
    B, L, rows = 16, 4, slice(5, 10)
    atm = tsyn.make_atmosphere(B, L)
    got = par.shard_batch(atm, third)
    for name, x in atm._asdict().items():
        assert torch.equal(getattr(got, name), torch.from_numpy(x[rows]))
    for layout in ("compact", "blocked"):
        cl = tsyn.make_mcica_clouds(B, L, layout=layout, mask_dtype=np.int8
                                    if layout == "compact" else None)
        sh = par.shard_batch(cl, third)
        assert type(sh) is type(cl)
        for name, x in cl._asdict().items():
            want = x[rows] if x.ndim == 2 else x[..., rows]
            assert torch.equal(getattr(sh, name), torch.from_numpy(want)), \
                (layout, name)
    enc = tw.encode_atmosphere(atm)
    sh = par.shard_batch(enc, third)
    for k, u in enc.cols.items():
        assert sh.cols[k].dtype == torch.uint16
        assert np.array_equal(sh.cols[k].view(torch.int16).numpy().view(
            np.uint16), u[rows])
    for k, r in enc.refs.items():
        if isinstance(r, dict):
            assert np.array_equal(sh.refs[k]["uniform"].numpy(), r["uniform"])
        else:
            for a, b in zip(sh.refs[k], r):
                assert np.array_equal(a.numpy(), np.asarray(b))   # whole
    cw = tw.encode_compact_clouds(tsyn.make_mcica_clouds(B, L))
    sh = par.shard_batch(cw, third)
    assert torch.equal(sh.mask_bits, torch.from_numpy(cw.mask_bits[..., rows]))
    assert sh.fields.cols["ciwp"].shape == (5, L)
    # a plain tuple recurses; None leaves stay None
    a2, c2 = par.shard_batch((atm, None), third)
    assert c2 is None and a2.tsfc.shape == (5,)


def test_global_batch_from_host_shards(mesh):
    atm = tsyn.make_atmosphere(7, 3)
    cl = tsyn.make_mcica_clouds(7, 3)
    (a, c), rows = par.global_batch_from_host_shards(mesh, (atm, cl))
    assert rows == slice(0, 7)
    assert torch.equal(c.cldfmc, torch.from_numpy(cl.cldfmc))
    with pytest.raises(ValueError, match="mixed column counts"):
        par.global_batch_from_host_shards(
            mesh, (atm, tsyn.make_mcica_clouds(6, 3)))


def test_sharded_step_is_the_model(mesh, model):
    atm = tsyn.make_atmosphere(9, 7, seed=3)
    cl = tsyn.make_mcica_clouds(9, 7, seed=4)
    step = par.make_sharded_step(model, mesh)
    out = step(*par.shard_batch((atm, cl), mesh))
    ref = model(Atmosphere.from_numpy(atm, "cpu"),
                McicaCloudsCompact.from_numpy(cl, "cpu"))
    for a, b in zip(out, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="shard_batch"):
        step(Atmosphere.from_numpy(atm, "meta"), None)


def test_sharded_grad_step_without_a_group(mesh, model):
    atm, cl = par.shard_batch((tsyn.make_atmosphere(5, 6, seed=1),
                               tsyn.make_mcica_clouds(5, 6)), mesh)
    ls, gs = par.make_sharded_grad_step(model, mesh)(atm, cl)
    l1, g1 = par.make_grad_step(model)(atm, cl)
    assert torch.equal(ls, l1)
    assert all(torch.equal(a, b) for a, b in zip(gs, g1))


def _fluxes(seed, B=16, L=10):
    rng = np.random.default_rng(seed)
    f = {n: 200.0 + 50.0 * rng.random((B, L + 1))
         for n in ("uflx", "dflx", "uflxc", "dflxc")}
    f.update(hr=rng.standard_normal((B, L)), hrc=rng.standard_normal((B, L)))
    return f


@pytest.mark.parametrize("with_reference", [False, True])
def test_metrics_equal_jax(mesh, with_reference):
    f, r = _fluxes(0), _fluxes(1)
    tf = Fluxes(**{k: torch.from_numpy(v) for k, v in f.items()})
    tr = Fluxes(**{k: torch.from_numpy(v) for k, v in r.items()})
    jf = JFluxes(**{k: jnp.asarray(v) for k, v in f.items()})
    jr = JFluxes(**{k: jnp.asarray(v) for k, v in r.items()})
    jmesh = jpar.make_mesh(jax.devices()[:1])
    got = par.make_metrics_fn(mesh, with_reference)(
        *((tf, tr) if with_reference else (tf,)))
    ref = jpar.make_metrics_fn(jmesh, with_reference)(
        *((jf, jr) if with_reference else (jf,)))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-12,
                                   atol=0, err_msg=k)
    got = par.flux_error_norms(tf, tr)
    assert set(got) == {"uflx_maxabs", "dflx_maxabs", "hr_maxabs",
                        "uflx_rms"}
    assert float(par.flux_stats(tf)["ncol"]) == 16


def test_prefetch_order(mesh):
    batches = [tsyn.make_atmosphere(8, 5, seed=s) for s in range(5)]
    for depth in (0, 1, 2, 4):
        seen = _within(lambda: list(par.prefetch(batches, mesh, depth)))
        assert len(seen) == 5
        for a, b in zip(seen, batches):
            assert torch.equal(a.tsfc, torch.from_numpy(b.tsfc))


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_local_shards_placed_whole(depth):
    """``local=True``: each rank's own shards cross whole; without it a
    rank cuts its columns of a global batch."""
    third = par.Mesh(None, 1, 3, CPU)          # rank 1 of 3: columns 5:10
    batches = [(tsyn.make_atmosphere(16, 4, seed=s),
                tsyn.make_mcica_clouds(16, 4, seed=s)) for s in range(3)]
    whole = _within(lambda: list(par.prefetch(batches, third, depth,
                                              local=True)))
    cut = _within(lambda: list(par.prefetch(batches, third, depth)))
    for (a, c), (a2, c2), (atm, cl) in zip(whole, cut, batches):
        assert torch.equal(a.play, torch.from_numpy(atm.play))
        assert torch.equal(c.cldfmc, torch.from_numpy(cl.cldfmc))
        assert torch.equal(a2.play, torch.from_numpy(atm.play[5:10]))
        assert torch.equal(c2.cldfmc, torch.from_numpy(cl.cldfmc[..., 5:10]))


def test_prefetch_propagates_source_errors(mesh):
    def gen():
        yield tsyn.make_atmosphere(8, 5)
        raise RuntimeError("boom")

    def consume():
        it = par.prefetch(gen(), mesh, depth=2)
        next(it)
        with pytest.raises(RuntimeError, match="boom"):
            next(it)
    _within(consume)


def test_prefetch_early_exit_no_hang(mesh):
    batches = [tsyn.make_atmosphere(8, 5, seed=s) for s in range(50)]
    before = {t.name for t in threading.enumerate()}

    def consume():
        for i, _ in enumerate(par.prefetch(iter(batches), mesh, depth=2)):
            if i == 2:
                break
        return len(list(par.prefetch(batches[:3], mesh, depth=2)))
    assert _within(consume) == 3
    left = [t for t in threading.enumerate()
            if t.name.startswith("rrtmg-prefetch") and t.name not in before]
    for t in left:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in left)


def test_run_epoch_namedtuple_batches(mesh):
    clear = make_model(LWConfig(icld=0, use_lut=False), device="cpu")
    step = par.make_sharded_step(clear, mesh)
    batches = [tsyn.make_atmosphere(6, 5, seed=s) for s in range(3)]
    outs = []
    last = _within(lambda: par.run_epoch(step, batches, mesh,
                                         callback=outs.append))
    assert len(outs) == 3 and last is outs[-1]
    assert torch.equal(last.uflx, clear(Atmosphere.from_numpy(batches[-1],
                                                              "cpu")).uflx)


def test_wire_stream_step_matches_jax(mesh):
    """The streamed step, float64, B=16, L=21, against JAX's decode then
    model on the same codes, the mask fixed by JAX's uniforms."""
    B, L, G = 16, 21, 140
    atm = jsyn.make_atmosphere(B, L)
    cp = jsyn.make_cloud_profile_fields(B, L, seed=2)
    ea = jw.encode_atmosphere(atm, schema="coded")
    ec = jw.encode_cloud_profiles(cp, schema="coded")
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, (L, G, B), "float64")
    jmodel = jmake_model(JConfig(icld=2, imca=1, use_lut=False,
                                 taumol_impl="xla", rt_impl="xla"))
    a = jw.decode_atmosphere(ea, jnp.zeros((B, L, 16)), jnp.float64)
    c = jw.decode_cloud_profiles(ec, jnp.float64, like=a.play)
    jc = jm.mcica_subcol_lw_compact(key, 2, c["cldfrac"], c["ciwp"],
                                    c["clwp"], c["rei"], c["rel"],
                                    mask_dtype=np.int8)
    ref = jmodel(a, jc)

    model = make_model(LWConfig(icld=2, imca=1, use_lut=False),
                       device="cpu", tables=tables_from_numpy(
                           jmodel.ktables, jmodel.static_np, device="cpu"))

    def sample(i, p):
        return tm.mcica_subcol_lw_compact(
            None, 2, p["cldfrac"], p["ciwp"], p["clwp"], p["rei"],
            p["rel"], mask_dtype=torch.int8,
            uniforms=(torch.from_numpy(np.array(u)), None))
    step = wire_streaming.make_step(model, mesh, B, L, sample=sample)
    host = [(tw.encode_atmosphere(tsyn.make_atmosphere(B, L),
                                  schema="coded"),
             tw.encode_cloud_profiles(tsyn.make_cloud_profile_fields(
                 B, L, seed=2), schema="coded"))]
    out = _within(lambda: par.run_epoch(step, host, mesh))
    assert out.wire_ok is not None and bool(out.wire_ok.all())
    for name in ("uflx", "dflx", "uflxc", "dflxc"):
        d = np.abs(getattr(out, name).numpy()
                   - np.asarray(getattr(ref, name))).max()
        assert d <= 1e-10, (name, d)
    assert not torch.allclose(out.uflx, out.uflxc)
