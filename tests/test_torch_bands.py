"""Band subsets (istart/iend) of the port's model against the JAX model
with its XLA engines, in float64, on the same seeded numpy inputs, and
the routing of the "cuda" impl.

(a) Band subsets (16, 16), (1, 15) and (5, 9) at idrv=1: clear and McICA
    with use_lut=True, per-band clouds (maximum-random) with
    use_lut=False; setcoef's istart=16 branch (band 16 of the Planck
    sources from totplk16 / totplk16deriv) bitwise equal to the JAX
    package's.
(b) The routing on the "cuda" impl (its wrappers' plain route on the
    CPU, float32): a LUT or band-subset step never reaches the RT sweep
    kernel's wrappers, a closed-form full-band step does, and both give
    the eager step's fluxes bitwise.

Tolerances (tests/test_torch_model.py's): 1e-11 W/m2 on fluxes and
their d/dT, 2e-9 K/day on heating rates, bounds_ok equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.ops import setcoef as jsetcoef
from rrtmg_lw_tpu.ops.inatm import inatm as jinatm
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import Atmosphere, LWConfig, make_model
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.models import radiation
from rrtmg_lw_torch.ops import setcoef
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.utils import synthetic as tsyn
from test_torch_lut import (FLUXES, HEATING, assert_parity, cloud_case,
                            run_pair)

torch.set_num_threads(1)


# --------------------------------------------------------------- (a)

@pytest.mark.parametrize("bands", [(16, 16), (1, 15), (5, 9)])
@pytest.mark.parametrize("icld,imca,kind,use_lut", [
    (0, 1, None, True), (2, 1, "compact", True), (2, 0, "band", False)])
def test_band_subsets_match_jax(bands, icld, imca, kind, use_lut):
    istart, iend = bands
    out, ref = run_pair(dict(icld=icld, imca=imca, istart=istart, iend=iend,
                             use_lut=use_lut, idrv=1), kind)
    assert_parity(out, ref)
    if kind:
        assert not torch.allclose(out.uflx, out.uflxc)


def test_setcoef_band16_matches_jax():
    """setcoef's istart=16 branch: band 16 of the Planck sources from
    totplk16 / totplk16deriv, level 0 with totplnk's slope."""
    B, L = 5, 12
    jm = jmake_model(JConfig(taumol_impl="xla", rt_impl="xla"))
    jprof = jinatm(jsyn.make_atmosphere(B, L), dtype=jnp.float64)
    tm = make_model(LWConfig(istart=16, iend=16), device="cpu",
                    tables=tables_from_numpy(jm.ktables, jm.static_np,
                                             device="cpu"))
    prof = inatm(Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"))
    for istart in (1, 16):
        jsc = jsetcoef.setcoef(jprof, jm.static, istart=istart)
        sc = setcoef.setcoef(prof, tm.static_tensors(), istart=istart)
        for name in ("planklay", "planklev", "plankbnd", "dplankbnd_dt"):
            np.testing.assert_array_equal(getattr(sc, name).numpy(),
                                          np.asarray(getattr(jsc, name)),
                                          err_msg=f"{istart} {name}")
    # band 16 alone moves, and level 0 keeps totplnk's slope
    sc1 = setcoef.setcoef(prof, tm.static_tensors())
    assert torch.equal(sc.planklay[..., :15], sc1.planklay[..., :15])
    assert not torch.equal(sc.planklay[..., 15], sc1.planklay[..., 15])
    # the blocked sources the model writes over the Planck kernel's
    p16lay, p16lev = setcoef.band16_sources(prof.tavel, prof.tz,
                                            tm.static_tensors())
    assert torch.equal(p16lay, sc.planklay[..., 15])
    assert torch.equal(p16lev, sc.planklev[..., 15])


# --------------------------------------------------------------- (b)

@pytest.mark.parametrize("kw,kind,k1", [
    (dict(icld=2), "compact", False),
    (dict(icld=0, istart=5, iend=9, use_lut=False), None, False),
    (dict(icld=2, imca=0, use_lut=False), "band", True),
    (dict(icld=1, imca=0, iceflag=1, use_lut=False), "ncbands", True)])
def test_cuda_impl_routes_the_sweep(monkeypatch, kw, kind, k1):
    """On the "cuda" impl (float32; the wrappers' plain route on the CPU)
    the RT sweep kernel's wrappers run only for use_lut=False over all 16
    bands, and then give the eager step's fluxes."""
    B, L = 4, 10
    cfg = LWConfig(dtype="float32", **kw)
    _, tcl = cloud_case(kind, B, L)
    if tcl is not None:
        tcl = type(tcl)(*(x.float() if x.is_floating_point() else x
                          for x in tcl))
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu",
                                torch.float32)
    eager = make_model(cfg, device="cpu")
    kernels = make_model(cfg, device="cpu")
    kernels.impl = "cuda"
    assert kernels.rt_kernels == k1
    calls = []
    wrapped = {k: (lambda f, k=k: lambda *a, **kw: (calls.append(k),
                                                     f(*a, **kw))[1])(f)
               for k, f in radiation.WRAPPERS.items()}
    monkeypatch.setattr(radiation, "WRAPPERS", wrapped)
    ref, got = eager(atm, tcl), kernels(atm, tcl)
    assert bool(calls) == k1, calls
    for name in FLUXES + HEATING:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
