"""The port's lookup-table sweep (``use_lut=True``, the default config)
against the JAX model with its XLA engines, in float64, on the same
seeded numpy inputs (band subsets: tests/test_torch_bands.py; the
gradient step: tests/test_torch_config_grads.py).

(a) ``ops.tables.build_lookup_tables`` and the RT precompute with the
    tables (every factor, the cloud od plain and exactly weighted)
    bitwise equal to the JAX package's, but the cloud's closed-form
    1 - exp(-od) (within one ulp of 1).
(b) ``make_model()`` against ``rrtmg_lw_tpu.make_model()``, both with
    their default configs (float64, use_lut=True, clear sky), at idrv 0
    and 1, and with a Profile ``dtbound``.
(c) use_lut=True in every cloud layout: McICA compact (int8 mask),
    blocked and per-g (inflag 0 and 2), per-band clouds icld 1/2/3
    (imca=0).

Tolerances (tests/test_torch_model.py's): 1e-11 W/m2 on fluxes and
their d/dT, 2e-9 K/day on heating rates, bounds_ok equal; (a) bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.ops import rtrn as jrtrn
from rrtmg_lw_tpu.ops import setcoef as jsetcoef
from rrtmg_lw_tpu.ops.inatm import inatm as jinatm
from rrtmg_lw_tpu.ops.tables import build_lookup_tables as jbuild_luts
from rrtmg_lw_tpu.types import BandClouds as JBandClouds
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig, McicaClouds,
                            McicaCloudsBlocked, McicaCloudsCompact,
                            make_model)
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.ops import rtrn
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.ops.tables import LUT_NAMES, build_lookup_tables
from rrtmg_lw_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

FLUXES = ("uflx", "dflx", "uflxc", "dflxc")
HEATING = ("hr", "hrc")
DDT = ("duflx_dt", "duflxc_dt")
TOL_FLUX, TOL_HR = 1e-11, 2e-9


def cloud_case(kind, B, L, inflag=2):
    """(JAX clouds, port clouds on the CPU) of one input form: None,
    McICA "compact" (int8 mask), "blocked" or "batch" (with an input od
    taucmc for inflag 0), per-band "band" (make_band_clouds with the
    fractions varied inside each deck) or "ncbands" (the ordered field
    of ``make_ncbands_clouds``)."""
    if kind is None:
        return None, None
    if kind in ("band", "ncbands"):
        if kind == "ncbands":
            nbc = tsyn.make_ncbands_clouds(B, L)
        else:
            nbc = tsyn.make_band_clouds(B, L)
            rng = np.random.default_rng(7)
            cf = nbc.cldfrac * (0.6 + 0.4 * rng.random(nbc.cldfrac.shape))
            nbc = nbc._replace(cldfrac=cf, tauc=rng.random((B, L, 16))
                               * (cf[..., None] > 0))
        return JBandClouds(*nbc), BandClouds.from_numpy(nbc, "cpu")
    if kind == "compact":
        return (jsyn.make_mcica_clouds(B, L, layout="compact",
                                       mask_dtype=np.int8),
                McicaCloudsCompact.from_numpy(tsyn.make_mcica_clouds(
                    B, L, mask_dtype=np.int8), "cpu"))
    jcl = jsyn.make_mcica_clouds(B, L, layout=kind)
    tcl = tsyn.make_mcica_clouds(B, L, layout=kind)
    if inflag == 0:
        jcl, tcl = (c._replace(taucmc=np.asarray(c.cldfmc) * (
            0.05 * np.asarray(c.ciwpmc) + 0.1 * np.asarray(c.clwpmc)))
            for c in (jcl, tcl))
    cls = McicaCloudsBlocked if kind == "blocked" else McicaClouds
    return (type(jcl)(*(jnp.asarray(x) for x in jcl)),
            cls.from_numpy(tcl, "cpu"))


def run_pair(kw, kind=None, B=6, L=12, dtbound=None, clouds=None):
    """(port Fluxes, JAX Fluxes) of one config ``kw`` (LWConfig fields,
    the same for both) on make_atmosphere(B, L) and ``cloud_case(kind)``
    (or ``clouds``, a (JAX, port) pair); the port's model on the JAX
    model's tables."""
    jm = jmake_model(JConfig(taumol_impl="xla", rt_impl="xla", **kw))
    model = make_model(LWConfig(**kw), device="cpu", tables=tables_from_numpy(
        jm.ktables, jm.static_np, device="cpu"))
    jcl, tcl = clouds or cloud_case(kind, B, L, kw.get("inflag", 2))
    jprof = jinatm(jsyn.make_atmosphere(B, L), dtype=jnp.float64)
    prof = inatm(Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"))
    if dtbound is not None:
        jprof = jprof._replace(dtbound=jnp.asarray(dtbound))
        prof = prof._replace(dtbound=torch.as_tensor(dtbound))
    return model.from_profile(prof, tcl), jm.from_profile(jprof, jcl)


def max_abs(out, ref, name):
    return float(np.abs(getattr(out, name).double().numpy()
                        - np.asarray(getattr(ref, name))).max())


def assert_parity(out, ref):
    """Fluxes (and d/dT) within 1e-11 W/m2, heating rates within 2e-9
    K/day, bounds_ok equal, shapes equal."""
    for name in FLUXES + HEATING + DDT:
        if getattr(ref, name) is None:
            assert getattr(out, name) is None, name
            continue
        assert getattr(out, name).shape == np.asarray(
            getattr(ref, name)).shape, name
        tol = TOL_HR if name in HEATING else TOL_FLUX
        assert max_abs(out, ref, name) <= tol, (name, max_abs(out, ref,
                                                              name))
    if ref.cld_bounds_ok is None:
        assert out.cld_bounds_ok is None
    else:
        np.testing.assert_array_equal(out.cld_bounds_ok.numpy(),
                                      np.asarray(ref.cld_bounds_ok))


# --------------------------------------------------------------- (a)

def test_lookup_tables_bitwise_equal_jax():
    got, ref = build_lookup_tables(), jbuild_luts()
    assert got._fields == LUT_NAMES
    for name in LUT_NAMES:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    model = make_model(device="cpu")
    assert model.luts is not None
    for name in LUT_NAMES:
        assert model.luts[name].dtype == torch.float64
        np.testing.assert_array_equal(model.luts[name].numpy(),
                                      getattr(ref, name))
    assert make_model(LWConfig(use_lut=False), device="cpu").luts is None


@pytest.mark.parametrize("weighted", [False, True])
def test_lut_precompute_bitwise_equal_jax(weighted):
    """Every (B, L, G) factor of the LUT precompute, on the gas od of
    the synthetic atmosphere plus per-g clouds across the regimes (od
    0, below, at and above 0.06, and past the table's last entry)."""
    B, L = 4, 10
    jm = jmake_model(JConfig(taumol_impl="xla", rt_impl="xla"))
    jprof = jinatm(jsyn.make_atmosphere(B, L), dtype=jnp.float64)
    jsc = jsetcoef.setcoef(jprof, jm.static)
    jt, jf = jm.engine(jsc, jprof)
    rng = np.random.default_rng(4)
    taut = np.array(jt) * rng.choice([0.0, 1e-3, 1.0, 1e4], jt.shape)
    odcld = rng.choice([0.0, 0.01, 0.06 / 1.66, 0.5, 5.0, 1e12],
                       jt.shape) * rng.random(jt.shape)
    cldf = (rng.random(jt.shape) < 0.5).astype(np.float64)
    gate = cldf >= 0.5
    ngb0 = np.asarray(jm.static_np["ngb"]) - 1
    ref = jrtrn.precompute(
        jnp.asarray(taut), jnp.asarray(cldf), jnp.asarray(odcld),
        jnp.asarray(gate.any(-1)), jnp.asarray(gate), jf, jsc.planklay,
        jsc.planklev, jprof.pwvcm, ngb0, jm.luts, True,
        odcld_weighted=weighted)
    tm = make_model(device="cpu", tables=tables_from_numpy(
        jm.ktables, jm.static_np, device="cpu"))
    t = torch.as_tensor
    got = rtrn.precompute(
        t(taut), t(cldf), t(odcld), t(gate), t(np.asarray(jf)),
        t(np.asarray(jsc.planklay)), t(np.asarray(jsc.planklev)),
        rtrn.secdiff(t(np.asarray(jprof.pwvcm)), torch.float64),
        t(ngb0), tm.luts, odcld_weighted=weighted)
    assert set(got) == set(ref)
    for name in ref:
        if name == "efclfrac":
            # cldf (1 - exp(-od)): the two packages' exp differ in the last
            # bit, which 1 - e keeps as an absolute ulp of 1
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(ref[name]), rtol=0,
                                       atol=2.3e-16)
            continue
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)


# --------------------------------------------------------------- (b)

@pytest.mark.parametrize("idrv", [0, 1])
def test_default_model_matches_jax(idrv):
    """make_model() and rrtmg_lw_tpu.make_model() with their default
    configs (one field apart at idrv=1): float64, use_lut=True, clear."""
    B, L = 6, 12
    assert LWConfig().use_lut and LWConfig().dtype == "float64"
    jm = jmake_model(JConfig(idrv=idrv))
    model = make_model(LWConfig(idrv=idrv), device="cpu",
                       tables=tables_from_numpy(jm.ktables, jm.static_np,
                                                device="cpu"))
    assert model.impl == "eager" and not model.rt_kernels
    out = model(Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"))
    ref = jm(jsyn.make_atmosphere(B, L))
    assert_parity(out, ref)
    # the tables move the fluxes off the closed form's
    closed = make_model(LWConfig(idrv=idrv, use_lut=False), device="cpu",
                        tables=tables_from_numpy(jm.ktables, jm.static_np,
                                                 device="cpu"))(
        Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"))
    assert not torch.equal(out.uflx, closed.uflx)


@pytest.mark.parametrize("icld,kind", [(0, None), (2, "compact")])
def test_default_dtbound_matches_jax(icld, kind):
    dtb = np.random.default_rng(3).uniform(-2.0, 2.0, 6)
    out, ref = run_pair(dict(icld=icld, idrv=1), kind, dtbound=dtb)
    assert_parity(out, ref)


# --------------------------------------------------------------- (c)

@pytest.mark.parametrize("icld,imca,inflag,kind", [
    (2, 1, 2, "compact"), (2, 1, 2, "blocked"), (2, 1, 0, "blocked"),
    (2, 1, 2, "batch"), (2, 1, 0, "batch"), (1, 0, 2, "band"),
    (2, 0, 2, "band"), (3, 0, 0, "band"), (1, 0, 1, "band")])
def test_lut_cloud_layouts_match_jax(icld, imca, inflag, kind):
    out, ref = run_pair(dict(icld=icld, imca=imca, inflag=inflag), kind)
    assert_parity(out, ref)
    assert not torch.allclose(out.uflx, out.uflxc)
