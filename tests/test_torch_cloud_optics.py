"""The port's remaining cloud optics against the JAX package in float64,
on the same seeded numpy inputs: the closed-form ice and liquid
coefficients (iceflag 0/1, liqflag 0), the reference's running ncbands
of per-band clouds (``cldprop_ncbands``, ``expand_cloud_bands``), and the
model on those flags, McICA and per-band, icld 4/5 without McICA
included; then, without JAX, the port's LUT model on the ordered field
against the scalar oracle (``tests/oracle``).  The gradient step on these
flags: tests/test_torch_config_grads.py.

(a) ``_ice_liq_coeffs``, ``bounds_ok``, ``cldprmc`` /
    ``cldprmc_blocked`` and ``cloud_optics_bands_blocked`` per flag pair,
    on radii across each parameterization's bounds.
(b) ``cldprop_ncbands`` and ``expand_cloud_bands`` (weighted and ratio
    prefold) per flag pair on ``make_ncbands_clouds``, which drives the
    final ncbands to 1, 5 and 16 and reaches the iceflag=1 pure-ice
    promotion and the write bound (a layer writing fewer slots than a
    later one sets).
(c) The model (use_lut True and False) on those flags: per-band clouds
    icld 1-5 without McICA, McICA compact and per-g, idrv=1 included.
(d) No JAX: the port's float64 LUT model, icld 1 and 2, on 3 columns of
    the ordered field, against ``oracle.cld.cldprop_1col`` and
    ``oracle.rt.rtrnmc_1col`` / ``rtrnmr_1col`` fed the port's own gas od
    and Planck sources (the tolerances of tests/test_core_vs_oracle.py).

Tolerances: (a)-(b) 1e-14 relative, ncbands and bounds_ok equal; (c)
1e-11 W/m2 and 2e-9 K/day (tests/test_torch_model.py's); (d) rtol 1e-6
(up),
rtol 1e-6 / atol 1e-5 (down), the ncbands equal and the cloud-band od
within 1e-12 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rrtmg_lw_tpu.ops import cldprop as jcldprop
from rrtmg_lw_tpu.ops import rtrn as jrtrn
from rrtmg_lw_tpu.types import BandClouds as JBandClouds
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig, McicaClouds,
                            McicaCloudsCompact, make_model)
from rrtmg_lw_torch.constants import heatfac
from rrtmg_lw_torch.data.ktables import STATIC_TENSORS, load_static
from rrtmg_lw_torch.ops import cldprop, rtrn
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.ops.setcoef import setcoef
from rrtmg_lw_torch.utils import synthetic as tsyn
from test_torch_lut import assert_parity, cloud_case, run_pair

torch.set_num_threads(1)

B, L = 8, 16
RTOL = 1e-14
# the flag pairs with closed forms, and the tabulated pair for reference
FLAGS = [(0, 1), (1, 1), (3, 0), (1, 0), (0, 0)]


@pytest.fixture(scope="module")
def static():
    """(numpy static tables, the port's static tensors) in float64."""
    st = load_static()
    return st, {k: torch.as_tensor(np.asarray(st[k], np.float64))
                for k in STATIC_TENSORS}


def assert_rel(got, ref, tol=RTOL, name=""):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), name


def radii(shape, seed=5):
    """Ice radii 1-150 um, liquid 0.5-65 um: inside and past every
    parameterization's bounds."""
    rng = np.random.default_rng(seed)
    return 1.0 + 149.0 * rng.random(shape), 0.5 + 64.5 * rng.random(shape)


# --------------------------------------------------------------- (a)

@pytest.mark.parametrize("iceflag,liqflag", FLAGS)
def test_closed_form_coefficients_match_jax(static, iceflag, liqflag):
    st, tabs = static
    reic, relq = radii((B, L))
    ji, jl, jok = jcldprop._ice_liq_coeffs(jnp.asarray(reic),
                                           jnp.asarray(relq), iceflag,
                                           liqflag, st, jnp.float64)
    ti, tl, tok = cldprop._ice_liq_coeffs(torch.as_tensor(reic),
                                          torch.as_tensor(relq), iceflag,
                                          liqflag, tabs)
    assert_rel(ti, ji, name="abscoice")
    assert_rel(tl, jl, name="abscoliq")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.any() and not tok.all()
    assert not cldprop.tabulated(iceflag, liqflag)

    # the McICA forms: per-band (L, 16, B) and per-g cldprmc
    flags = dict(iceflag=iceflag, liqflag=liqflag)
    ncl = jsyn.make_mcica_clouds(B, L, layout="batch")._replace(
        reicmc=reic, relqmc=relq)
    jcl = type(ncl)(*(jnp.asarray(x) for x in ncl))
    ai, al, ok = cldprop.cloud_optics_bands_blocked(
        McicaCloudsCompact(None, None, None, torch.as_tensor(reic),
                           torch.as_tensor(relq)), tabs, **flags)
    jai, jal, jok2 = jcldprop.cloud_optics_bands_blocked(jcl, st,
                                                         use_pallas=False,
                                                         **flags)
    assert_rel(ai, jai)
    assert_rel(al, jal)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok2))
    tcl = McicaClouds.from_numpy(ncl, "cpu")
    tau, tok = cldprop.cldprmc(tcl, tabs, inflag=2, **flags)
    jtau, jok = jcldprop.cldprmc(jcl, st, inflag=2, **flags)
    assert_rel(tau, jtau)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    tau_t, cldf_t, _ = cldprop.cldprmc_blocked(tcl, tabs, inflag=2, **flags)
    jtau_t, jcldf_t, _ = jcldprop.cldprmc_blocked(jcl, st, inflag=2, **flags)
    assert_rel(tau_t, jtau_t)
    assert_rel(cldf_t, jcldf_t)
    assert float(tau.abs().max()) > 0


# --------------------------------------------------------------- (b)

@pytest.mark.parametrize("iceflag,liqflag", FLAGS)
def test_cldprop_ncbands_matches_jax(static, iceflag, liqflag):
    st, tabs = static
    nbc = tsyn.make_ncbands_clouds(B, L)
    jbc = JBandClouds(*(jnp.asarray(x) for x in nbc))
    tbc = BandClouds.from_numpy(nbc, "cpu")
    flags = dict(inflag=2, iceflag=iceflag, liqflag=liqflag)
    assert not cldprop.cloud_bands_static(**flags)
    jt, jn, jok = jcldprop.cldprop_ncbands(jbc, st, **flags)
    tt, tn, tok = cldprop.cldprop_ncbands(tbc, tabs, **flags)
    assert_rel(tt, jt, name="taucloud")
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    reached = {(1, 1): {1, 5, 16}, (0, 1): {1, 16}, (3, 0): {1, 16},
               (1, 0): {1, 5}, (0, 0): {1}}[iceflag, liqflag]
    assert set(tn.tolist()) == reached
    pw = np.random.default_rng(8).uniform(0.5, 6.0, B)
    jsec = jrtrn.secdiff(jnp.asarray(pw), jnp.float64)
    tsec = rtrn.secdiff(torch.as_tensor(pw), torch.float64)
    for weighted in (False, True):
        jx = jcldprop.expand_cloud_bands(jt, jn, jsec, weighted=weighted)
        tx = cldprop.expand_cloud_bands(tt, tn, tsec, weighted=weighted)
        assert_rel(tx, jx, name=f"expand {weighted}")
    # the per-band od without the running ncbands, as the JAX cldprop
    for fn, jfn in ((cldprop.cldprop, jcldprop.cldprop),
                    (cldprop.cldprop_banded_blocked,
                     jcldprop.cldprop_banded_blocked)):
        (tb, tok), (jb, jok) = fn(tbc, tabs, **flags), jfn(jbc, st, **flags)
        assert_rel(tb, jb)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


# --------------------------------------------------------------- (c)

@pytest.mark.parametrize("icld,iceflag,liqflag,use_lut", [
    (1, 1, 1, True), (2, 1, 1, True), (1, 0, 1, True), (2, 3, 0, True),
    (3, 1, 0, True), (2, 1, 1, False), (1, 0, 0, False), (4, 3, 1, True),
    (5, 1, 1, True), (4, 0, 1, False), (5, 3, 1, False)])
def test_band_clouds_model_matches_jax(icld, iceflag, liqflag, use_lut):
    """Per-band clouds without McICA (imca=0) at idrv=1 on the ordered
    field; icld 4/5 take the maximum-random sweep, as the JAX model's
    ``uses_rtmr``."""
    out, ref = run_pair(dict(icld=icld, imca=0, iceflag=iceflag,
                             liqflag=liqflag, use_lut=use_lut, idrv=1),
                        "ncbands", B=B, L=L)
    assert_parity(out, ref)
    assert not torch.allclose(out.uflx, out.uflxc)


@pytest.mark.parametrize("kind,iceflag,liqflag,use_lut", [
    ("compact", 1, 1, True), ("compact", 0, 0, False),
    ("blocked", 1, 0, True), ("batch", 0, 1, False)])
def test_mcica_model_matches_jax(kind, iceflag, liqflag, use_lut):
    """McICA (inflag=2) with the closed-form optics, on radii across
    their bounds (the liquid radius from 2.5 um: below, Hu & Stamnes'
    extrapolation turns the cloud od negative in both packages)."""
    reic, relq = radii((6, 12))
    relq = np.maximum(relq, 2.5)
    jcl, tcl = cloud_case(kind, 6, 12)
    out, ref = run_pair(
        dict(icld=2, iceflag=iceflag, liqflag=liqflag, use_lut=use_lut),
        clouds=(jcl._replace(reicmc=jnp.asarray(reic),
                             relqmc=jnp.asarray(relq)),
                tcl._replace(reicmc=torch.as_tensor(reic),
                             relqmc=torch.as_tensor(relq))))
    assert_parity(out, ref)
    assert not out.cld_bounds_ok.all()


# --------------------------------------------------------------- (d)

@pytest.mark.parametrize("icld", [1, 2])
def test_lut_ncbands_model_matches_oracle(icld):
    """The scalar oracle's cldprop and rtrn / rtrnmr (the Fortran's
    cloud-band contract: ipat, the cloud band's secant) on the port's own
    gas od, Planck sources and lookup tables: no JAX on either side."""
    from oracle import cld as ocld
    from oracle import rt as ort
    Bo, Lo = 3, 16
    st = load_static()
    kw = dict(icld=icld, imca=0, inflag=2, iceflag=1, liqflag=1)
    model = make_model(LWConfig(**kw), device="cpu")
    nbc = tsyn.make_ncbands_clouds(8, Lo)
    nbc = type(nbc)(*(x[[0, 1, 6]] for x in nbc))    # final 16, 5, 5
    # radii inside iceflag 1's and liqflag 1's bounds: the oracle, as the
    # reference, stops on any other (tests/oracle/cld.py:62, :92)
    nbc = nbc._replace(reic=np.clip(nbc.reic, 13.0, 130.0),
                       relq=np.clip(nbc.relq, 2.5, 60.0))
    tbc = BandClouds.from_numpy(nbc, "cpu")
    prof = inatm(Atmosphere.from_numpy(tsyn.make_atmosphere(Bo, Lo), "cpu"))
    out = model.from_profile(prof, tbc)
    tau_t, ncb_t, _ = cldprop.cldprop_ncbands(tbc, model.static_tensors(),
                                              inflag=2, iceflag=1, liqflag=1)
    assert ncb_t.tolist() == [16, 5, 5]
    sc = setcoef(prof, model.static_tensors())
    taug_t, fracs_t = model.engine.blocked(sc, prof)
    taut_t = taug_t + prof.taua.permute(1, 2, 0).index_select(
        1, model.ngb0.long())
    luts = {k: v.numpy() for k, v in model.luts.items()}
    luts["delwave"] = st["delwave"]
    ngb0 = np.asarray(st["ngb"]) - 1
    for c in range(Bo):
        ncb, tau_cb = ocld.cldprop_1col(
            Lo, 2, 1, 1, nbc.cldfrac[c], nbc.tauc[c].T, nbc.ciwp[c],
            nbc.clwp[c], nbc.reic[c], nbc.relq[c], st)
        assert int(ncb_t[c]) == ncb
        np.testing.assert_allclose(tau_t[c].numpy(), tau_cb, rtol=1e-12,
                                   atol=1e-300)
        common = (sc.planklay[c].numpy(), sc.planklev[c].numpy(),
                  sc.plankbnd[c].numpy(), float(prof.pwvcm[c]),
                  fracs_t[:, :, c].numpy(), taut_t[:, :, c].numpy(), luts,
                  heatfac())
        if icld == 2:
            o = ort.rtrnmr_1col(Lo, prof.pz[c].numpy(),
                                prof.semiss[c].numpy(), ngb0, nbc.cldfrac[c],
                                None, *common, cloud_bands=(tau_cb, ncb))
        else:
            o = ort.rtrnmc_1col(Lo, prof.pz[c].numpy(),
                                prof.semiss[c].numpy(), ngb0, None, None,
                                *common, cldfrac_lay=nbc.cldfrac[c],
                                mcica=False, cloud_bands=(tau_cb, ncb))
        np.testing.assert_allclose(out.uflx[c].numpy(), o["totuflux"],
                                   rtol=1e-6, err_msg=f"col {c}")
        np.testing.assert_allclose(out.dflx[c].numpy(), o["totdflux"],
                                   rtol=1e-6, atol=1e-5, err_msg=f"col {c}")
