"""Physics anchors of the PyTorch port (the port's side of
tests/test_invariants.py), on the CPU in float64: value anchors that do
not come from the JAX package, the oracle or the k-tables.

* ``rrtmg_lw_torch.utils.blackbody`` equals the JAX package's
  ``utils/blackbody.py`` exactly (the same constants and quadrature), at
  several temperatures.
* The isothermal enclosure through the whole model (black surface, every
  temperature T_ISO): the surface upward flux equals the blackbody band
  emission integrated from CODATA constants within 2e-4 (the 1 K totplnk
  table), every level within the correlated-k envelope (5e-4 clear, 2e-2
  cloudy; the clear-sky fluxes 5e-4), no downward flux at the top, the
  downward flux growing toward the surface, over tests/test_invariants.py's
  ``CONFIGS`` (:96-102): icld 0/1/2, McICA and per-band clouds, the
  lookup tables and the closed form.
* Heating as the net-flux divergence times heatfac = g secdy / (cpdair
  1e2), recomputed from first principles, within 1e-10 of max |hr|, over
  the same configurations.
* The plain sweeps (``ops/rtrn.py`` random overlap and McICA,
  ``ops/rtrnmr.py`` maximum-random) on crafted inputs: with
  layer-constant Planck fractions and isothermal sources the upward flux
  is level-independent (1e-12; McICA 3e-5, its two separately quantized
  absorptances); the transparent limit (no downward flux, the surface
  emission at every level, no heating; 1e-12 of the flux, 1e-9 K/day);
  the opaque limit (net flux ~0 below the top, 1e-6; the surface's
  downward flux the blackbody at the bottom level's temperature, 2e-4;
  heating ~0 but in the top layer, which cools); and the exact
  Schwarzschild solution for a source linear in optical depth
  (tests/test_invariants.py's ``SCHWARZ_CASES`` and tolerances).
"""

import numpy as np
import pytest
import torch

from rrtmg_lw_tpu.utils import blackbody as jbb

from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig, McicaClouds,
                            make_model)
from rrtmg_lw_torch.constants import FLUXFAC, WTDIFF
from rrtmg_lw_torch.ops import rtrn as rt
from rrtmg_lw_torch.ops import rtrnmr as rtmr
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.ops.setcoef import setcoef
from rrtmg_lw_torch.utils import blackbody as tbb
from rrtmg_lw_torch.utils.blackbody import band_anchor, sigma_T4
from rrtmg_lw_torch.utils.synthetic import (make_atmosphere,
                                            make_band_clouds,
                                            make_mcica_clouds)

torch.set_num_threads(1)

B, L = 8, 43
T_ISO = 288.6
F64 = torch.float64
# (icld, imca, use_lut) across the three RT cores, LUT and closed form
# (tests/test_invariants.py:96-102)
CONFIGS = [(0, 1, True), (0, 1, False), (1, 0, True), (2, 0, True),
           (2, 1, True), (2, 1, False)]
KINDS = ["rtrn", "mcica", "rtrnmr"]


@pytest.mark.parametrize("T", [150.0, 220.5, 288.6, 310.0])
def test_blackbody_equals_jax(T):
    static = make_model(device="cpu").static_np
    assert tbb.planck_band_flux(T, 10.0, 350.0) == \
        jbb.planck_band_flux(T, 10.0, 350.0)
    assert band_anchor(static, T) == jbb.band_anchor(static, T)
    assert sigma_T4(T) == jbb.sigma_T4(T)
    for name in ("H_PLANCK", "C_LIGHT", "K_BOLTZ", "SIGMA_SB"):
        assert getattr(tbb, name) == getattr(jbb, name)


def isothermal_atmosphere(ncol, nlay, T):
    atm = Atmosphere.from_numpy(make_atmosphere(ncol, nlay), "cpu")
    return atm._replace(tlay=torch.full_like(atm.tlay, T),
                        tlev=torch.full_like(atm.tlev, T),
                        tsfc=torch.full_like(atm.tsfc, T),
                        emis=torch.ones_like(atm.emis))


def clouds_for(cfg, ncol=B, nlay=L):
    if cfg.icld == 0:
        return None
    if cfg.imca == 1:
        return McicaClouds.from_numpy(make_mcica_clouds(ncol, nlay,
                                                        layout="batch"),
                                      "cpu")
    return BandClouds.from_numpy(make_band_clouds(ncol, nlay), "cpu")


@pytest.mark.parametrize("icld,imca,use_lut", CONFIGS)
def test_isothermal_full_model(icld, imca, use_lut):
    cfg = LWConfig(icld=icld, imca=imca, use_lut=use_lut, dtype="float64")
    model = make_model(cfg, device="cpu")
    fl = model(isothermal_atmosphere(B, L, T_ISO), clouds_for(cfg))
    anchor = band_anchor(model.static_np, T_ISO)
    uflx = fl.uflx.numpy()
    # the surface: rad0 = fracs * plankbnd summed over g, exact but for
    # the table
    assert abs(uflx[:, 0] / anchor - 1).max() < 2e-4
    # the levels: the correlated-k redistribution envelope
    env = 5e-4 if icld == 0 else 2e-2
    assert abs(uflx / anchor - 1).max() < env
    assert abs(fl.uflxc.numpy() / anchor - 1).max() < 5e-4
    dflx = fl.dflx.numpy()
    assert np.abs(dflx[:, -1]).max() < 1e-12
    assert (dflx[:, :-1] >= dflx[:, 1:] - 1e-12 * anchor).all()
    assert dflx.max() <= anchor * (1 + env)
    # the 10-3250 cm^-1 window holds almost all of sigma T^4
    assert 0.995 * sigma_T4(T_ISO) < anchor < sigma_T4(T_ISO)


@pytest.mark.parametrize("icld,imca,use_lut", CONFIGS)
def test_heating_is_flux_divergence(icld, imca, use_lut):
    cfg = LWConfig(icld=icld, imca=imca, use_lut=use_lut, dtype="float64")
    model = make_model(cfg, device="cpu")
    atm = Atmosphere.from_numpy(make_atmosphere(B, L), "cpu")
    fl = model(atm, clouds_for(cfg))
    heatfac = 9.8066 * 86400.0 / (1.004e3 * 1.0e2)
    pz = inatm(atm, F64).pz.numpy()
    fnet = fl.uflx.numpy() - fl.dflx.numpy()
    ref = heatfac * (fnet[:, :-1] - fnet[:, 1:]) / (pz[:, :-1] - pz[:, 1:])
    got = fl.hr.numpy()
    assert np.abs(got - ref).max() < 1e-10 * np.abs(got).max() + 1e-12


def _stack(atm):
    """The model, profile, setcoef output and layer-constant Planck
    fractions summing to 1 per band, for the direct sweep drives."""
    model = make_model(LWConfig(icld=0, dtype="float64", use_lut=True),
                       device="cpu")
    prof = inatm(atm, F64)
    sc = setcoef(prof, model.static_tensors(), istart=1, idrv=0)
    ng = np.asarray(model.static_np["ngb"])
    counts = np.bincount(ng - 1, minlength=16)
    fracs = torch.as_tensor(1.0 / counts[ng - 1], dtype=F64).expand(B, L,
                                                                     140)
    return model, prof, sc, fracs


@pytest.fixture(scope="module")
def stack64():
    atm = Atmosphere.from_numpy(make_atmosphere(B, L), "cpu")
    return _stack(atm._replace(emis=torch.ones_like(atm.emis),
                               tsfc=atm.tlev[:, 0].clone()))


@pytest.fixture(scope="module")
def stack64_iso():
    return _stack(isothermal_atmosphere(B, L, T_ISO))


def _rt(model, prof, sc, fracs, taut, kind, use_lut=True, odcld=0.7):
    kw = dict(static=model.static_np, luts=model.luts, use_lut=use_lut,
              idrv=0, heatfac_val=model.heatfac, istart=1, iend=16)
    args = (taut, fracs, sc.planklay, sc.planklev, sc.plankbnd, prof.semiss,
            prof.pwvcm, prof.pz)
    zero = torch.zeros_like(taut)
    if kind == "rtrn":          # clear through the random-overlap core
        return rt.rt_random_overlap(
            *args, zero, zero, cloudy_lay=torch.zeros(taut.shape[:2],
                                                      dtype=torch.bool),
            cld_gate=torch.zeros(taut.shape, dtype=torch.bool), **kw)
    if kind == "mcica":         # binary per-g clouds on half the g's
        gate = torch.zeros(taut.shape, dtype=torch.bool)
        gate[:, 5:9, ::2] = True
        od = torch.where(gate, odcld, 0.0).to(F64)
        return rt.rt_random_overlap(*args, gate.to(F64), od,
                                    cloudy_lay=gate.any(-1), cld_gate=gate,
                                    **kw)
    if kind == "rtrnmr":        # deterministic maximum-random overlap
        cldfrac = torch.zeros(taut.shape[:2], dtype=F64)
        cldfrac[:, 5:9] = 0.4
        od = torch.where(cldfrac[..., None] > 0, odcld, 0.0) * \
            torch.ones_like(taut)
        return rtmr.rt_maxrandom(*args, cldfrac, od, **kw)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", KINDS)
def test_isothermal_exact_collapse(stack64_iso, kind):
    model, prof, sc, fracs = stack64_iso
    rng = np.random.default_rng(3)
    taut = torch.as_tensor(rng.gamma(0.6, 1.0, (B, L, 140)))
    u = _rt(model, prof, sc, fracs, taut, kind).totuflux.numpy()
    tol = 3e-5 if kind == "mcica" else 1e-12
    assert np.abs(u - u[:, :1]).max() / u.max() < tol
    anchor = band_anchor(model.static_np, T_ISO)
    assert abs(u[:, 0] / anchor - 1).max() < 2e-4


@pytest.mark.parametrize("kind", KINDS)
def test_transparent_limit(stack64, kind):
    model, prof, sc, fracs = stack64
    taut = torch.full((B, L, 140), 1e-30, dtype=F64)
    out = _rt(model, prof, sc, fracs, taut, kind, odcld=0.0)
    u = out.totuflux.numpy()
    scale = float(u.max())
    assert np.abs(out.totdflux.numpy()).max() < 1e-12 * scale
    assert np.abs(u - u[:, :1]).max() < 1e-12 * scale
    assert np.abs(out.htr.numpy()).max() < 1e-9


@pytest.mark.parametrize("kind", KINDS)
def test_opaque_limit(stack64, kind):
    model, prof, sc, fracs = stack64
    taut = torch.full((B, L, 140), 1e7, dtype=F64)
    out = _rt(model, prof, sc, fracs, taut, kind, use_lut=False)
    u, d = out.totuflux.numpy(), out.totdflux.numpy()
    fnet = u - d
    assert np.abs(fnet[:, :-1]).max() / u.max() < 1e-6
    # the common value is the local blackbody at the bottom level
    anchor = band_anchor(model.static_np, float(prof.tz[0, 0]))
    assert abs(d[0, 0] - anchor) / anchor < 2e-4
    htr = out.htr.numpy()
    assert np.abs(htr[:, :-1]).max() < 1e-2          # K/day
    assert (htr[:, -1] < 0).all()                    # the top cools


def _schwarzschild_setup(model, dtau, nlay=48):
    """A source linear in the cumulative diffuse optical depth, B(tau) =
    B0 + beta tau, constant od a layer, a black surface at the level-0
    value: dI/dtau = B - I integrates in closed form, and the linear-in-
    tau source is its exact integral (tests/test_invariants.py:315-374)."""
    static = model.static_np
    ngb = np.asarray(static["ngb"]) - 1
    counts = np.bincount(ngb, minlength=16)
    Bc, Lc = 2, nlay
    pwvcm = torch.full((Bc,), 2.0, dtype=F64)
    sec = rt.secdiff(pwvcm, F64).numpy()
    taut = torch.as_tensor(np.broadcast_to(
        dtau / sec[:, ngb][:, None, :], (Bc, Lc, 140)).copy())
    fracs = torch.as_tensor(1.0 / counts[ngb]).expand(Bc, Lc, 140)
    tau_lev = np.arange(Lc + 1) * dtau
    beta, B0 = 3.0, 40.0
    Blev = B0 + beta * tau_lev[::-1]
    Blay = 0.5 * (Blev[:-1] + Blev[1:])

    def rows(x, n):
        return torch.as_tensor(np.broadcast_to(x[None, :, None],
                                               (Bc, n, 16)).copy())
    args = dict(
        taut=taut, fracs=fracs, pwvcm=pwvcm, planklev=rows(Blev, Lc + 1),
        planklay=rows(Blay, Lc),
        plankbnd=torch.full((Bc, 16), Blev[0], dtype=F64),
        semiss=torch.ones((Bc, 16), dtype=F64),
        pz=torch.as_tensor(np.broadcast_to(np.linspace(1000, 10, Lc + 1)[None],
                                           (Bc, Lc + 1)).copy()))
    taud = tau_lev[::-1]
    I_dn = (B0 + beta * taud) - beta - (B0 - beta) * np.exp(-taud)
    I_up = (Blev[0] - beta * tau_lev) + beta - beta * np.exp(-tau_lev)
    scale = (WTDIFF * np.asarray(static["delwave"]) * FLUXFAC).sum()
    return args, I_up, I_dn, scale


# (tests/test_invariants.py:380-385): the Taylor branch below od 0.06, the
# exact closed form, optically thick, and the lookup tables' quantization
SCHWARZ_CASES = [(0.02, False, 1e-4), (0.11, False, 1e-14),
                 (2.50, False, 1e-14), (0.11, True, 1e-3)]


@pytest.mark.parametrize("dtau,use_lut,tol", SCHWARZ_CASES)
def test_schwarzschild_linear_in_tau(dtau, use_lut, tol):
    model = make_model(LWConfig(icld=0, dtype="float64", use_lut=use_lut),
                       device="cpu")
    a, I_up, I_dn, scale = _schwarzschild_setup(model, dtau)
    zero = torch.zeros_like(a["taut"])
    out = rt.rt_random_overlap(
        a["taut"], a["fracs"], a["planklay"], a["planklev"], a["plankbnd"],
        a["semiss"], a["pwvcm"], a["pz"], zero, zero,
        cloudy_lay=torch.zeros(a["taut"].shape[:2], dtype=torch.bool),
        cld_gate=torch.zeros(a["taut"].shape, dtype=torch.bool),
        static=model.static_np, luts=model.luts, use_lut=use_lut, idrv=0,
        heatfac_val=model.heatfac, istart=1, iend=16)
    u = out.totuflux.numpy()[0] / scale
    d = out.totdflux.numpy()[0] / scale
    assert np.abs(u - I_up).max() / np.abs(I_up).max() < tol
    assert np.abs(d - I_dn).max() / np.abs(I_dn).max() < tol
