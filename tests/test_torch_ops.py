"""Each module of the PyTorch port that holds a kernel, in its plain
PyTorch version, against the JAX package's XLA counterpart in float64 on
the same seeded numpy inputs: inatm, setcoef (+ the Planck plain
version), the cloud coefficients, taumol, the RT sweep, and for
deterministic clouds the per-band cloud optics (cldprop), the
maximum-random overlap rows and the banded and maxrand sweeps, and the
per-g sweep on K1's edge cases (clear, overcast and top-and-bottom
columns, cloud fractions in (0, 0.5), od exactly 0.06 and 0).  Then,
in float32, the spectral-storage codec (``spec_codec``) against the JAX
package's ``taumol_pallas.spec_*`` functions, and the probes' plain
versions against numpy's ``tbl[idx]``, the archived probes' reference.

Tolerance: 1e-12 relative (float64; the two sides run the same
operations, in different orders only inside reductions), integer
indices exact; 1e-14 for the overlap rows and the cloud optics (the
same elementwise operations, no reduction).  The codec: logu16 codes
equal or one apart on at most 1e-4 of the elements (a one-ulp
difference of the two packages' float32 log at a rounding edge; none
measured here), their decodes within one ulp (exp; measured: 2099 of
26404 one ulp apart), fracs codes and bf16 / f16 casts bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.ops import cldprop as jcldprop
from rrtmg_lw_tpu.ops import rtrn as jrtrn
from rrtmg_lw_tpu.ops import rtrnmr as jrtrnmr
from rrtmg_lw_tpu.ops import setcoef as jsetcoef
from rrtmg_lw_tpu.ops.inatm import inatm as jinatm
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig,
                            McicaCloudsCompact, make_model)
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.ops import cldprop, rtrn, rtrnmr, setcoef
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.utils import synthetic as tsyn
from rrtmg_lw_torch.utils.snapshot import K5_BOOST

torch.set_num_threads(1)

B, L = 8, 20
RTOL = 1e-12
INT_FIELDS = ("laytrop_mask", "jp", "jt", "jt1", "indself", "indfor",
              "indminor")


def assert_rel(got, ref, tol=RTOL, name=""):
    """max |got - ref| <= tol * max |ref| (exact zeros must match); an
    optional field absent (None) on one side must be absent on both."""
    if ref is None or got is None:
        assert got is None and ref is None, name
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= tol * scale, (name, err, scale)


@pytest.fixture(scope="module")
def pair():
    """The JAX model (XLA engines, f64) and the port built from its
    tables, with both packages' profile and setcoef outputs."""
    jm = jmake_model(JConfig(icld=2, imca=1, use_lut=False,
                             taumol_impl="xla", rt_impl="xla"))
    tm = make_model(LWConfig(icld=2, imca=1, use_lut=False), device="cpu",
                    tables=tables_from_numpy(jm.ktables, jm.static_np,
                                             device="cpu"))
    jprof = jinatm(jsyn.make_atmosphere(B, L), dtype=jnp.float64)
    tprof = inatm(Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"))
    return dict(jm=jm, tm=tm, jprof=jprof, tprof=tprof,
                jsc=jsetcoef.setcoef(jprof, jm.static),
                tsc=setcoef.setcoef(tprof, tm.static_tensors()))


def test_inatm_matches_jax(pair):
    for name in pair["tprof"]._fields:
        assert_rel(getattr(pair["tprof"], name),
                   getattr(pair["jprof"], name), name=name)


def test_setcoef_matches_jax(pair):
    tsc, jsc = pair["tsc"], pair["jsc"]
    assert bool(tsc.laytrop_mask.any()) and not bool(tsc.laytrop_mask.all())
    for name in tsc._fields:
        got, ref = getattr(tsc, name), np.asarray(getattr(jsc, name))
        if name in INT_FIELDS:
            assert got.dtype in (torch.int32, torch.bool), name
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        else:
            assert_rel(got, ref, name=name)


def test_planck_plain_matches_jax(pair):
    tprof, jsc = pair["tprof"], pair["jsc"]
    tot = pair["tm"].totplnk
    got = setcoef.interp_planck_blocked(tprof.tavel.t().contiguous(), tot)
    assert_rel(got, np.asarray(jsc.planklay).transpose(1, 2, 0))
    got = setcoef.interp_planck_blocked(tprof.tz.t().contiguous(), tot)
    assert_rel(got, np.asarray(jsc.planklev).transpose(1, 2, 0))
    # the clamped ends of the table (ind = 1 and 180) extrapolate
    temp = np.array([[100.0, 159.0, 159.5, 160.0, 250.25, 339.0, 339.9,
                      345.0]])
    ind, frac = jsetcoef._planck_index(jnp.asarray(temp))
    ref = jsetcoef._interp_planck(jnp.asarray(pair["jm"].static_np[
        "totplnk"]), ind, frac)
    got = setcoef.interp_planck_blocked(torch.as_tensor(temp), tot)
    assert_rel(got, np.asarray(ref).transpose(0, 2, 1))


def _radii():
    """Effective radii across both tables, the clamps and the index
    special cases (ice index == nmax, liquid index 0 and 58)."""
    reic = np.concatenate([np.linspace(1.0, 150.0, 57),
                           [2.0, 5.0, 131.0, 140.0, 3 * 43 + 2.0,
                            3 * 46 + 2.0, 3 * 46 + 2.5]])
    relq = np.concatenate([np.linspace(0.5, 65.0, 57),
                           [1.5, 2.0, 2.5, 59.5, 60.0, 59.9, 61.0]])
    return reic.reshape(8, 8), relq.reshape(8, 8)


@pytest.mark.parametrize("iceflag", [2, 3])
def test_cloud_coeffs_plain_match_jax(pair, iceflag):
    reic, relq = _radii()
    static_np = pair["jm"].static_np
    ji, jl, jok = jcldprop._ice_liq_coeffs(
        jnp.asarray(reic), jnp.asarray(relq), iceflag, 1, static_np,
        jnp.float64)
    static = pair["tm"].static_tensors()
    ti, tl, tok = cldprop._ice_liq_coeffs(torch.as_tensor(reic),
                                          torch.as_tensor(relq), iceflag, 1,
                                          static)
    assert_rel(ti, ji, name="abscoice")
    assert_rel(tl, jl, name="abscoliq")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not tok.all() and tok.any()

    # the blocked (L, 16, B) form the RT sweep reads
    clouds = McicaCloudsCompact(None, None, None, torch.as_tensor(reic),
                                torch.as_tensor(relq))
    ai, al, ok = cldprop.cloud_optics_bands_blocked(
        clouds, static, iceflag=iceflag, liqflag=1)
    jclouds = jsyn.make_mcica_clouds(8, 8, layout="compact")._replace(
        reicmc=jnp.asarray(reic), relqmc=jnp.asarray(relq))
    jai, jal, jok2 = jcldprop.cloud_optics_bands_blocked(
        jclouds, static_np, iceflag=iceflag, liqflag=1, use_pallas=False)
    assert_rel(ai, jai)
    assert_rel(al, jal)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok2))


def test_cloud_coeffs_unported_flags_raise(pair):
    reic, relq = (torch.full((2, 3), 20.0) for _ in range(2))
    static = pair["tm"].static_tensors()
    for ice, liq in ((0, 1), (1, 1), (3, 0)):
        with pytest.raises(NotImplementedError):
            cldprop._ice_liq_coeffs(reic, relq, ice, liq, static)


def _band_slices():
    from rrtmg_lw_torch.ops.taumol import NG
    ofs = np.concatenate([[0], np.cumsum(NG)])
    return {b: slice(ofs[b - 1], ofs[b]) for b in range(1, 17)}


@pytest.mark.parametrize("case", ["plain", "chi_slot"])
def test_taumol_plain_matches_jax(pair, case):
    """Every band and region; "chi_slot" boosts CO2/N2O/CH4 past the
    minor-gas over-abundance thresholds, so the adjustment branch with
    the chi_mls(gas, jp+1) reference is taken (taumol.f90:548)."""
    jprof, tprof = pair["jprof"], pair["tprof"]
    jm, tm = pair["jm"], pair["tm"]
    if case == "chi_slot":
        boost = np.asarray(K5_BOOST)
        jprof = jprof._replace(wkl=jprof.wkl * boost)
        tprof = tprof._replace(wkl=tprof.wkl * torch.as_tensor(boost))
        jsc = jsetcoef.setcoef(jprof, jm.static)
        tsc = setcoef.setcoef(tprof, tm.static_tensors())
    else:
        jsc, tsc = pair["jsc"], pair["tsc"]
    jt, jf = jm.engine(jsc, jprof)
    tt, tf = tm.engine(tsc, tprof)
    jt, jf = np.asarray(jt), np.asarray(jf)
    upper = ~tsc.laytrop_mask.numpy()
    assert upper.any() and (~upper).any()
    for b, sl in _band_slices().items():
        assert_rel(tt[..., sl], jt[..., sl], name=f"taug band {b}")
        assert_rel(tf[..., sl], jf[..., sl], name=f"fracs band {b}")
    # band 16 upper: nspb(16)=0 pins the absb rows (taumol.f90:195-196)
    sl = _band_slices()[16]
    assert_rel(tt.numpy()[upper][:, sl], jt[upper][:, sl])
    # the kernel layout and the bins the kernel must reproduce
    tg_t, fr_t = tm.engine.blocked(tsc, tprof)
    assert torch.equal(tg_t, tt.permute(1, 2, 0))
    bins = tm.engine.bins(tsc, tprof)
    assert bins.shape == (16, 4, L, B) and bins.dtype == torch.int32
    assert (bins[11, :, upper.T] == -1).all()      # band 12 upper is zero


@pytest.mark.parametrize("ncol,nlay", [(33, 60), (77, 1)])
def test_taumol_plain_matches_jax_on_k2_edge_inputs(pair, ncol, nlay):
    """K2's edge inputs (``snapshot.k2_edge_args``: columns all lower, all
    upper or switching at laytrop, rows clipped at the table's last row,
    minor gases on both sides of their over-abundance threshold), widened
    to float64, through the port's plain taumol and the JAX package's."""
    from rrtmg_lw_tpu.types import Profile as JProfile
    from rrtmg_lw_tpu.types import SetcoefOut as JSetcoefOut
    from rrtmg_lw_torch.ops.taumol_cuda import _unpack_inputs
    from rrtmg_lw_torch.utils.snapshot import k2_edge_args
    jm, tm = pair["jm"], pair["tm"]
    m32 = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                              use_lut=False), device="cpu",
                     tables=tables_from_numpy(jm.ktables, jm.static_np,
                                              device="cpu",
                                              dtype=torch.float32))
    fld, ifld, facts = k2_edge_args("cpu", m32, ncol, nlay)
    assert facts["lower_only"] and facts["upper_only"]
    assert facts["last_row"] and facts["n2o_over"] and facts["n2o_under"]
    if nlay > 1:
        assert facts["both"]
    tsc, tprof = _unpack_inputs(fld.double(), ifld)
    jsc = JSetcoefOut(**{k: None if v is None else jnp.asarray(v.numpy())
                         for k, v in tsc._asdict().items()})
    jprof = JProfile(**{k: None if v is None else jnp.asarray(v.numpy())
                        for k, v in tprof._asdict().items()})
    tt, tf = tm.engine(tsc, tprof)
    jt, jf = (np.asarray(x) for x in jm.engine(jsc, jprof))
    for b, sl in _band_slices().items():
        assert_rel(tt[..., sl], jt[..., sl], name=f"taug band {b}")
        assert_rel(tf[..., sl], jf[..., sl], name=f"fracs band {b}")


def _per_g_clouds(seed):
    rng = np.random.default_rng(seed)
    cldf = (rng.random((B, L, 140)) < 0.3).astype(np.float64)
    cldf[:, L // 2:] = 0.0                        # clear above mid-column
    odcld = rng.random((B, L, 140)) * 3.0
    return cldf, odcld


@pytest.mark.parametrize("cloudy", [False, True])
def test_rt_plain_matches_jax(pair, cloudy):
    jm, jsc, jprof = pair["jm"], pair["jsc"], pair["jprof"]
    tm, tsc, tprof = pair["tm"], pair["tsc"], pair["tprof"]
    jt, jf = jm.engine(jsc, jprof)
    taut = np.asarray(jt) + 0.01
    cldf, odcld = _per_g_clouds(5) if cloudy else \
        (np.zeros((B, L, 140)),) * 2
    gate = cldf >= 0.5
    ref = jrtrn.rt_random_overlap(
        jnp.asarray(taut), jf, jsc.planklay, jsc.planklev, jsc.plankbnd,
        jsc.dplankbnd_dt, jprof.semiss, jprof.pwvcm, jprof.pz,
        jnp.asarray(cldf), jnp.asarray(odcld),
        cloudy_lay=jnp.asarray(gate.any(-1)), cld_gate=jnp.asarray(gate),
        static=jm.static_np, luts=None, use_lut=False,
        heatfac_val=jm.heatfac)
    t = torch.as_tensor
    got = rtrn.rt_random_overlap(
        t(taut), t(np.array(jf)), tsc.planklay, tsc.planklev, tsc.plankbnd,
        tprof.semiss, tprof.pwvcm, tprof.pz, t(cldf), t(odcld),
        cloudy_lay=t(gate.any(-1)), cld_gate=t(gate), static=tm.static_np,
        heatfac_val=tm.heatfac)
    for name in got._fields:
        assert_rel(getattr(got, name), getattr(ref, name), name=name)
    if cloudy:                      # the clear twin leaves the cloudy stream
        assert not np.allclose(np.asarray(ref.totuflux),
                               np.asarray(ref.totuclfl))


def test_rt_sweep_plain_compact_matches_jax(pair):
    """The plain version of the RT kernel on its own layouts with the
    compact McICA fields, against the JAX path for the same clouds
    (compact -> per-g products -> cldprmc -> rt_random_overlap)."""
    jm, jsc, jprof = pair["jm"], pair["jsc"], pair["jprof"]
    tm, tsc, tprof = pair["tm"], pair["tsc"], pair["tprof"]
    jcl = jsyn.make_mcica_clouds(B, L, layout="compact", mask_dtype=np.int8)
    tcl = McicaCloudsCompact.from_numpy(
        tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8), "cpu")
    jt, jf = jm.engine(jsc, jprof)
    jtaut = jt + jprof.taua[..., jm.ngb0]
    batch = jcl.to_blocked().to_batch()
    taucmc, _ = jcldprop.cldprmc(batch, jm.static_np, inflag=2, iceflag=3,
                                 liqflag=1)
    gate = batch.cldfmc >= 0.5
    ref = jrtrn.rt_random_overlap(
        jtaut, jf, jsc.planklay, jsc.planklev, jsc.plankbnd,
        jsc.dplankbnd_dt, jprof.semiss, jprof.pwvcm, jprof.pz, batch.cldfmc,
        taucmc, cloudy_lay=gate.any(-1), cld_gate=gate,
        static=jm.static_np, luts=None, use_lut=False,
        heatfac_val=jm.heatfac)

    def blocked(x):
        return torch.as_tensor(np.array(x)).permute(1, 2, 0).contiguous()

    abi, abl, _ = cldprop.cloud_optics_bands_blocked(
        tcl, tm.static_tensors(), iceflag=3, liqflag=1)
    cw = torch.stack([tcl.ciwp.t(), tcl.clwp.t()], 1).contiguous()
    out = rtrn.rt_fluxes_blocked(
        blocked(jtaut), blocked(jf), blocked(jsc.planklay),
        blocked(jsc.planklev), tsc.plankbnd, tprof.semiss, tprof.pwvcm,
        tm.ngb0, tm.wg, (tcl.cldfmc, cw, abi, abl))
    assert out.shape == (4, L + 1, B)
    for i, name in enumerate(("totuflux", "totdflux", "totuclfl",
                              "totdclfl")):
        assert_rel(out[i].t(), getattr(ref, name), name=name)


@pytest.mark.parametrize("cloudy", [False, True])
def test_rt_sweep_plain_radiances_are_the_summed_ones(pair, cloudy):
    """The plain per-g radiances of ``rt_sweep_blocked(...,
    radiances=True)``, what K1 keeps for K6: weighted by wg and summed
    over g they are the flux rows at levels 0..L-1 (row D the down flux,
    U the up flux, rows 2-3 the clear ones), whose fluxes equal the JAX
    package's rt_random_overlap (the composition of
    test_rt_sweep_plain_compact_matches_jax; clear: no clouds); row U at
    level 0 is the surface source plus the reflected row D there."""
    jm, jsc, jprof = pair["jm"], pair["jsc"], pair["jprof"]
    tm, tsc, tprof = pair["tm"], pair["tsc"], pair["tprof"]
    jt, jf = jm.engine(jsc, jprof)
    jtaut = jt + jprof.taua[..., jm.ngb0]
    fields = None
    cldf = odcld = jnp.zeros(jtaut.shape)
    if cloudy:
        jcl = jsyn.make_mcica_clouds(B, L, layout="compact",
                                     mask_dtype=np.int8)
        batch = jcl.to_blocked().to_batch()
        cldf = batch.cldfmc
        odcld, _ = jcldprop.cldprmc(batch, jm.static_np, inflag=2,
                                    iceflag=3, liqflag=1)
        tcl = McicaCloudsCompact.from_numpy(
            tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8), "cpu")
        abi, abl, _ = cldprop.cloud_optics_bands_blocked(
            tcl, tm.static_tensors(), iceflag=3, liqflag=1)
        cw = torch.stack([tcl.ciwp.t(), tcl.clwp.t()], 1).contiguous()
        fields = (tcl.cldfmc, cw, abi, abl)
    gate = cldf >= 0.5
    ref = jrtrn.rt_random_overlap(
        jtaut, jf, jsc.planklay, jsc.planklev, jsc.plankbnd,
        jsc.dplankbnd_dt, jprof.semiss, jprof.pwvcm, jprof.pz, cldf, odcld,
        cloudy_lay=gate.any(-1), cld_gate=gate, static=jm.static_np,
        luts=None, use_lut=False, heatfac_val=jm.heatfac)

    def blocked(x):
        return torch.as_tensor(np.array(x)).permute(1, 2, 0).contiguous()

    fracs_t = blocked(jf)
    surf = rtrn.surf_rows(tsc.plankbnd, tprof.semiss, tprof.pwvcm,
                          torch.float64)
    fl, rads = rtrn.rt_sweep_blocked(
        blocked(jtaut), fracs_t, blocked(jsc.planklay),
        blocked(jsc.planklev), surf, tm.ngb0, tm.wg, fields, radiances=True)
    assert rads.shape == (4 if cloudy else 2, L, 140, B)
    assert torch.equal(fl, rtrn.rt_sweep_blocked(
        blocked(jtaut), fracs_t, blocked(jsc.planklay),
        blocked(jsc.planklev), surf, tm.ngb0, tm.wg, fields))
    for i, name in enumerate(("totuflux", "totdflux", "totuclfl",
                              "totdclfl")):
        assert_rel(fl[i].t(), getattr(ref, name), name=name)
    summed = torch.einsum("rlgb,g->rlb", rads, tm.wg)
    for r, row in enumerate((1, 0, 3, 2)[:rads.shape[0]]):
        assert_rel(summed[r], fl[row, :L], name=f"row {r}")
    ngb = tm.ngb0.long()
    rad0 = fracs_t[0] * surf[2][ngb]
    reflect = 1.0 - surf[1][ngb]
    for d, u in ((0, 1), (2, 3))[:rads.shape[0] // 2]:
        assert_rel(rads[u, 0], rad0 + reflect * rads[d, 0], name=f"U {u}")
    if cloudy:                      # the clear twins leave the cloudy stream
        assert not torch.allclose(rads[0], rads[2])


def test_rt_lut_unported(pair):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rtrn._gas_factors(torch.ones(3), use_lut=True)


def overlap_patterns():
    """(8, 12) cloud fractions: contiguous blocks rising, falling and
    equal, cldfrac 1.0, values on both sides of the 1e-6 gate, a clear
    column, a column cloudy in every layer, random blocks."""
    rng = np.random.default_rng(11)
    cf = np.zeros((8, 12))
    cf[0, 2:6] = [0.2, 0.4, 0.6, 0.8]                 # rising
    cf[0, 8:11] = [0.9, 0.5, 0.1]                     # falling
    cf[1, 1:9] = [0.2, 0.4, 0.6, 0.8, 1.0, 0.7, 0.5, 0.3]
    cf[2, 3:7] = 0.5                                  # equal
    cf[2, 9:11] = 1.0
    cf[3, :] = 1.0                                    # overcast
    cf[4, 2:7] = [1e-6, 0.3, 9.99e-7, 1e-6, 0.4]      # on the gate
    # cf[5] clear
    cf[6, :] = 0.05 + 0.9 * rng.random(12)            # cloudy everywhere
    cf[7, [0, 2, 3, 5, 11]] = [0.4, 0.6, 0.1, 1.0, 0.3]
    return cf


def test_overlap_factors_match_jax():
    cf = overlap_patterns()
    cloudy = cf >= 1e-6
    for jf, tf in ((jrtrnmr._overlap_factors_up, rtrnmr.overlap_factors_up),
                   (jrtrnmr._overlap_factors_down,
                    rtrnmr.overlap_factors_down)):
        jfacs, jist = jf(jnp.asarray(cf), jnp.asarray(cloudy))
        tfacs, tist = tf(torch.as_tensor(cf), torch.as_tensor(cloudy))
        np.testing.assert_array_equal(tist.numpy(), np.asarray(jist))
        assert len(tfacs) == len(jfacs) == 6
        for t, j in zip(tfacs, jfacs):
            assert np.abs(t.numpy() - np.asarray(j)).max() <= 1e-14
        assert any(np.asarray(j).any() for j in jfacs)


def test_overlap_rows_match_jax_rows16():
    """The (L, 16, B) rows against the stack rt_maxrandom_pallas builds
    (rtrn_pallas.py:1155-1166) from the JAX pre-passes."""
    cf = overlap_patterns()
    cloudy = jnp.asarray(cf >= 1e-6)
    up, istcld = jrtrnmr._overlap_factors_up(jnp.asarray(cf), cloudy)
    dn, istcldd = jrtrnmr._overlap_factors_down(jnp.asarray(cf), cloudy)
    iclddn = jnp.flip(jnp.cumsum(jnp.flip(cloudy.astype(jnp.int32), 1), 1),
                      1) > 0
    rows = [jnp.asarray(cf), istcld, istcldd, iclddn, *dn, *up]
    ref = np.stack([np.asarray(r, np.float64).T for r in rows], axis=1)
    got = rtrnmr.overlap_rows(torch.as_tensor(cf))
    assert got.shape == (12, 16, 8)
    np.testing.assert_array_equal(got[:, :4].numpy(), ref[:, :4])
    assert np.abs(got.numpy() - ref).max() <= 1e-14


def band_clouds_np(B, Lc, seed=4):
    """make_band_clouds with the fractions varied inside the decks (so
    both overlap regimes occur), an overcast deck, in-cloud od for
    inflag 0 and radii across the table ranges."""
    bc = jsyn.make_band_clouds(B, Lc)
    rng = np.random.default_rng(seed)
    cf = bc.cldfrac * (0.6 + 0.4 * rng.random(bc.cldfrac.shape))
    cf[0, 2:5] = 1.0
    return bc._replace(
        cldfrac=cf, tauc=rng.random((B, Lc, 16)) * (cf[..., None] > 0),
        reic=5.0 + 130.0 * rng.random((B, Lc)),
        relq=2.5 + 57.5 * rng.random((B, Lc)))


@pytest.mark.parametrize("inflag,iceflag", [(0, 3), (1, 3), (2, 2), (2, 3)])
def test_cldprop_matches_jax(pair, inflag, iceflag):
    nbc = band_clouds_np(B, L)
    jbc = type(nbc)(*(jnp.asarray(x) for x in nbc))
    tbc = BandClouds.from_numpy(nbc, "cpu")
    static = pair["tm"].static_tensors()
    kw = dict(inflag=inflag, iceflag=iceflag, liqflag=1)
    jt, jok = jcldprop.cldprop(jbc, pair["jm"].static_np, **kw)
    tt, tok = cldprop.cldprop(tbc, static, **kw)
    assert_rel(tt, jt, tol=1e-14)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    jb, jokb = jcldprop.cldprop_banded_blocked(jbc, pair["jm"].static_np,
                                               **kw)
    tb, tokb = cldprop.cldprop_banded_blocked(tbc, static, **kw)
    assert tb.shape == (L, 16, B) and tb.is_contiguous()
    assert_rel(tb, jb, tol=1e-14)
    np.testing.assert_array_equal(tokb.numpy(), np.asarray(jokb))
    assert float(tt.abs().max()) > 0


def test_cldprop_ncbands_configs_raise(pair):
    tbc = BandClouds.from_numpy(band_clouds_np(2, 4), "cpu")
    static = pair["tm"].static_tensors()
    for ice, liq in ((0, 1), (1, 1), (3, 0)):
        assert not cldprop.cloud_bands_static(2, ice, liq)
        for fn in (cldprop.cldprop, cldprop.cldprop_banded_blocked):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                fn(tbc, static, inflag=2, iceflag=ice, liqflag=liq)


@pytest.mark.parametrize("mode", ["banded", "maxrand"])
def test_rt_band_sweeps_plain_match_jax(pair, mode):
    """The plain banded / maxrand sweeps in the kernel layouts (and the
    port's (B, L, G) rt_maxrandom) against the JAX package's
    rt_random_overlap / rt_maxrandom on the same clouds."""
    jm, jsc, jprof = pair["jm"], pair["jsc"], pair["jprof"]
    tm, tsc, tprof = pair["tm"], pair["tsc"], pair["tprof"]
    nbc = band_clouds_np(B, L)
    jbc = type(nbc)(*(jnp.asarray(x) for x in nbc))
    tbc = BandClouds.from_numpy(nbc, "cpu")
    jt, jf = jm.engine(jsc, jprof)
    jtaut = jt + jprof.taua[..., jm.ngb0]
    taucloud, _ = jcldprop.cldprop(jbc, jm.static_np, inflag=2, iceflag=3,
                                   liqflag=1)
    odcld_g = taucloud[..., jm.ngb0]
    args = (jtaut, jf, jsc.planklay, jsc.planklev, jsc.plankbnd,
            jsc.dplankbnd_dt, jprof.semiss, jprof.pwvcm, jprof.pz)
    kw = dict(static=jm.static_np, luts=None, use_lut=False,
              heatfac_val=jm.heatfac)
    if mode == "banded":
        cldf_g = jnp.broadcast_to(jbc.cldfrac[..., None], odcld_g.shape)
        gate = cldf_g >= 1e-6
        ref = jrtrn.rt_random_overlap(*args, cldf_g, odcld_g,
                                      cloudy_lay=gate.any(-1), cld_gate=gate,
                                      **kw)
    else:
        ref = jrtrnmr.rt_maxrandom(*args, jbc.cldfrac, odcld_g, **kw)
        t = torch.as_tensor
        got = rtrnmr.rt_maxrandom(
            t(np.array(jtaut)), t(np.array(jf)), tsc.planklay, tsc.planklev,
            tsc.plankbnd, tprof.semiss, tprof.pwvcm, tprof.pz, tbc.cldfrac,
            t(np.array(odcld_g)), static=tm.static_np, heatfac_val=tm.heatfac)
        for name in got._fields:
            # heating rates divide flux differences (~1e-13 of reordered
            # g sums) by the thin top layers' dp
            tol = 1e-10 if name in ("htr", "htrc") else RTOL
            assert_rel(getattr(got, name), getattr(ref, name), tol, name)

    def blocked(x):
        return torch.as_tensor(np.array(x)).permute(1, 2, 0).contiguous()

    taucb, _ = cldprop.cldprop_banded_blocked(tbc, tm.static_tensors(),
                                              inflag=2, iceflag=3, liqflag=1)
    cld = (tbc.cldfrac.t().contiguous() if mode == "banded"
           else rtrnmr.overlap_rows(tbc.cldfrac))
    fn = rtrn.rt_fluxes_banded if mode == "banded" else rtrn.rt_fluxes_maxrand
    out = fn(blocked(jtaut), blocked(jf), blocked(jsc.planklay),
             blocked(jsc.planklev), tsc.plankbnd, tprof.semiss, tprof.pwvcm,
             tm.ngb0, tm.wg, cld, taucb)
    assert out.shape == (4, L + 1, B)
    for i, name in enumerate(("totuflux", "totdflux", "totuclfl",
                              "totdclfl")):
        assert_rel(out[i].t(), getattr(ref, name), name=name)
    # the clouds move the all-sky fluxes away from the clear twin
    assert not np.allclose(np.asarray(ref.totuflux), np.asarray(ref.totuclfl))


def mcica_per_g_np(B, Lc, seed=6, layout="batch"):
    """make_mcica_clouds with radii across and past the table ranges, an
    input
    cloud od taucmc nonzero in half the cloudy cells, and no ice in a
    tenth of the cells."""
    cl = jsyn.make_mcica_clouds(B, Lc, layout=layout)
    rng = np.random.default_rng(seed)
    cf = np.asarray(cl.cldfmc)
    tauc = cf * rng.random(cf.shape) * 2.0 * (rng.random(cf.shape) < 0.5)
    ciwp = np.where(rng.random(cf.shape) < 0.1, 0.0, np.asarray(cl.ciwpmc))
    return cl._replace(taucmc=tauc, ciwpmc=ciwp,
                       reicmc=1.0 + 149.0 * rng.random((B, Lc)),
                       relqmc=0.5 + 64.5 * rng.random((B, Lc)))


@pytest.mark.parametrize("inflag", [0, 2])
@pytest.mark.parametrize("layout", ["batch", "blocked"])
def test_cldprmc_matches_jax(pair, inflag, layout):
    """cldprmc (batch input) and cldprmc_blocked (batch and blocked
    input) against rrtmg_lw_tpu.ops.cldprop on the same per-g clouds."""
    from rrtmg_lw_torch import McicaClouds, McicaCloudsBlocked
    ncl = mcica_per_g_np(B, L, layout=layout)
    jcl = type(ncl)(*(jnp.asarray(x) for x in ncl))
    tcl = (McicaCloudsBlocked if layout == "blocked"
           else McicaClouds).from_numpy(ncl, "cpu")
    static = pair["tm"].static_tensors()
    kw = dict(inflag=inflag, iceflag=3, liqflag=1)
    jt, jcf, jok = jcldprop.cldprmc_blocked(jcl, pair["jm"].static_np, **kw)
    tt, tcf, tok = cldprop.cldprmc_blocked(tcl, static, **kw)
    assert tt.shape == tcf.shape == (L, 144, B) and tt.is_contiguous()
    assert_rel(tt, jt, tol=1e-14)
    np.testing.assert_array_equal(tcf.numpy(), np.asarray(jcf))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not tt[:, 140:].any()
    if layout == "batch":
        jt2, jok2 = jcldprop.cldprmc(jcl, pair["jm"].static_np, **kw)
        tt2, tok2 = cldprop.cldprmc(tcl, static, **kw)
        assert_rel(tt2, jt2, tol=1e-14)
        np.testing.assert_array_equal(tok2.numpy(), np.asarray(jok2))
        # the blocked relayout holds the same values
        assert torch.equal(tt[:, :140].permute(2, 0, 1), tt2)
    if inflag == 2:
        assert not tok.all() and float(tt.abs().max()) > 0
    with pytest.raises(ValueError, match="INFLAG=1"):
        cldprop.cldprmc_blocked(tcl, static, inflag=1, iceflag=3, liqflag=1)


def _rt_case(pair):
    """The JAX profile's taut, fracs and setcoef, and both packages'
    sweep arguments (B, L, G layouts)."""
    jm, jsc, jprof = pair["jm"], pair["jsc"], pair["jprof"]
    tm, tsc, tprof = pair["tm"], pair["tsc"], pair["tprof"]
    jt, jf = jm.engine(jsc, jprof)
    taut = np.array(jt + jprof.taua[..., jm.ngb0])
    jargs = (jnp.asarray(taut), jf, jsc.planklay, jsc.planklev, jsc.plankbnd,
             jsc.dplankbnd_dt, jprof.semiss, jprof.pwvcm, jprof.pz)
    t = torch.as_tensor
    targs = (t(taut), t(np.array(jf)), tsc.planklay, tsc.planklev,
             tsc.plankbnd, tprof.semiss, tprof.pwvcm, tprof.pz)
    return jargs, targs


@pytest.mark.parametrize("cloudy", [False, True])
def test_rt_idrv_matches_jax(pair, cloudy):
    """rt_random_overlap at idrv=1: every RTOut field, the two d/dT
    fields included, against the JAX package's."""
    jm, tm, tsc = pair["jm"], pair["tm"], pair["tsc"]
    jargs, targs = _rt_case(pair)
    cldf, odcld = _per_g_clouds(5) if cloudy else \
        (np.zeros((B, L, 140)),) * 2
    gate = cldf >= 0.5
    ref = jrtrn.rt_random_overlap(
        *jargs, jnp.asarray(cldf), jnp.asarray(odcld),
        cloudy_lay=jnp.asarray(gate.any(-1)), cld_gate=jnp.asarray(gate),
        static=jm.static_np, luts=None, use_lut=False, idrv=1,
        heatfac_val=jm.heatfac)
    t = torch.as_tensor
    got = rtrn.rt_random_overlap(
        *targs, t(cldf), t(odcld), cloudy_lay=t(gate.any(-1)),
        cld_gate=t(gate), static=tm.static_np, heatfac_val=tm.heatfac,
        idrv=1, dplankbnd_dt=tsc.dplankbnd_dt)
    assert got.dtotuflux_dt is not None and len(got) == len(ref) == 8
    for name in got._fields:
        # heating rates: reordered g sums over the thin top layers' dp
        tol = 1e-10 if name in ("htr", "htrc") else RTOL
        assert_rel(getattr(got, name), getattr(ref, name), tol, name)
    # the clear twin's derivative leaves the all-sky one under clouds
    d, dc = np.asarray(ref.dtotuflux_dt), np.asarray(ref.dtotuclfl_dt)
    assert np.allclose(d, dc) != cloudy
    assert (d > 0).all()


def test_rt_maxrandom_idrv_matches_jax(pair):
    jm, tm, tsc = pair["jm"], pair["tm"], pair["tsc"]
    jargs, targs = _rt_case(pair)
    nbc = band_clouds_np(B, L)
    taucloud, _ = jcldprop.cldprop(type(nbc)(*(jnp.asarray(x) for x in nbc)),
                                   jm.static_np, inflag=2, iceflag=3,
                                   liqflag=1)
    odcld_g = np.array(taucloud[..., jm.ngb0])
    ref = jrtrnmr.rt_maxrandom(*jargs, jnp.asarray(nbc.cldfrac),
                               jnp.asarray(odcld_g), static=jm.static_np,
                               luts=None, use_lut=False, idrv=1,
                               heatfac_val=jm.heatfac)
    got = rtrnmr.rt_maxrandom(*targs, torch.as_tensor(nbc.cldfrac),
                              torch.as_tensor(odcld_g), static=tm.static_np,
                              heatfac_val=tm.heatfac, idrv=1,
                              dplankbnd_dt=tsc.dplankbnd_dt)
    assert len(got) == len(ref) == 8
    for name in got._fields:
        tol = 1e-10 if name in ("htr", "htrc") else RTOL
        assert_rel(getattr(got, name), getattr(ref, name), tol, name)
    assert not np.allclose(np.asarray(ref.dtotuflux_dt),
                           np.asarray(ref.dtotuclfl_dt))


@pytest.mark.parametrize("inflag", [0, 2])
def test_rt_sweep_plain_per_g_modes_match_jax(pair, inflag):
    """The plain versions of K1's fused (inflag=2) and cldf-odcld
    (inflag=0) modes on the kernel layouts, idrv 0 and 1, against the
    JAX package's cldprmc + rt_random_overlap on the same per-g
    clouds."""
    from rrtmg_lw_torch import McicaCloudsBlocked
    jm, tm, tsc, tprof = pair["jm"], pair["tm"], pair["tsc"], pair["tprof"]
    jargs, _ = _rt_case(pair)
    nblk = mcica_per_g_np(B, L, layout="blocked")
    jbatch = type(nblk)(*(jnp.asarray(x) for x in nblk)).to_batch()
    taucmc, _ = jcldprop.cldprmc(jbatch, jm.static_np, inflag=inflag,
                                 iceflag=3, liqflag=1)
    gate = jbatch.cldfmc >= 0.5
    ref = jrtrn.rt_random_overlap(
        *jargs, jbatch.cldfmc, taucmc, cloudy_lay=gate.any(-1),
        cld_gate=gate, static=jm.static_np, luts=None, use_lut=False,
        idrv=1, heatfac_val=jm.heatfac)

    def blocked(x):
        return torch.as_tensor(np.array(x)).permute(1, 2, 0).contiguous()

    tblk = McicaCloudsBlocked.from_numpy(nblk, "cpu")
    static = tm.static_tensors()
    if inflag == 2:
        abi, abl, _ = cldprop.cloud_optics_bands_blocked(
            tblk, static, iceflag=3, liqflag=1)
        fields = (*tblk[:4], abi, abl)
    else:
        tauc, cldf, _ = cldprop.cldprmc_blocked(tblk, static, inflag=0,
                                                iceflag=3, liqflag=1)
        fields = (cldf, tauc)
    args = (blocked(jargs[0]), blocked(jargs[1]), blocked(jargs[2]),
            blocked(jargs[3]), tsc.plankbnd, tprof.semiss, tprof.pwvcm,
            tm.ngb0, tm.wg, fields)
    out0 = rtrn.rt_fluxes_blocked(*args)
    out, ddt = rtrn.rt_fluxes_blocked(*args, dplankbnd_dt=tsc.dplankbnd_dt)
    assert out.shape == (4, L + 1, B) and ddt.shape == (2, L + 1, B)
    assert torch.equal(out, out0)
    for i, name in enumerate(("totuflux", "totdflux", "totuclfl",
                              "totdclfl", "dtotuflux_dt", "dtotuclfl_dt")):
        assert_rel(torch.cat([out, ddt])[i].t(), getattr(ref, name),
                   name=name)
    assert not np.allclose(np.asarray(ref.totuflux),
                           np.asarray(ref.totuclfl))


@pytest.mark.parametrize("Be", [37, 64])
def test_rt_sweep_plain_edge_cases_match_jax(pair, Be):
    """The plain cldf-odcld sweep (K1's per-g layout) at idrv 0 and 1 on
    K1's edge cases (``utils.snapshot.make_edge_clouds``): clear,
    overcast and top-and-bottom-cloudy columns in runs across the
    kernel's 16-column tiles, per-g cloud fractions in (0, 0.5), and the
    g-point od exactly 0.06 (where the gas and total-sky factors take
    different branches) and 0, against the JAX package's
    rt_random_overlap on the same inputs."""
    from rrtmg_lw_torch.utils.snapshot import EDGE_KINDS, make_edge_clouds
    jm, tm = pair["jm"], pair["tm"]
    natm = jsyn.make_atmosphere(Be, L, seed=Be)
    jprof = jinatm(natm, dtype=jnp.float64)
    jsc = jsetcoef.setcoef(jprof, jm.static)
    tprof = inatm(Atmosphere.from_numpy(tsyn.make_atmosphere(Be, L, seed=Be),
                                        "cpu"))
    tsc = setcoef.setcoef(tprof, tm.static_tensors())
    jt, jf = jm.engine(jsc, jprof)
    taut = np.array(jt + jprof.taua[..., jm.ngb0])          # (B, L, G)
    e = {k: v.astype(np.float64) if v.dtype == np.float32 else v
         for k, v in make_edge_clouds(Be, L, seed=Be).items()}
    kinds = set(e["kind"].tolist())
    assert kinds == set(range(len(EDGE_KINDS)))
    runs = np.flatnonzero(np.diff(e["kind"])) + 1            # run starts
    assert (runs % 16 != 0).any()
    # od = secd x taut exactly 0.06 in every 13th element, where both
    # packages' diffusivity secants agree; 0 in every 17th
    secd = np.array(jrtrn.secdiff(jprof.pwvcm, jnp.float64))[:, jm.ngb0]
    same = secd == rtrn.secdiff(tprof.pwvcm, torch.float64)[
        :, tm.ngb0.long()].numpy()
    t06 = np.broadcast_to((0.06 / secd)[:, None, :], taut.shape).copy()
    for _ in range(2):
        p = secd[:, None, :] * t06
        t06 = np.where(p > 0.06, np.nextafter(t06, 0.0),
                       np.where(p < 0.06, np.nextafter(t06, 1.0), t06))
    idx = np.arange(taut.size).reshape(taut.shape)
    hit = (idx % 13 == 0) & same[:, None, :] & (secd[:, None, :] * t06
                                                == 0.06)
    taut = np.where(hit, t06, taut)
    taut[idx % 17 == 0] = 0.0
    cf = e["cldf_g"][:, :140].transpose(2, 0, 1)             # (B, L, G)
    od = e["tauc_g"][:, :140].transpose(2, 0, 1)
    assert (hit & (cf > 0) & (cf < 0.5)).sum() > 0
    gate = cf >= 0.5
    ref = jrtrn.rt_random_overlap(
        jnp.asarray(taut), jf, jsc.planklay, jsc.planklev, jsc.plankbnd,
        jsc.dplankbnd_dt, jprof.semiss, jprof.pwvcm, jprof.pz,
        jnp.asarray(cf), jnp.asarray(od), cloudy_lay=jnp.asarray(gate.any(-1)),
        cld_gate=jnp.asarray(gate), static=jm.static_np, luts=None,
        use_lut=False, idrv=1, heatfac_val=jm.heatfac)

    def blocked(x):
        return torch.as_tensor(np.array(x)).permute(1, 2, 0).contiguous()

    fields = (torch.as_tensor(e["cldf_g"]), torch.as_tensor(e["tauc_g"]))
    args = (blocked(taut), blocked(jf), blocked(jsc.planklay),
            blocked(jsc.planklev), tsc.plankbnd, tprof.semiss, tprof.pwvcm,
            tm.ngb0, tm.wg, fields)
    out0 = rtrn.rt_fluxes_blocked(*args)
    out, ddt = rtrn.rt_fluxes_blocked(*args, dplankbnd_dt=tsc.dplankbnd_dt)
    assert torch.equal(out, out0)
    for i, name in enumerate(("totuflux", "totdflux", "totuclfl",
                              "totdclfl", "dtotuflux_dt", "dtotuclfl_dt")):
        assert_rel(torch.cat([out, ddt])[i].t(), getattr(ref, name),
                   name=name)
    # the clear columns' all-sky fluxes are their clear-sky ones; the
    # overcast ones' are not
    up, upc = np.asarray(ref.totuflux), np.asarray(ref.totuclfl)
    assert np.array_equal(up[e["kind"] == 0], upc[e["kind"] == 0])
    assert not np.allclose(up[e["kind"] == 1], upc[e["kind"] == 1])


def test_duflx_dt_is_the_derivative_wrt_the_surface_source(pair):
    """An independent witness of the d/dT recursion: in clear sky the
    derivative of uflx along plankbnd in the direction dplankbnd_dt
    (forward-mode AD through the plain sweep) is duflx_dt."""
    tm, tsc = pair["tm"], pair["tsc"]
    _, targs = _rt_case(pair)
    taut, fracs, play, plev, plankbnd, semiss, pwvcm, pz = targs
    zero = torch.zeros_like(taut)
    kw = dict(cloudy_lay=torch.zeros((B, L), dtype=torch.bool),
              cld_gate=zero.bool(), static=tm.static_np,
              heatfac_val=tm.heatfac)

    def uflx(pb):
        return rtrn.rt_random_overlap(taut, fracs, play, plev, pb, semiss,
                                      pwvcm, pz, zero, zero, **kw).totuflux

    _, jvp = torch.func.jvp(uflx, (plankbnd,), (tsc.dplankbnd_dt,))
    got = rtrn.rt_random_overlap(taut, fracs, play, plev, plankbnd, semiss,
                                 pwvcm, pz, zero, zero, idrv=1,
                                 dplankbnd_dt=tsc.dplankbnd_dt, **kw)
    assert_rel(got.dtotuflux_dt, jvp.numpy())
    assert_rel(got.dtotuclfl_dt, jvp.numpy())
    assert float(jvp.abs().max()) > 0


# ---- the spectral-storage codec (RRTMG_SPEC_DTYPE) against JAX ----

@pytest.fixture(scope="module")
def codec_inputs():
    """float32 taug and fracs values: the grid of
    tests/test_taumol_pallas.py:146-148 plus the JAX XLA engine's taug
    (and fracs) on a seeded small atmosphere, and the JAX model."""
    jm = jmake_model(JConfig(dtype="float32", use_lut=False,
                             taumol_impl="xla", rt_impl="xla"))
    jprof = jinatm(jsyn.make_atmosphere(B, L), dtype=jnp.float32)
    tg, fr = jm.engine(jsetcoef.setcoef(jprof, jm.static), jprof)
    grid = np.concatenate([[0.0, -1e-9, 5e-10, 1e-9],
                           np.geomspace(2e-9, 3.9, 4000)])
    x = np.concatenate([grid, np.asarray(tg).ravel()]).astype(np.float32)
    f = np.concatenate([np.linspace(0.0, 1.0, 1000),
                        np.asarray(fr).ravel()]).astype(np.float32)
    return jm, x, f


def _codes(u):
    """uint16 codes of either package -> int64 numpy."""
    if isinstance(u, torch.Tensor):
        return (u.view(torch.int16).numpy().view(np.uint16)
                .astype(np.int64))
    return np.asarray(u).astype(np.int64)


def test_spec_codec_logu16_matches_jax(codec_inputs):
    from rrtmg_lw_tpu.ops import taumol_pallas as jtp
    from rrtmg_lw_torch.ops import spec_codec
    _, x, f = codec_inputs
    got = spec_codec.spec_encode_taug(torch.from_numpy(x))
    assert got.dtype == torch.uint16
    uj = _codes(jtp.spec_encode_taug(jnp.asarray(x)))
    ut = _codes(got)
    off = np.abs(uj - ut)
    print(f"logu16 codes one apart: {(off != 0).sum()} of {off.size}")
    assert off.max() <= 1 and (off != 0).sum() <= 1e-4 * off.size
    assert (ut[x <= np.float32(1e-9)] == 0).all() and (ut[x > 1e-9] > 0).all()
    # decodes of the same codes within one ulp
    dj = np.asarray(jtp.spec_decode_taug(jnp.asarray(uj.astype(np.uint16))))
    dt = spec_codec.spec_decode_taug(got).numpy()
    same = off == 0
    assert dt.dtype == np.float32
    assert (np.abs(dt - dj)[same] <= np.spacing(np.abs(dj))[same]).all()
    np.testing.assert_array_equal(dt[ut == 0], 0.0)
    np.testing.assert_array_equal(
        _codes(spec_codec.spec_encode_frac(torch.from_numpy(f))),
        _codes(jtp.spec_encode_frac(jnp.asarray(f))))
    fu = spec_codec.spec_encode_frac(torch.from_numpy(f))
    np.testing.assert_array_equal(
        spec_codec.spec_decode_frac(fu).numpy(),
        np.asarray(jtp.spec_decode_frac(jnp.asarray(_codes(fu).astype(
            np.uint16)))))
    # spec_load_* route codes to the decodes and upcast the rest
    assert torch.equal(spec_codec.spec_load_taut(got),
                       spec_codec.spec_decode_taug(got))
    assert torch.equal(spec_codec.spec_load_frac(fu),
                       spec_codec.spec_decode_frac(fu))


@pytest.mark.parametrize("spec", ["bf16", "f16"])
def test_spec_codec_casts_match_jax(codec_inputs, spec):
    from rrtmg_lw_tpu.ops import taumol_pallas as jtp
    from rrtmg_lw_torch.ops import spec_codec
    _, x, f = codec_inputs
    tdt = spec_codec.SPEC_DTYPES[spec]
    jdt = {"bf16": jnp.bfloat16, "f16": jnp.float16}[spec]
    for v, which in ((x, "tg"), (f, "fr")):
        got = spec_codec.spec_store(torch.from_numpy(v), tdt, which)
        ref = jnp.asarray(v).astype(jdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
        load = (spec_codec.spec_load_taut if which == "tg"
                else spec_codec.spec_load_frac)
        jload = jtp.spec_load_taut if which == "tg" else jtp.spec_load_frac
        np.testing.assert_array_equal(load(got).numpy(),
                                      np.asarray(jload(ref)))


def test_spec_dtype_env_matches_jax(codec_inputs, monkeypatch):
    """RRTMG_SPEC_DTYPE: the JAX package's values, and its ValueError
    word for word for any other."""
    from rrtmg_lw_tpu.ops.taumol_pallas import PallasTaumol
    from rrtmg_lw_torch.ops import spec_codec
    jm = codec_inputs[0]
    want = {"": torch.float32, "f32": torch.float32,
            "bf16": torch.bfloat16, "f16": torch.float16,
            "logu16": torch.uint16}
    for value, dt in want.items():
        monkeypatch.setenv("RRTMG_SPEC_DTYPE", value)
        assert spec_codec.spec_dtype_from_env() == dt
    monkeypatch.delenv("RRTMG_SPEC_DTYPE")
    assert spec_codec.spec_dtype_from_env() == torch.float32
    monkeypatch.setenv("RRTMG_SPEC_DTYPE", "bogus")
    with pytest.raises(ValueError) as jerr:
        PallasTaumol(jm.ktables, jm.static_np)
    with pytest.raises(ValueError) as terr:
        make_model(LWConfig(dtype="float32", use_lut=False), device="cpu")
    assert str(terr.value) == str(jerr.value)


# ---- the probes' plain versions against the archived reference ----

@pytest.mark.parametrize("nsplit,dout", [(3, 128), (1, 128), (3, None),
                                         (1, 37)])
def test_probe_onehot_plain_is_the_row_selection(nsplit, dout):
    """onehot(idx, R) @ tbl[:, :dout] over bf16 planes: exact (three
    planes) it is numpy's tbl[idx]; one plane, bf16(tbl)[idx]."""
    from rrtmg_lw_torch.utils import probes
    idx, tbl = probes.probe_inputs("cpu", C=700, R=65, D=300)
    out = probes.onehot_select(idx, tbl, dout, nsplit)
    ref_tbl = tbl if nsplit == 3 else tbl.to(torch.bfloat16).float()
    ref = ref_tbl.numpy()[idx.numpy()][:, :dout]
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_probe_gather_plain_is_the_row_gather():
    from rrtmg_lw_torch.utils import probes
    idx, tbl = probes.probe_inputs("cpu", C=1000, R=probes.R_GATHER,
                                   D=probes.D_GATHER)
    np.testing.assert_array_equal(probes.gather_rows(idx, tbl).numpy(),
                                  tbl.numpy()[idx.numpy()])


def test_bf16_three_way_split_reconstructs_the_table():
    """hi + mid + lo bf16 planes of a seeded float32 table, summed lo,
    mid, hi in float32 as the kernel does, give the table bit for bit;
    also over exponents from 1e-30 to 1e30."""
    from rrtmg_lw_torch.utils import probes
    rng = np.random.default_rng(4)
    _, tbl = probes.probe_inputs("cpu", R=65, D=1656)
    wide = (rng.standard_normal((65, 400))
            * 10.0 ** rng.integers(-30, 30, (65, 400))).astype(np.float32)
    for t in (tbl, torch.from_numpy(wide)):
        hi, mid, lo = probes.bf16_split(t, 3)
        assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
        assert torch.equal((lo.float() + mid.float()) + hi.float(), t)
        assert not torch.equal(hi.float(), t)
