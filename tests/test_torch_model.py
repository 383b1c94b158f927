"""The PyTorch port's whole forward step (the eager path, which runs the
plain versions of the kernels) against the JAX model with its XLA
engines, on the same seeded numpy inputs: clear sky, McICA with compact
int8-mask clouds, and deterministic per-band clouds (imca=0: icld=1
random overlap, icld 2/3 maximum-random overlap; inflag 0, 1 and 2).

Tolerances: in float64, 1e-11 W/m2 on fluxes and 2e-9 K/day on heating
rates (measured here: ~1.2e-13 W/m2 and ~2.2e-11 K/day, the heating
difference coming from the thinnest top layers); for the per-band
clouds 1e-11 W/m2 and 1e-11 of max |hr| (measured ~1.7e-13 W/m2 and
~3e-15 of a max |hr| ~3000 K/day in the top layer); the port in float32
against JAX in float64 holds the reference-accuracy bounds of
tests/test_f32_accuracy.py (< 5e-3 W/m2, < 0.05 K/day).

Reduced spectral storage (RRTMG_SPEC_DTYPE = bf16, f16, logu16): the
port's float32 eager step against a JAX composition of the package's
own functions (the XLA engine's taug / fracs through
``taumol_pallas.spec_*``, then the aerosol add and the model's XLA
sweep, as ``fluxes_xla`` does at rtrn_pallas.py:1007-1031 and
:1182-1199), on an atmosphere with aerosol, within 1e-6 x max(|flux|, 1)
per column (measured at most 2.7e-7, the float32 paths' own difference;
the float32 step and an aerosol-free step both lie outside); float64
ignores the variable (bitwise); a gradient through reduced storage
raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.ops.inatm import inatm as jinatm
from rrtmg_lw_tpu.types import BandClouds as JBandClouds
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig, McicaClouds,
                            McicaCloudsBlocked, McicaCloudsCompact,
                            make_model)
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.parallel import make_grad_step
from rrtmg_lw_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

FLUXES = ("uflx", "dflx", "uflxc", "dflxc")
HEATING = ("hr", "hrc")


def _inputs(B, L, icld, dtype):
    npdt = np.float32 if dtype == "float32" else np.float64
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L, dtype=npdt),
                                "cpu", getattr(torch, dtype))
    clouds = McicaCloudsCompact.from_numpy(
        tsyn.make_mcica_clouds(B, L, dtype=npdt, mask_dtype=np.int8),
        "cpu", getattr(torch, dtype)) if icld else None
    return atm, clouds


def _jax(B, L, icld):
    jm = jmake_model(JConfig(icld=icld, imca=1, use_lut=False,
                             taumol_impl="xla", rt_impl="xla"))
    atm = jsyn.make_atmosphere(B, L)
    clouds = jsyn.make_mcica_clouds(B, L, layout="compact",
                                    mask_dtype=np.int8) if icld else None
    return jm, jm(atm, clouds)


def _max_diff(a, b, names):
    return max(float(np.abs(getattr(a, n).double().numpy()
                            - np.asarray(getattr(b, n))).max())
               for n in names)


@pytest.mark.parametrize("icld", [0, 2])
def test_model_matches_jax_f64(icld):
    B, L = 8, 20
    jm, ref = _jax(B, L, icld)
    model = make_model(LWConfig(icld=icld, imca=1, use_lut=False),
                       device="cpu", tables=tables_from_numpy(
                           jm.ktables, jm.static_np, device="cpu"))
    assert model.impl == "eager"
    out = model(*_inputs(B, L, icld, "float64"))
    for name in FLUXES + HEATING:
        assert getattr(out, name).shape == np.asarray(getattr(ref,
                                                              name)).shape
    assert _max_diff(out, ref, FLUXES) <= 1e-11
    assert _max_diff(out, ref, HEATING) <= 2e-9
    if icld:
        np.testing.assert_array_equal(out.cld_bounds_ok.numpy(),
                                      np.asarray(ref.cld_bounds_ok))
        # clouds change the all-sky fluxes, not the clear-sky ones
        assert not torch.allclose(out.uflx, out.uflxc)
    else:
        assert out.cld_bounds_ok is None


@pytest.mark.parametrize("icld", [0, 2])
def test_model_f32_within_reference_contract(icld):
    B, L = 8, 60
    _, ref = _jax(B, L, icld)
    out = make_model(LWConfig(icld=icld, imca=1, dtype="float32",
                              use_lut=False), device="cpu")(*_inputs(B, L, icld,
                                                       "float32"))
    assert out.uflx.dtype == torch.float32
    assert _max_diff(out, ref, ("uflx", "dflx")) < 5e-3
    assert _max_diff(out, ref, ("hr",)) < 0.05


def test_from_profile_is_the_call():
    B, L = 4, 12
    model = make_model(LWConfig(icld=2, use_lut=False), device="cpu")
    atm, clouds = _inputs(B, L, 2, "float64")
    a = model(atm, clouds)
    b = model.from_profile(inatm(atm), clouds)
    for name in FLUXES + HEATING:
        assert torch.equal(getattr(a, name), getattr(b, name))


def test_deep_profile_finite():
    """nlay=140 (the deep cell), McICA, float64 eager."""
    B, L = 2, 140
    out = make_model(LWConfig(icld=2, use_lut=False), device="cpu")(
        *_inputs(B, L, 2, "float64"))
    for name in FLUXES + HEATING:
        assert torch.isfinite(getattr(out, name)).all(), name
    assert out.uflx.shape == (B, L + 1) and out.hr.shape == (B, L)


def test_clouds_other_than_compact_raise():
    """McICA takes the three McICA cloud types and nothing else."""
    model = make_model(LWConfig(icld=2, use_lut=False), device="cpu")
    atm, _ = _inputs(2, 6, 0, "float64")
    with pytest.raises(TypeError, match="McicaCloudsBlocked"):
        model(atm, (jnp.zeros(1),))


def band_clouds(B, L, dtype=np.float64):
    """make_band_clouds with the fractions varied inside each deck (so
    both overlap regimes, rising and falling, occur), one overcast deck
    and in-cloud optical depths for inflag 0."""
    bc = tsyn.make_band_clouds(B, L, dtype=dtype)
    rng = np.random.default_rng(7)
    cf = bc.cldfrac * (0.6 + 0.4 * rng.random(bc.cldfrac.shape))
    cf[0, 3:6] = 1.0
    tauc = rng.random((B, L, 16)) * (cf[..., None] > 0)
    return bc._replace(cldfrac=cf.astype(dtype), tauc=tauc.astype(dtype))


def _max_abs(a, b, name):
    return float(np.abs(getattr(a, name).double().numpy()
                        - np.asarray(getattr(b, name))).max())


@pytest.mark.parametrize("icld,inflag", [(1, 2), (2, 2), (3, 2), (1, 0),
                                         (1, 1), (2, 0), (2, 1)])
def test_band_clouds_model_matches_jax_f64(icld, inflag):
    B, L = 6, 12
    jm = jmake_model(JConfig(icld=icld, imca=0, inflag=inflag,
                             use_lut=False, taumol_impl="xla",
                             rt_impl="xla"))
    nbc = band_clouds(B, L)
    ref = jm(jsyn.make_atmosphere(B, L), JBandClouds(*nbc))
    model = make_model(LWConfig(icld=icld, imca=0, inflag=inflag,
                                use_lut=False), device="cpu",
                       tables=tables_from_numpy(jm.ktables, jm.static_np,
                                                device="cpu"))
    out = model(Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"),
                BandClouds.from_numpy(nbc, "cpu"))
    for name in FLUXES:
        assert _max_abs(out, ref, name) <= 1e-11, name
    for name in HEATING:
        scale = float(np.abs(np.asarray(getattr(ref, name))).max())
        assert _max_abs(out, ref, name) <= 1e-11 * scale, name
    np.testing.assert_array_equal(out.cld_bounds_ok.numpy(),
                                  np.asarray(ref.cld_bounds_ok))
    assert not torch.allclose(out.uflx, out.uflxc)


@pytest.mark.parametrize("icld", [1, 2, 3])
def test_band_clouds_model_f32_within_reference_contract(icld):
    B, L = 6, 40
    jm = jmake_model(JConfig(icld=icld, imca=0, use_lut=False,
                             taumol_impl="xla", rt_impl="xla"))
    ref = jm(jsyn.make_atmosphere(B, L), JBandClouds(*band_clouds(B, L)))
    out = make_model(LWConfig(icld=icld, imca=0, dtype="float32",
                              use_lut=False), device="cpu")(
        Atmosphere.from_numpy(tsyn.make_atmosphere(B, L, dtype=np.float32),
                              "cpu", torch.float32),
        BandClouds.from_numpy(band_clouds(B, L, np.float32), "cpu",
                              torch.float32))
    assert out.uflx.dtype == torch.float32
    assert _max_diff(out, ref, ("uflx", "dflx")) < 5e-3
    assert _max_diff(out, ref, ("hr",)) < 0.05


@pytest.mark.parametrize("icld", [1, 2])
def test_band_clouds_functions_grad_on_cpu(icld):
    """With impl="cuda" on the CPU the banded / maxrand Functions run
    their plain forward and vjp: the gradient step equals plain
    autograd's."""
    B, L = 3, 10
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu")
    bc = BandClouds.from_numpy(band_clouds(B, L), "cpu")
    cfg = LWConfig(icld=icld, imca=0, use_lut=False)
    eager = make_model(cfg, device="cpu")
    kernels = make_model(cfg, device="cpu")
    kernels.impl = "cuda"
    loss_e, g_e = make_grad_step(eager)(atm, bc)
    loss_k, g_k = make_grad_step(kernels)(atm, bc)
    assert torch.equal(loss_e, loss_k)
    for name in Atmosphere._fields:
        a, b = getattr(g_k, name), getattr(g_e, name)
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * max(scale, 1e-300), name
    assert float(g_k.tlay.abs().max()) > 0


def _mcica_tauc(cl):
    """McICA clouds with an input cloud od taucmc = cldfmc x (0.05 ciwpmc
    + 0.1 clwpmc) (numpy, either per-g layout)."""
    cf, ci, cw = (np.asarray(x) for x in cl[:3])
    return cl._replace(taucmc=cf * (0.05 * ci + 0.1 * cw))


def _cloud_case(kind, B, L, inflag):
    """(JAX clouds, port clouds on the CPU) of one cloud input form."""
    if kind == "band":
        nbc = band_clouds(B, L)
        return JBandClouds(*nbc), BandClouds.from_numpy(nbc, "cpu")
    if kind == "compact":
        return (jsyn.make_mcica_clouds(B, L, layout="compact",
                                       mask_dtype=np.int8),
                McicaCloudsCompact.from_numpy(tsyn.make_mcica_clouds(
                    B, L, mask_dtype=np.int8), "cpu"))
    jcl = jsyn.make_mcica_clouds(B, L, layout=kind)
    tcl = tsyn.make_mcica_clouds(B, L, layout=kind)
    if inflag == 0:
        jcl, tcl = _mcica_tauc(jcl), _mcica_tauc(tcl)
    cls = McicaCloudsBlocked if kind == "blocked" else McicaClouds
    return (type(jcl)(*(jnp.asarray(x) for x in jcl)),
            cls.from_numpy(tcl, "cpu"))


IDRV_CASES = [(0, 1, 2, None), (2, 1, 2, "compact"), (2, 1, 2, "blocked"),
              (2, 1, 0, "blocked"), (2, 1, 2, "batch"), (2, 1, 0, "batch"),
              (1, 0, 2, "band"), (2, 0, 2, "band")]


@pytest.mark.parametrize("icld,imca,inflag,kind", IDRV_CASES)
def test_idrv_model_matches_jax_f64(icld, imca, inflag, kind):
    """idrv=1 in every cloud treatment and McICA input form: the fluxes
    and duflx_dt / duflxc_dt against the JAX model (XLA engines)."""
    B, L = 5, 12
    jm = jmake_model(JConfig(icld=icld, imca=imca, inflag=inflag, idrv=1,
                             use_lut=False, taumol_impl="xla",
                             rt_impl="xla"))
    jcl, tcl = _cloud_case(kind, B, L, inflag) if kind else (None, None)
    ref = jm(jsyn.make_atmosphere(B, L), jcl)
    model = make_model(LWConfig(icld=icld, imca=imca, inflag=inflag, idrv=1,
                                use_lut=False), device="cpu",
                       tables=tables_from_numpy(jm.ktables, jm.static_np,
                                                device="cpu"))
    out = model(Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"),
                tcl)
    for name in FLUXES + ("duflx_dt", "duflxc_dt"):
        assert _max_abs(out, ref, name) <= 1e-11, name
    for name in HEATING:
        scale = float(np.abs(np.asarray(getattr(ref, name))).max())
        assert _max_abs(out, ref, name) <= 1e-11 * scale, name
    assert float(out.duflx_dt.min()) > 0
    if kind:
        np.testing.assert_array_equal(out.cld_bounds_ok.numpy(),
                                      np.asarray(ref.cld_bounds_ok))
        assert not torch.allclose(out.uflx, out.uflxc)
        assert not torch.allclose(out.duflx_dt, out.duflxc_dt)
    # the idrv=0 step gives the same fluxes and no derivatives
    out0 = make_model(LWConfig(icld=icld, imca=imca, inflag=inflag,
                               use_lut=False), device="cpu",
                      tables=tables_from_numpy(jm.ktables, jm.static_np,
                                               device="cpu"))(
        Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"), tcl)
    assert out0.duflx_dt is None and out0.duflxc_dt is None
    for name in FLUXES:
        assert torch.equal(getattr(out, name), getattr(out0, name)), name


@pytest.mark.parametrize("icld,kind", [(0, None), (2, "blocked")])
def test_dtbound_adjustment_matches_jax(icld, kind):
    """from_profile with Profile.dtbound set (idrv=1): upward fluxes and
    heating rates moved by d/dT x dtbound, as the JAX model does on its
    own Profile._replace(dtbound=...)."""
    B, L = 5, 12
    jm = jmake_model(JConfig(icld=icld, idrv=1, use_lut=False,
                             taumol_impl="xla", rt_impl="xla"))
    jcl, tcl = _cloud_case(kind, B, L, 2) if kind else (None, None)
    dtb = np.random.default_rng(3).uniform(-2.0, 2.0, B)
    jprof = jinatm(jsyn.make_atmosphere(B, L), dtype=jnp.float64)
    ref = jm.from_profile(jprof._replace(dtbound=jnp.asarray(dtb)), jcl)
    model = make_model(LWConfig(icld=icld, idrv=1, use_lut=False),
                       device="cpu", tables=tables_from_numpy(
                           jm.ktables, jm.static_np, device="cpu"))
    prof = inatm(Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"))
    out = model.from_profile(prof._replace(dtbound=torch.as_tensor(dtb)),
                             tcl)
    for name in FLUXES + ("duflx_dt", "duflxc_dt"):
        assert _max_abs(out, ref, name) <= 1e-11, name
    for name in HEATING:
        scale = float(np.abs(np.asarray(getattr(ref, name))).max())
        assert _max_abs(out, ref, name) <= 1e-11 * scale, name
    plain = model.from_profile(prof, tcl)
    assert torch.equal(out.dflx, plain.dflx)
    assert torch.allclose(out.uflx, plain.uflx + plain.duflx_dt
                          * torch.as_tensor(dtb)[:, None], rtol=0,
                          atol=1e-12)
    assert not torch.allclose(out.hr, plain.hr)


def test_float_mask_runs_the_fused_mode():
    """A float McicaCloudsCompact mask is exact for any value: the model
    takes its per-g products to the fused mode (``impl="cuda"`` on the
    CPU: the wrappers' plain route), which gives the int8 mask's fluxes
    where the mask is binary, and the JAX package's where it is not."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    B, L = 5, 12
    jm = jmake_model(JConfig(icld=2, use_lut=False, taumol_impl="xla",
                             rt_impl="xla"))
    tables = tables_from_numpy(jm.ktables, jm.static_np, device="cpu")
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu")
    nf = tsyn.make_mcica_clouds(B, L)                   # float 0/1 mask
    assert nf.cldfmc.dtype == np.float64
    calls = []
    model = make_model(LWConfig(icld=2, use_lut=False), device="cpu",
                       tables=tables)
    model.impl = "cuda"
    fused = rtrn_cuda.WRAPPERS["fused"]
    rtrn_cuda.WRAPPERS["fused"] = lambda *a, **k: calls.append(1) or \
        fused(*a, **k)
    try:
        got = model(atm, McicaCloudsCompact.from_numpy(nf, "cpu"))
        ref8 = model(atm, McicaCloudsCompact.from_numpy(
            tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8), "cpu"))
        frac = nf._replace(cldfmc=nf.cldfmc * 0.8)      # not binary
        got_f = model(atm, McicaCloudsCompact.from_numpy(frac, "cpu"))
    finally:
        rtrn_cuda.WRAPPERS["fused"] = fused
    assert len(calls) == 2
    for name in FLUXES:
        assert torch.equal(getattr(got, name), getattr(ref8, name)), name
    jf = jsyn.make_mcica_clouds(B, L, layout="compact")
    ref_f = jm(jsyn.make_atmosphere(B, L),
               jf._replace(cldfmc=jf.cldfmc * 0.8))
    for name in FLUXES:
        assert _max_abs(got_f, ref_f, name) <= 1e-11, name
    assert not torch.allclose(got_f.uflx, got.uflx)


# ---- reduced spectral storage (RRTMG_SPEC_DTYPE) ----

SPEC_CASES = [(0, 1, None), (2, 1, "compact"), (1, 0, "band"),
              (2, 0, "band")]


def _jax_storage_model(icld, imca, spec):
    """The JAX model (XLA engines, float32) whose optical depth stores
    taug and fracs as ``spec`` and reads them back before the aerosol
    add: the package's own functions composed as its fluxes_xla does."""
    from rrtmg_lw_tpu.ops import taumol_pallas as jtp
    from rrtmg_lw_tpu.ops.setcoef import setcoef as jsetcoef
    jm = jmake_model(JConfig(icld=icld, imca=imca, dtype="float32",
                             use_lut=False, taumol_impl="xla",
                             rt_impl="xla"))
    cast = {"bf16": jnp.bfloat16, "f16": jnp.float16}

    def store(x, which):
        if spec == "logu16":
            return (jtp.spec_encode_taug if which == "tg"
                    else jtp.spec_encode_frac)(x)
        return x.astype(cast[spec])

    def optical_depth(prof, istart=1):
        sc = jsetcoef(prof, jm.static, istart=istart, idrv=jm.config.idrv)
        taug, fracs = jm.engine(sc, prof)
        taut = jtp.spec_load_taut(store(taug, "tg")) + \
            prof.taua[..., jm.ngb0]
        return sc, taut, jtp.spec_load_frac(store(fracs, "fr"))

    jm.optical_depth = optical_depth
    return jm


def _f32_inputs(kind, B, L):
    """(JAX clouds, port clouds) in float32 of a cloud form, or None."""
    if kind is None:
        return None, None
    if kind == "compact":
        return (jsyn.make_mcica_clouds(B, L, dtype=jnp.float32,
                                       layout="compact", mask_dtype=np.int8),
                McicaCloudsCompact.from_numpy(tsyn.make_mcica_clouds(
                    B, L, dtype=np.float32, mask_dtype=np.int8), "cpu",
                    torch.float32))
    nbc = band_clouds(B, L, np.float32)
    return (JBandClouds(*nbc),
            BandClouds.from_numpy(nbc, "cpu", torch.float32))


def _col_err(got, ref):
    """max over columns of max |got - ref| / max(max |ref|, 1)."""
    g = got.double().numpy()
    r = np.asarray(ref, np.float64)
    return float((np.abs(g - r).max(1)
                  / np.maximum(np.abs(r).max(1), 1.0)).max())


# the storage step against the JAX composition, per column / max |flux|:
# measured at most 2.7e-7 (float32 arithmetic in another order), below
# the least any storage moves these fluxes from float32's, so a port
# that skipped the encode or the aerosol add fails
TOL_STORAGE = 1e-6


@pytest.mark.parametrize("spec", ["bf16", "f16", "logu16"])
@pytest.mark.parametrize("icld,imca,kind", SPEC_CASES)
def test_storage_step_matches_jax(monkeypatch, icld, imca, kind, spec):
    B, L = 16, 10
    jm = _jax_storage_model(icld, imca, spec)
    jcl, tcl = _f32_inputs(kind, B, L)
    ref = jm(jsyn.make_atmosphere(B, L, dtype=jnp.float32, aod=0.1), jcl)
    tables = tables_from_numpy(jm.ktables, jm.static_np, device="cpu")
    cfg = LWConfig(icld=icld, imca=imca, dtype="float32", use_lut=False)
    atm = Atmosphere.from_numpy(
        tsyn.make_atmosphere(B, L, dtype=np.float32, aod=0.1), "cpu",
        torch.float32)
    assert float(atm.tauaer.min()) > 0.0
    plain32 = make_model(cfg, device="cpu", tables=tables)
    monkeypatch.setenv("RRTMG_SPEC_DTYPE", spec)
    model = make_model(cfg, device="cpu", tables=tables)
    assert model.reduced_storage and model.impl == "eager"
    out = model(atm, tcl)
    errs = {n: _col_err(getattr(out, n), getattr(ref, n)) for n in FLUXES}
    # the limit tells reduced storage from float32, and from a step
    # without the aerosol
    apart = [max(_col_err(getattr(other, n), getattr(ref, n))
                 for n in FLUXES)
             for other in (plain32(atm, tcl), model(atm._replace(
                 tauaer=torch.zeros_like(atm.tauaer)), tcl))]
    print(f"{spec} icld={icld} imca={imca}: max per-column err "
          f"{max(errs.values()):.3g}; float32 {apart[0]:.3g}, no aerosol "
          f"{apart[1]:.3g}")
    assert max(errs.values()) <= TOL_STORAGE, errs
    assert min(apart) > TOL_STORAGE, apart
    if kind:
        assert not torch.allclose(out.uflx, out.uflxc)


def test_storage_float64_changes_nothing(monkeypatch):
    """A float64 model ignores RRTMG_SPEC_DTYPE (bitwise), as the JAX
    package's XLA engine does; a float32 model does not."""
    B, L = 5, 12
    atm, clouds = _inputs(B, L, 2, "float64")
    cfg = LWConfig(icld=2, use_lut=False)
    base = make_model(cfg, device="cpu")(atm, clouds)
    monkeypatch.setenv("RRTMG_SPEC_DTYPE", "logu16")
    model = make_model(cfg, device="cpu")
    assert model.spec_dtype == torch.uint16 and not model.reduced_storage
    out = model(atm, clouds)
    for name in FLUXES + HEATING:
        assert torch.equal(getattr(out, name), getattr(base, name)), name
    a32, c32 = _inputs(B, L, 2, "float32")
    f32 = make_model(cfg.replace(dtype="float32"), device="cpu")
    assert f32.reduced_storage
    monkeypatch.delenv("RRTMG_SPEC_DTYPE")
    plain32 = make_model(cfg.replace(dtype="float32"), device="cpu")
    assert not torch.equal(f32(a32, c32).uflx, plain32(a32, c32).uflx)


@pytest.mark.parametrize("impl", ["eager", "cuda"])
def test_storage_gradient_raises(monkeypatch, impl):
    """A gradient through a logu16 step raises NotImplementedError (JAX's
    wording) on both impls (``impl="cuda"`` on the CPU: the wrappers'
    plain route), also when only taumol's inputs require grad: the codes
    cut them from the graph, and no gradient may come back silently
    zero."""
    B, L = 4, 10
    monkeypatch.setenv("RRTMG_SPEC_DTYPE", "logu16")
    model = make_model(LWConfig(icld=2, dtype="float32", use_lut=False),
                       device="cpu")
    model.impl = impl
    atm, clouds = _inputs(B, L, 2, "float32")
    with pytest.raises(NotImplementedError, match="RRTMG_SPEC_DTYPE"):
        make_grad_step(model)(atm, clouds)
    # ozone reaches the fluxes only through taumol
    o3 = atm.o3vmr.clone().requires_grad_()
    fl = model(atm._replace(o3vmr=o3), clouds)
    with pytest.raises(NotImplementedError, match="RRTMG_SPEC_DTYPE"):
        fl.uflx.sum().backward()
    with torch.no_grad():
        model(atm._replace(o3vmr=o3), clouds)
