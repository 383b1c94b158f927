"""The gradient step of the PyTorch port on the CPU.

(a) Each CUDA kernel wrapper is a ``torch.autograd.Function``: on a CPU
    tensor its outputs carry the Function's backward node, whose
    backward is exactly ``torch.autograd.grad`` of the plain forward, and
    ``gradcheck`` passes in float64.  Before, the wrappers filled a
    ``torch.empty`` through a raw pointer, so the outputs had no
    ``grad_fn`` and ``impl="cuda"`` dropped every gradient but the
    heating rate's dp.
(b) ``make_grad_step`` against ``jax.value_and_grad`` of the JAX model
    (XLA engines) in float64, clear sky and McICA, through the plain
    versions (``impl="eager"``) and through the Functions.
(c) The plain vjp of ``TaumolFn`` against ``jax.vjp`` of the JAX
    ``TaumolEngine``, field by field.
(d) Finite differences of OLR with respect to tlay.
(e) Finite gradients at the minor-gas over-abundance thresholds.
(f) The f32 conditioning of the heating-rate loss, against float64.
(g) idrv=1: the gradient step equals idrv=0's; a d/dT loss matches JAX.
(h) The maximum-random overlap entry (BandClouds, icld 2 and 3):
    ``make_grad_step`` against ``jax.value_and_grad`` of the JAX model
    (XLA engines), and the gradients with respect to the cloud
    fraction and the water paths against ``jax.grad`` with respect to the
    JAX BandClouds, through the plain versions and through the Functions
    (the overlap rows' and the maxrand sweep's plain vjps).

Tolerances: (a) exact, or 1e-13 relative where the two sides
accumulate one field's contributions in another order; (b) 1e-10 of
max |ref| per Atmosphere field and 1e-12 relative on the loss (measured
here: ~3e-12 and ~2e-16); (c) 1e-11 per field; (d) rel 2e-3, as
tests/test_autodiff.py; (h) 1e-12 relative on the loss, 1e-10 of max
|ref| per Atmosphere field and per cloud field.

The synthetic profiles hold CO2 and N2O at the reference atmosphere's
ratio, which puts band 15's eta parameter exactly on a table bin at the
surface (specparm = 0.5, specmult = 4): there the derivative jumps, and
the two packages take different sides by one ulp.  (b) and (c) scale the
trace gases by a seeded 5% noise so that every cell is differentiable.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.ops import setcoef as jsetcoef
from rrtmg_lw_tpu.types import BandClouds as JBandClouds
from rrtmg_lw_tpu.ops.inatm import inatm as jinatm
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig,
                            McicaCloudsCompact, make_model)
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.ops import cldprop, planck_cuda, rtrn, rtrn_cuda, setcoef
from rrtmg_lw_torch.ops import taumol_cuda
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.parallel import CLOUD_GRADS, make_grad_step
from rrtmg_lw_torch.utils import synthetic as tsyn
from test_torch_model import band_clouds

torch.set_num_threads(1)

GASES = ("co2vmr", "n2ovmr", "ch4vmr", "o3vmr", "covmr", "o2vmr")


def rel_err(got, ref):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    diff = np.abs(got - ref).max()
    return diff / scale if scale > 0 else diff


def noisy_atmosphere(B, L, seed=7):
    """Synthetic profiles with the trace gases off the reference ratios."""
    atm = jsyn.make_atmosphere(B, L)
    rng = np.random.default_rng(seed)
    return atm._replace(**{k: getattr(atm, k) * (
        1.0 + 0.05 * rng.standard_normal((B, L))) for k in GASES})


def small_case(B=3, L=6):
    model = make_model(LWConfig(icld=2, use_lut=False), device="cpu")
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu")
    cl = McicaCloudsCompact.from_numpy(
        tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8), "cpu")
    prof = inatm(atm)
    sc = setcoef.setcoef(prof, model.static_tensors(), planck=False)
    return model, atm, cl, prof, sc


# --------------------------------------------------------------- (a)

def test_planck_wrapper_is_a_function():
    model, _, _, prof, _ = small_case()
    temp = prof.tz.t().contiguous().requires_grad_()
    out = planck_cuda.planck_interp_blocked(temp, model.totplnk)
    assert type(out.grad_fn).__name__ == "PlanckFnBackward"
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(0),
                     dtype=out.dtype)
    got, = torch.autograd.grad(out, temp, ct)
    ref, = torch.autograd.grad(
        setcoef.interp_planck_blocked(temp, model.totplnk), temp, ct)
    assert torch.equal(got, ref)
    assert torch.autograd.gradcheck(
        lambda t: planck_cuda.PlanckFn.apply(t, model.totplnk), (temp,),
        fast_mode=True)


def test_taumol_wrapper_is_a_function():
    model, _, _, prof, sc = small_case()
    args = (model.engine, model.kernel_tabs, model.kernel_desc)
    # through the wrapper, from setcoef fields that require grad
    leaves = {k: getattr(sc, k).detach().requires_grad_()
              for k in ("colh2o", "colco2", "fac00", "selffac", "forfrac",
                        "minorfrac")}
    sc_g = sc._replace(**leaves)
    taug, fracs = taumol_cuda.taumol_blocked(sc_g, prof, *args)
    assert type(taug.grad_fn).__name__ == "TaumolFnBackward"
    assert fracs.grad_fn is taug.grad_fn
    gen = torch.Generator().manual_seed(1)
    cts = [torch.randn(taug.shape, generator=gen, dtype=taug.dtype)
           for _ in range(2)]
    got = torch.autograd.grad((taug, fracs), list(leaves.values()), cts)
    ref = torch.autograd.grad(model.engine.blocked(sc_g, prof),
                              list(leaves.values()), cts)
    for name, g, r in zip(leaves, got, ref):
        assert rel_err(g, r.numpy()) <= 1e-13, name
    # the Function itself: its backward is the plain vjp, exactly
    fld, ifld = taumol_cuda._pack_inputs(sc, prof)
    fld = fld.requires_grad_()
    out = taumol_cuda.TaumolFn.apply(fld, ifld, *args, None)
    got, = torch.autograd.grad(out, fld, cts)
    ref, = torch.autograd.grad(
        taumol_cuda.taumol_packed(model.engine, fld, ifld), fld, cts)
    assert torch.equal(got, ref)
    assert torch.autograd.gradcheck(
        lambda f: taumol_cuda.TaumolFn.apply(f, ifld, *args, None), (fld,),
        fast_mode=True)


@pytest.mark.parametrize("cloudy", [False, True])
def test_rt_wrapper_is_a_function(cloudy):
    model, _, cl, prof, sc = small_case()
    static = model.static_tensors()
    tg, fr = model.engine.blocked(sc, prof)
    # off od = 0, where max(od, 0) has no derivative (gradcheck's finite
    # differences would see half of it)
    taut = tg + 0.01
    play = setcoef.interp_planck_blocked(prof.tavel.t().contiguous(),
                                         model.totplnk)
    plev = setcoef.interp_planck_blocked(prof.tz.t().contiguous(),
                                         model.totplnk)
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float64)
    abi, abl = cldprop.ice_liq_coeffs_blocked(cl.reicmc, cl.relqmc, 3, 1,
                                              static)
    cw = torch.stack([cl.ciwp.t(), cl.clwp.t()], 1).contiguous()
    xs = [taut, fr, play, plev, surf] + ([cw, abi, abl] if cloudy
                                         else [None] * 3)
    xs = [None if x is None else x.clone().requires_grad_() for x in xs]
    mask = cl.cldfmc if cloudy else None
    ngb0, wg = model.ngb0, model.wg
    out = rtrn_cuda.RTFn.apply(*xs, mask, ngb0, wg)
    assert type(out.grad_fn).__name__ == "RTFnBackward"
    wrt = [x for x in xs if x is not None]
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(2),
                     dtype=out.dtype)
    got = torch.autograd.grad(out, wrt, ct)
    cf = None if mask is None else (mask, *xs[5:])
    ref = torch.autograd.grad(
        rtrn.rt_sweep_blocked(*xs[:5], ngb0, wg, cf), wrt, ct)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert torch.autograd.gradcheck(
        lambda *x: rtrn_cuda.RTFn.apply(*x, mask, ngb0, wg), tuple(xs),
        fast_mode=True)
    # the wrapper forms the surface rows outside the Function
    pwvcm = prof.pwvcm.clone().requires_grad_()
    fl = rtrn_cuda.rt_fluxes_blocked(
        taut, fr, play, plev, sc.plankbnd, prof.semiss, pwvcm, ngb0, wg,
        None if mask is None else (mask, cw, abi, abl))
    assert type(fl.grad_fn).__name__ == "RTFnBackward"
    g, = torch.autograd.grad(fl, pwvcm, ct)
    assert bool((g != 0).any())


@pytest.mark.parametrize("icld", [0, 2])
def test_kernel_path_differentiates_every_field(icld):
    """The model's impl="cuda" code path (the wrappers), run on the CPU:
    every Atmosphere field gets the eager path's gradient."""
    B, L = 3, 8
    atm = Atmosphere.from_numpy(noisy_atmosphere(B, L), "cpu")
    cl = McicaCloudsCompact.from_numpy(tsyn.make_mcica_clouds(
        B, L, mask_dtype=np.int8), "cpu") if icld else None
    eager = make_model(LWConfig(icld=icld, use_lut=False), device="cpu")
    kernels = make_model(LWConfig(icld=icld, use_lut=False), device="cpu")
    kernels.impl = "cuda"
    loss_e, g_e = make_grad_step(eager)(atm, cl)
    loss_k, g_k = make_grad_step(kernels)(atm, cl)
    assert float(loss_k) == float(loss_e)
    for name in Atmosphere._fields:
        assert rel_err(getattr(g_k, name), getattr(g_e, name).numpy()) \
            <= 1e-12, name
    for name in ("tlay", "tlev", "tsfc", "play", "h2ovmr", "co2vmr",
                 "o3vmr", "emis", "tauaer"):
        assert bool((getattr(g_k, name) != 0).any()), name


# --------------------------------------------------------------- (b)

@pytest.mark.parametrize("icld", [0, 2])
def test_grad_step_matches_jax_value_and_grad(icld):
    B, L = 4, 12
    jm = jmake_model(JConfig(icld=icld, imca=1, use_lut=False,
                             taumol_impl="xla", rt_impl="xla"))
    natm = noisy_atmosphere(B, L)
    ncl = jsyn.make_mcica_clouds(B, L, layout="compact",
                                 mask_dtype=np.int8) if icld else None
    jcl = None if ncl is None else jax.tree_util.tree_map(jnp.asarray, ncl)

    def jloss(a):
        fl = jm(a, jcl)
        return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, natm))
    tables = tables_from_numpy(jm.ktables, jm.static_np, device="cpu")
    atm = Atmosphere.from_numpy(natm, "cpu")
    cl = None if ncl is None else McicaCloudsCompact.from_numpy(
        tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8), "cpu")
    for impl in ("eager", "cuda"):
        model = make_model(LWConfig(icld=icld, imca=1, use_lut=False),
                           device="cpu", tables=tables)
        model.impl = impl          # "cuda": the Functions, on the CPU
        loss, g = make_grad_step(model)(atm, cl)
        assert abs(float(loss) - float(jl)) <= 1e-12 * abs(float(jl))
        for name in Atmosphere._fields:
            assert rel_err(getattr(g, name), getattr(jg, name)) <= 1e-10, \
                (impl, name)


# --------------------------------------------------------------- (c)

def test_taumol_plain_vjp_matches_jax_vjp():
    B, L = 4, 12
    jm = jmake_model(JConfig(icld=0, use_lut=False, taumol_impl="xla",
                             rt_impl="xla"))
    tm = make_model(LWConfig(icld=0, use_lut=False), device="cpu",
                    tables=tables_from_numpy(jm.ktables, jm.static_np,
                                             device="cpu"))
    natm = noisy_atmosphere(B, L)
    jprof = jinatm(jax.tree_util.tree_map(jnp.asarray, natm),
                   dtype=jnp.float64)
    jsc = jsetcoef.setcoef(jprof, jm.static)
    tprof = inatm(Atmosphere.from_numpy(natm, "cpu"))
    tsc = setcoef.setcoef(tprof, tm.static_tensors(), planck=False)
    rng = np.random.default_rng(3)
    ct_t, ct_f = (rng.standard_normal((B, L, 140)) for _ in range(2))

    prof_names = ("coldry", "pavel", "wx0", "wx1", "wx2", "wx3")
    sc_names = [k for k in taumol_cuda.FLOAT_FIELDS if k not in prof_names]

    def jfn(scf, pf):
        wx = jnp.stack([pf[f"wx{i}"] for i in range(4)], -1)
        return jm.engine(jsc._replace(**scf), jprof._replace(
            coldry=pf["coldry"], pavel=pf["pavel"], wx=wx))

    scf = {k: getattr(jsc, k) for k in sc_names}
    pf = dict(coldry=jprof.coldry, pavel=jprof.pavel,
              **{f"wx{i}": jprof.wx[..., i] for i in range(4)})
    _, vjp = jax.vjp(jfn, scf, pf)
    j_sc, j_p = vjp((jnp.asarray(ct_t), jnp.asarray(ct_f)))
    ref = {**j_sc, **j_p}

    fld, ifld = taumol_cuda._pack_inputs(tsc, tprof)
    got = taumol_cuda.taumol_packed_vjp(
        tm.engine, fld, ifld, torch.as_tensor(ct_t).permute(1, 2, 0)
        .contiguous(), torch.as_tensor(ct_f).permute(1, 2, 0).contiguous())
    for i, name in enumerate(taumol_cuda.FLOAT_FIELDS):
        assert rel_err(got[i].t(), ref[name]) <= 1e-11, name


# --------------------------------------------------------------- (d)

def test_grad_olr_wrt_tlay_matches_fd():
    """Mirrors tests/test_autodiff.py::test_grad_olr_wrt_tlay_matches_fd
    through the Functions on the CPU."""
    model = make_model(LWConfig(icld=0, use_lut=False), device="cpu")
    model.impl = "cuda"
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(2, 12), "cpu")

    def olr_sum(fl):
        return fl.uflx[:, -1].sum()

    _, g = make_grad_step(model, olr_sum)(atm)
    assert torch.isfinite(g.tlay).all()
    # warming any layer must increase OLR in a clear atmosphere
    assert bool((g.tlay > 0.0).all())
    with torch.no_grad():
        for idx in [(0, 3), (1, 10)]:
            f = []
            for eps in (0.05, -0.05):
                t = atm.tlay.clone()
                t[idx] += eps
                f.append(float(olr_sum(model(atm._replace(tlay=t)))))
            fd = (f[0] - f[1]) / 0.1
            assert float(g.tlay[idx]) == pytest.approx(fd, rel=2e-3)


# --------------------------------------------------------------- (e)

def test_grad_finite_at_adjusted_col_threshold():
    """Mirrors tests/test_taumol_bwd.py::
    test_grad_finite_at_adjusted_col_threshold: columns whose CO2, N2O
    sit at their over-abundance ratio (band 7 lower has threshold equal
    to base, so the fractional power's base is at 0+) and boosted far
    past it must give finite gradients."""
    B, L = 4, 10
    model = make_model(LWConfig(icld=0, use_lut=False), device="cpu")
    model.impl = "cuda"
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu")
    sc = setcoef.setcoef(inatm(atm), model.static_tensors(), planck=False)
    chi = torch.as_tensor(model.static_np["chi_mls"])
    ref = chi[:, sc.jp.long() + 1]               # chi_mls(gas, jp+1)
    co2, n2o = atm.co2vmr.clone(), atm.n2ovmr.clone()
    co2[0], n2o[0] = 3.0 * ref[1, 0], 1.5 * ref[3, 0]    # at threshold
    co2[1] = torch.nextafter(3.0 * ref[1, 1], torch.tensor(np.inf))
    co2[2], n2o[2] = 8.0 * co2[2], 50.0 * n2o[2]         # far past it
    atm = atm._replace(co2vmr=co2, n2ovmr=n2o,
                       ch4vmr=atm.ch4vmr * torch.tensor([1, 1, 20, 1.0])
                       [:, None])
    _, g = make_grad_step(model)(atm)
    for name in ("n2ovmr", "ch4vmr", "co2vmr", "play", "plev"):
        assert torch.isfinite(getattr(g, name)).all(), name
    _, g_e = make_grad_step(make_model(LWConfig(icld=0, use_lut=False),
                                       device="cpu"))(atm)
    assert rel_err(g.co2vmr, g_e.co2vmr.numpy()) <= 1e-12


# --------------------------------------------------------------- (f)

@pytest.mark.parametrize("icld", [0, 2])
def test_f32_gradient_conditioning(icld):
    """Why chip_smoke.py holds the card's gradient step to the eager one
    through a loss linear in the fluxes, and not through the default loss.
    The f32 step against the same step in f64: the fluxes agree to ~3e-7,
    yet the gradient of the heating-rate term (hr**2).mean() is off by
    more than its own size on tauaer (measured: 13.7x clear, 1.5x McICA),
    since the top layers' heating rates are small differences of large
    fluxes, and the loss weights the gradient by them.  A loss linear in
    the four flux arrays reads the forward only through the linearization
    point: its f32 gradient agrees to <= 1.1e-5 of max |f64| per field."""
    B, L = 8, 60
    natm = noisy_atmosphere(B, L)
    ncl = tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8) if icld else None
    gen = torch.Generator().manual_seed(0)
    cts = [torch.randn(B, L + 1, generator=gen, dtype=torch.float64)
           for _ in range(4)]

    def hr2(fl):
        return (fl.hr ** 2).mean()

    def linear(fl):
        return sum((c.to(x.dtype) * x).sum() for c, x in zip(
            cts, (fl.uflx, fl.dflx, fl.uflxc, fl.dflxc)))

    out = {}
    for dtype in ("float32", "float64"):
        model = make_model(LWConfig(icld=icld, dtype=dtype, use_lut=False),
                           device="cpu")
        dt = getattr(torch, dtype)
        atm = Atmosphere.from_numpy(natm, torch.device("cpu"), dt)
        cl = None if ncl is None else McicaCloudsCompact.from_numpy(
            ncl, torch.device("cpu"), dt)
        with torch.no_grad():
            fl = model(atm, cl)
        out[dtype] = (fl, make_grad_step(model, hr2)(atm, cl)[1],
                      make_grad_step(model, linear)(atm, cl)[1])
    (f32, h32, l32), (f64, h64, l64) = out["float32"], out["float64"]
    for name in ("uflx", "dflx", "uflxc", "dflxc"):
        assert rel_err(getattr(f32, name), getattr(f64, name).numpy()) \
            <= 1e-6, name
    assert rel_err(h32.tauaer, h64.tauaer.numpy()) >= 0.5
    for name in Atmosphere._fields:
        assert rel_err(getattr(l32, name), getattr(l64, name).numpy()) \
            <= 1e-4, name


# --------------------------------------------------------------- (g)

@pytest.mark.parametrize("icld", [0, 2])
def test_idrv_grad_step_equals_idrv0(icld):
    """At idrv=1 the default loss reads no d/dT: the gradient step through
    the Functions (impl="cuda" on the CPU) is the idrv=0 step's, and the
    d/dT row of the surface rows gets a zero cotangent."""
    B, L = 3, 8
    atm = Atmosphere.from_numpy(noisy_atmosphere(B, L), "cpu")
    cl = McicaCloudsCompact.from_numpy(tsyn.make_mcica_clouds(
        B, L, mask_dtype=np.int8), "cpu") if icld else None
    out = []
    for idrv in (0, 1):
        model = make_model(LWConfig(icld=icld, idrv=idrv, use_lut=False),
                           device="cpu")
        model.impl = "cuda"
        out.append(make_grad_step(model)(atm, cl))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for name in Atmosphere._fields:
        assert torch.equal(getattr(g0, name), getattr(g1, name)), name


def test_ddt_loss_grad_matches_jax_value_and_grad():
    """A loss that reads duflx_dt and duflxc_dt (idrv=1, McICA): on the
    CPU the Functions' plain vjps cover the d/dT outputs, and the
    gradients match jax.value_and_grad's."""
    B, L = 4, 12
    jm = jmake_model(JConfig(icld=2, imca=1, idrv=1, use_lut=False,
                             taumol_impl="xla", rt_impl="xla"))
    natm = noisy_atmosphere(B, L)
    ncl = jsyn.make_mcica_clouds(B, L, layout="compact", mask_dtype=np.int8)
    jcl = jax.tree_util.tree_map(jnp.asarray, ncl)

    def loss(fl):
        return ((fl.uflx[:, -1] ** 2).mean() + (fl.duflx_dt ** 2).mean()
                + fl.duflxc_dt[:, -1].mean())

    jl, jg = jax.jit(jax.value_and_grad(lambda a: loss(jm(a, jcl))))(
        jax.tree_util.tree_map(jnp.asarray, natm))
    tables = tables_from_numpy(jm.ktables, jm.static_np, device="cpu")
    atm = Atmosphere.from_numpy(natm, "cpu")
    cl = McicaCloudsCompact.from_numpy(
        tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8), "cpu")
    for impl in ("eager", "cuda"):
        model = make_model(LWConfig(icld=2, imca=1, idrv=1, use_lut=False),
                           device="cpu", tables=tables)
        model.impl = impl
        lv, g = make_grad_step(model, loss)(atm, cl)
        assert abs(float(lv) - float(jl)) <= 1e-12 * abs(float(jl))
        for name in Atmosphere._fields:
            assert rel_err(getattr(g, name), getattr(jg, name)) <= 1e-10, \
                (impl, name)
        # the d/dT terms reach the surface temperature and emissivity
        assert bool((g.tsfc != 0).all()) and bool((g.emis != 0).any())


# --------------------------------------------------------------- (h)

MAXRAND_SHAPE = (4, 12)


@functools.lru_cache(maxsize=None)
def _maxrand_jax(icld):
    """The JAX model's default loss on noisy_atmosphere and band_clouds,
    its gradient with respect to every Atmosphere field, and with
    respect to the BandClouds' cloud fraction and water paths."""
    B, L = MAXRAND_SHAPE
    jm = jmake_model(JConfig(icld=icld, imca=0, inflag=2, iceflag=3,
                             liqflag=1, use_lut=False, taumol_impl="xla",
                             rt_impl="xla"))
    natm, nbc = noisy_atmosphere(B, L), band_clouds(B, L)

    def jloss(a, cw):
        fl = jm(a, JBandClouds(*nbc)._replace(**cw))
        return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()

    cw = {k: jnp.asarray(getattr(nbc, k)) for k in CLOUD_GRADS}
    jl, (ja, jc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, natm), cw)
    return jm, natm, nbc, float(jl), ja, jc


def _maxrand_models(icld, jm):
    """The port's maxrand model on the JAX model's tables, impl "eager"
    and "cuda" (the Functions on the CPU)."""
    tables = tables_from_numpy(jm.ktables, jm.static_np, device="cpu")
    for impl in ("eager", "cuda"):
        model = make_model(LWConfig(icld=icld, imca=0, inflag=2, iceflag=3,
                                    liqflag=1, use_lut=False),
                           device="cpu", tables=tables)
        model.impl = impl
        yield impl, model


@pytest.mark.parametrize("icld", [2, 3])
def test_maxrand_grad_step_matches_jax_value_and_grad(icld):
    """The maxrand gradient step (make_grad_step, default loss, w.r.t.
    every Atmosphere field) against jax.value_and_grad of the JAX
    model."""
    jm, natm, nbc, jl, ja, _ = _maxrand_jax(icld)
    atm = Atmosphere.from_numpy(natm, "cpu")
    for impl, model in _maxrand_models(icld, jm):
        loss, g = make_grad_step(model)(atm, BandClouds.from_numpy(nbc,
                                                                   "cpu"))
        assert abs(float(loss) - jl) <= 1e-12 * abs(jl), impl
        for name in Atmosphere._fields:
            assert rel_err(getattr(g, name), getattr(ja, name)) <= 1e-10, \
                (impl, name)


@pytest.mark.parametrize("icld", [2, 3])
def test_maxrand_cloud_grads_match_jax(icld):
    """The default loss's gradients with respect to the BandClouds'
    cldfrac, ciwp and clwp (``make_grad_step`` with ``cloud_fields``)
    against jax.grad with respect to the JAX BandClouds.  band_clouds holds
    adjacent layers of equal fraction, where the overlap factors'
    max(0, .) must pass half the gradient to each side, as jnp.maximum
    does (torch.clamp_min passes it all: 7.2e-3 of max |JAX| off)."""
    jm, natm, nbc, _, _, jc = _maxrand_jax(icld)
    atm = Atmosphere.from_numpy(natm, "cpu")
    for impl, model in _maxrand_models(icld, jm):
        _, _, got = make_grad_step(model, cloud_fields=CLOUD_GRADS)(
            atm, BandClouds.from_numpy(nbc, "cpu"))
        for name, gc in zip(CLOUD_GRADS, got):
            assert bool((gc != 0).any()), (impl, name)
            assert rel_err(gc, jc[name]) <= 1e-10, (impl, name)
