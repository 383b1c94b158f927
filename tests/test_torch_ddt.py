"""The adjoint of the d/dT outputs (idrv=1: duflx_dt, duflxc_dt, the
upward fluxes' derivatives with respect to the surface temperature) on
the CPU, in every mode of the RT sweep.

(a) The plain twin of K6's d/dT part, ``rtrn.rt_sweep_ddt_vjp`` (the
    recursion of ``rtrn.ddt_adjoint``: lam from the top level down, the
    derivatives from the surface up, the surface seed's cotangents, then
    autograd of each layer's factors as the sweep forms them), against
    the plain vjp of the mode's plain sweep on a cotangent whose flux rows
    are zero and whose d/dT rows are seeded: clear, compact McICA,
    banded, maxrand (on the deck clouds and on ``band_clouds``' varied
    fractions), fused and cldf-odcld, each on columns with clouds and
    columns without (the clear twin taken and not), float64.  In the
    modes whose K1 SAVE keeps the d/dT derivatives at idrv=1 (every mode
    but clear; banded and maxrand also on the icld=2/3 fractions): the
    plain sweep's kept planes 4-5 are ``ddt_adjoint``'s forward P and PC
    and sum to the d/dT flux rows, and the twin reading them
    (``rt_sweep_ddt_vjp(..., rads=)``, ``ddt_adjoint(..., saved=)``)
    equals it running them from the seed; the CPU wrappers keep each
    mode's planes (``rtrn_cuda.rads_planes``).
(b) The gradient step at idrv=1 (``make_grad_step``, ``impl="cuda"``:
    the kernels' autograd Functions, whose backward on the CPU is the
    plain vjp of the 6-row cotangent; and ``impl="eager"``) against
    ``jax.value_and_grad`` of the JAX model (XLA engines) at idrv=1, in
    the same modes and maxrand at icld=3, w.r.t. every Atmosphere field
    and the cell's cloud fields (``CLOUD_GRADS`` + ``RADII_GRADS``
    banded, ``CLOUD_GRADS`` maxrand, ``MCICA_GRADS`` fused, cldfmc and
    taucmc cldf-odcld, the water paths and radii compact McICA), for a
    loss linear in uflx, duflx_dt and duflxc_dt and for one that reads
    duflx_dt alone (the flux rows' cotangent None), with seeded weights.

Tolerances: (a) 1e-12 of max |plain vjp| per output (the two sum in
other orders; measured ~3e-16); (b) 1e-12 relative on the loss and
1e-10 of max |JAX| per field, as ``tests/test_torch_grad_paths.py``.
One ``jax.value_and_grad`` compile per case (the loss's weights an
argument), at (B, L) = (4, 12).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu import types as jtypes

from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig,
                            McicaCloudsBlocked, McicaCloudsCompact,
                            make_model)
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.ops import cldprop, rtrn, rtrnmr, setcoef
from rrtmg_lw_torch.ops._autograd import plain_vjp
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.parallel import CLOUD_GRADS, make_grad_step
from rrtmg_lw_torch.utils import synthetic as tsyn
from test_torch_grad import noisy_atmosphere, rel_err
from test_torch_grad_paths import CASES, CFLAGS, SHAPE, TYPES
from test_torch_model import band_clouds

torch.set_num_threads(1)

# the outputs a loss reads: its name -> the Fluxes fields, linear in each
LOSSES = {"mixed": ("uflx", "duflx_dt", "duflxc_dt"),
          "ddt_only": ("duflx_dt",)}


# --------------------------------------------------------------- (a)

def _sweep_case(B=6, L=9):
    """The RT sweep's inputs at idrv=1 (surf (4, 16, B)) in float64 and
    each mode's clouds as ``rtrn.rt_sweep_ddt_vjp`` takes them; a third
    of the McICA columns and the first deterministic one cloud-free."""
    model = make_model(LWConfig(icld=2, imca=1, use_lut=False),
                       device="cpu")
    static = model.static_tensors()
    prof = inatm(Atmosphere.from_numpy(noisy_atmosphere(B, L), "cpu"))
    sc = setcoef.setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    play, plev = (setcoef.interp_planck_blocked(t.t().contiguous(),
                                                model.totplnk)
                  for t in (prof.tavel, prof.tz))
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm, tg.dtype,
                          sc.dplankbnd_dt)
    mc = McicaCloudsCompact.from_numpy(tsyn.make_mcica_clouds(
        B, L, mask_dtype=np.int8, clear_frac=1 / 3), "cpu")
    abi, abl = cldprop.ice_liq_coeffs_blocked(mc.reicmc, mc.relqmc, 3, 1,
                                              static)
    cw = torch.stack([mc.ciwp.t(), mc.clwp.t()], 1).contiguous()
    blk = McicaCloudsBlocked.from_numpy(tsyn.make_mcica_clouds(
        B, L, layout="blocked", clear_frac=1 / 3), "cpu")
    babi, babl = cldprop.ice_liq_coeffs_blocked(blk.reicmc, blk.relqmc, 3,
                                                1, static)
    tauc = blk._replace(taucmc=blk.cldfmc * (0.05 * blk.ciwpmc
                                             + 0.1 * blk.clwpmc))
    odc, cfc, _ = cldprop.cldprmc_blocked(tauc, static, inflag=0,
                                          iceflag=3, liqflag=1)
    nbc = tsyn.make_band_clouds(B, L)
    nbc = nbc._replace(cldfrac=np.where(np.arange(B)[:, None] == 0, 0.0,
                                        nbc.cldfrac))
    clouds = {"clear": (), "compact": (mc.cldfmc, cw, abi, abl),
              "fused": (*blk[:4], babi, babl), "cldf_od": (cfc, odc)}
    for tag, nb in (("decks", nbc), ("varied", band_clouds(B, L))):
        bc = BandClouds.from_numpy(nb, "cpu")
        taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                                  iceflag=3, liqflag=1)
        clouds["banded" if tag == "decks" else "banded_varied"] = (
            bc.cldfrac.t().contiguous(), taucb)
        clouds[f"maxrand_{tag}"] = (rtrnmr.overlap_rows(bc.cldfrac), taucb)
    return (tg, fr, play, plev, surf), clouds, model.ngb0, model.wg


@functools.lru_cache(maxsize=None)
def _cached_sweep_case():
    return _sweep_case()


def _plain_sweep(mode, cl, ngb0, wg):
    """The mode's plain sweep of the inputs (taut_t, fracs_t, planklay_t,
    planklev_t, surf, *differentiable clouds) and those clouds."""
    if mode in ("clear", "compact"):
        def fn(*a):
            return rtrn.rt_sweep_blocked(*a[:5], ngb0, wg,
                                         (cl[0], *a[5:]) if cl else None)
        return fn, cl[1:]
    return (lambda *a: rtrn.SWEEPS[mode](*a, ngb0, wg)), cl


@pytest.mark.parametrize("case", ["clear", "compact", "banded",
                                  "maxrand_decks", "maxrand_varied", "fused",
                                  "cldf_od"])
def test_ddt_adjoint_matches_plain_vjp(case):
    """``rtrn.rt_sweep_ddt_vjp`` equals the plain vjp of the mode's sweep
    on (0, 0, 0, 0, ct_ddt), per output, within 1e-12 of max |ref|; the
    surface temperature's row (surf 3) and the cloudy layers' inputs get
    a cotangent, the Planck rows none."""
    x, clouds, ngb0, wg = _cached_sweep_case()
    mode = case.split("_")[0] if case.startswith("maxrand") else case
    cl = clouds[case]
    L, _, B = x[0].shape
    ct_ddt = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, L + 1, B)))
    got = rtrn.rt_sweep_ddt_vjp(mode, *x, cl, ngb0, wg, ct_ddt)
    ct = torch.cat([torch.zeros((4, L + 1, B), dtype=ct_ddt.dtype), ct_ddt])
    fn, diff = _plain_sweep(mode, cl, ngb0, wg)
    xs = (*x, *diff)
    ref = plain_vjp(fn, xs, (True,) * len(xs), (ct,))
    if mode == "compact":
        assert got[5] is None       # the int8 mask: no gradient
        got = got[:5] + got[6:]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == torch.float64, (case, i)
        assert rel_err(g, r.numpy()) <= 1e-12, (case, i)
    assert bool(got[4][3].any()) and bool(got[0].any()), case
    assert not bool(got[2].any() or got[3].any()), case
    if mode != "clear":
        assert any(bool(g.any()) for g in got[5:]), case


def test_ddt_adjoint_twin_folds_where_no_cloud():
    """Where a column has no cloud the clear twin of the derivative is the
    derivative itself: its cotangent folds into the total-sky one's, so a
    column's cotangents depend on the sum of its two d/dT rows alone."""
    x, clouds, ngb0, wg = _cached_sweep_case()
    L, _, B = x[0].shape
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.standard_normal((2, L + 1, B)))
    b = torch.stack([a[0] + a[1], torch.zeros_like(a[1])])
    cl = clouds["banded"]
    ga = rtrn.rt_sweep_ddt_vjp("banded", *x, cl, ngb0, wg, a)
    gb = rtrn.rt_sweep_ddt_vjp("banded", *x, cl, ngb0, wg, b)
    clear = (cl[0] < rtrn.CLOUD_GATE).all(0)           # (B,)
    assert bool(clear.any()) and not bool(clear.all())
    for g, h in zip(ga, gb):
        np.testing.assert_allclose(g[..., clear].numpy(),
                                   h[..., clear].numpy(), rtol=1e-12,
                                   atol=1e-12 * float(h.abs().max()))
    assert not torch.allclose(ga[0][..., ~clear], gb[0][..., ~clear])


@pytest.mark.parametrize("case", ["clear", "compact", "banded",
                                  "maxrand_decks", "fused", "cldf_od"])
def test_ddt_wrappers_send_cpu_tensors_to_plain_versions(monkeypatch, case):
    """On CPU tensors the vjp wrappers (``rt_sweep_vjp``,
    ``rt_sweep_maxrand_vjp``, ``rt_sweep_banded_vjp``, ``rt_sweep_g_vjp``)
    with a d/dT cotangent run the plain vjp of the 6-row cotangent, zeros
    where the flux cotangent is None, never the kernel library, and count
    no launch."""
    from rrtmg_lw_torch import _build
    from rrtmg_lw_torch.ops import rtrn_cuda
    from rrtmg_lw_torch.utils.snapshot import ddt_state, ddt_vjp

    def no_kernels(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel library")
    monkeypatch.setattr(_build, "library", no_kernels)
    monkeypatch.setattr(_build, "launch", no_kernels)
    before = {m: c.launches for m, c in rtrn_cuda.DDT_LAUNCHES.items()}
    x, clouds, ngb0, wg = _cached_sweep_case()
    mode = case.split("_")[0] if case.startswith("maxrand") else case
    cl = clouds[case]
    L, _, B = x[0].shape
    rng = np.random.default_rng(5)
    ct, ct_ddt = (torch.as_tensor(rng.standard_normal((n, L + 1, B)))
                  for n in (4, 2))
    fn, diff = _plain_sweep(mode, cl, ngb0, wg)
    kw = ddt_state(mode, x, cl, ngb0, wg)
    for c, rows in ((ct, ct), (None, torch.zeros_like(ct))):
        got = [g for g in ddt_vjp(mode, x, cl, ngb0, wg, c, ct_ddt, kw)
               if g is not None]
        ref = plain_vjp(fn, (*x, *diff), (True,) * (5 + len(diff)),
                        (torch.cat([rows, ct_ddt]),))
        assert len(got) == len(ref), case
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), case
        assert got[4].shape == (4, 16, B), case
    assert {m: c.launches for m, c in rtrn_cuda.DDT_LAUNCHES.items()} \
        == before


# the modes whose K1 SAVE at idrv=1 keeps the d/dT derivatives for K6
# (``rtrn_cuda.KEEPS_DDT``), and banded and maxrand on the fractions the
# icld=2/3 cases use (``band_clouds``)
KEEPS = ["compact", "banded", "banded_varied", "maxrand_decks",
         "maxrand_varied", "fused", "cldf_od"]


def _kept(mode, x, cl, ngb0, wg):
    """The plain sweep of ``mode`` keeping its state at idrv=1: (fluxes
    (6, L+1, B), rads)."""
    if mode == "banded":
        return rtrn.rt_sweep_banded(*x, *cl, ngb0, wg, radiances=True)
    if mode == "maxrand":
        return rtrn.rt_sweep_maxrand(*x, *cl, ngb0, wg, radiances=True)[:2]
    return rtrn.rt_sweep_blocked(*x, ngb0, wg, cl, radiances=True)[:2]


def _case_mode(case):
    """The K1 mode of a ``KEEPS`` case."""
    return case.rsplit("_", 1)[0] if case.endswith(("_decks", "_varied")) \
        else case


def _forward_derivatives(mode, x, cl, ngb0):
    """``ddt_adjoint``'s forward derivatives P, PC entering each layer,
    run from the seed by ``_ddt_step`` on ``_ddt_factors``: (B, L, G)
    each."""
    at, atot, cf, cly, anyc, d0 = rtrn._ddt_factors(mode, *x, cl, ngb0)
    p = pc = d0
    ps, pcs = [], []
    for lev in range(at.shape[1]):
        ps.append(p)
        pcs.append(pc)
        p, pc = rtrn._ddt_step(p, pc, at[:, lev], atot[:, lev], cf[:, lev],
                               cly[:, lev], anyc)
    return torch.stack(ps, 1), torch.stack(pcs, 1)


@pytest.mark.parametrize("case", KEEPS)
def test_sweep_keeps_the_ddt_derivatives(case):
    """At idrv=1 the plain sweep with ``radiances=True`` keeps six planes in
    the modes whose K1 SAVE keeps the d/dT derivatives: planes 0-3 those
    of idrv=0 (maxrand: and its packed sub-streams), planes 4-5
    ``ddt_adjoint``'s forward P and PC entering each layer (within 1e-12
    of max |P|, float64), whose weighted sums over g at levels 0..L-1 are
    the duflx_dt and duflxc_dt rows (1e-12)."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    x, clouds, ngb0, wg = _cached_sweep_case()
    mode, cl = _case_mode(case), clouds[case]
    L, _, B = x[0].shape
    n0, n1 = (rtrn_cuda.rads_planes(mode, i) for i in (0, 1))
    fl, rads = _kept(mode, x, cl, ngb0, wg)
    assert rads.shape == (n1, L, 140, B) and fl.shape == (6, L + 1, B)
    _, rads0 = _kept(mode, (*x[:4], x[4][:3]), cl, ngb0, wg)
    assert rads0.shape == (n0, L, 140, B) and torch.equal(rads[:n0], rads0)
    if mode == "maxrand":
        subs, subs0 = (rtrn.rt_sweep_maxrand(*xi, *cl, ngb0, wg,
                                             radiances=True)[2]
                       for xi in (x, (*x[:4], x[4][:3])))
        assert torch.equal(subs, subs0), case
    p, pc = _forward_derivatives(mode, x, cl, ngb0)
    for got, want in ((rads[4], p), (rads[5], pc)):
        assert rel_err(got, want.permute(1, 2, 0).numpy()) <= 1e-12, case
    sums = torch.einsum("plgb,g->pbl", rads[4:], wg)
    for i in (0, 1):
        assert rel_err(sums[i].t(), fl[4 + i, :L].numpy()) <= 1e-12, case
    # both twins differ somewhere (a cloudy column), agree where none is
    # (every column of the varied fractions is cloudy)
    anyc = rtrn._ddt_factors(mode, *x, cl, ngb0)[4][:, 0]
    assert bool(anyc.any()) and bool(anyc.all()) == case.endswith("_varied")
    assert torch.equal(rads[4][..., ~anyc], rads[5][..., ~anyc]), case
    assert not torch.equal(rads[4][..., anyc], rads[5][..., anyc]), case


@pytest.mark.parametrize("case", KEEPS)
def test_ddt_adjoint_reads_the_saved_derivatives(case):
    """``rtrn.rt_sweep_ddt_vjp`` reading the derivatives the sweep kept
    (``rads``, as K6 reads K1 SAVE's d/dT planes) equals it running them
    from the seed, per output within 1e-12 of max |ref|, and does not
    read the clear twin where a column has no cloud: NaN there changes
    nothing."""
    x, clouds, ngb0, wg = _cached_sweep_case()
    mode, cl = _case_mode(case), clouds[case]
    L, _, B = x[0].shape
    ct_ddt = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (2, L + 1, B)))
    _, rads = _kept(mode, x, cl, ngb0, wg)
    ref = rtrn.rt_sweep_ddt_vjp(mode, *x, cl, ngb0, wg, ct_ddt)
    got = rtrn.rt_sweep_ddt_vjp(mode, *x, cl, ngb0, wg, ct_ddt, rads=rads)
    anyc = rtrn._ddt_factors(mode, *x, cl, ngb0)[4][:, 0]
    nan = rads.clone()
    nan[5][..., ~anyc] = float("nan")
    got_nan = rtrn.rt_sweep_ddt_vjp(mode, *x, cl, ngb0, wg, ct_ddt,
                                    rads=nan)
    assert len(got) == len(ref) == len(got_nan)
    for i, (g, r, h) in enumerate(zip(got, ref, got_nan)):
        if r is None:
            assert g is None and h is None
            continue
        assert rel_err(g, r.numpy()) <= 1e-12, (case, i)
        assert torch.equal(g, h), (case, i)
    assert bool(got[4][3].any()), case


def test_ddt_adjoint_saved_matches_unsaved():
    """``rtrn.ddt_adjoint`` given the forward derivatives (``saved``)
    equals it without them, on each mode's factors, within 1e-12 of
    max |ref| per cotangent."""
    x, clouds, ngb0, wg = _cached_sweep_case()
    L, _, B = x[0].shape
    ct_ddt = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (2, L + 1, B)))
    for case in KEEPS:
        mode, cl = _case_mode(case), clouds[case]
        at, atot, cf, cly, anyc, d0 = rtrn._ddt_factors(mode, *x, cl, ngb0)
        args = (at.detach(), atot.detach(), cf.detach(), cly, anyc,
                d0.detach(), wg, ct_ddt)
        saved = _forward_derivatives(mode, x, cl, ngb0)
        ref = rtrn.ddt_adjoint(*args)
        got = rtrn.ddt_adjoint(*args, saved=tuple(t.detach()
                                                  for t in saved))
        for i, (g, r) in enumerate(zip(got, ref)):
            assert rel_err(g, r.numpy()) <= 1e-12, (case, i)
            assert bool(r.any()), (case, i)


@pytest.mark.parametrize("mode", ["clear", "compact", "banded", "maxrand",
                                  "fused", "cldf_od"])
def test_cpu_sweeps_keep_the_planes_of_each_mode(mode):
    """On CPU tensors K1 SAVE's wrappers (``rt_sweep_radiances``,
    ``rt_sweep_g_radiances``, ``rt_sweep_maxrand_radiances``) return the
    planes ``rtrn_cuda.rads_planes`` gives at idrv 0 and 1: 6 at idrv=1 in
    the cloudy modes (the last two the d/dT derivatives; maxrand's beside
    its packed sub-streams), 4 at idrv=0 there; clear 2 at both."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    x, clouds, ngb0, wg = _cached_sweep_case()
    L, _, B = x[0].shape
    cl = clouds["maxrand_decks" if mode == "maxrand" else mode]
    want = (2, 2) if mode == "clear" else (4, 6)
    for idrv in (0, 1):
        xi = (*x[:4], x[4][:3 + idrv])
        if mode in ("clear", "compact"):
            f = (None,) * 4 if mode == "clear" else (*cl[1:], cl[0])
            rads = rtrn_cuda.rt_sweep_radiances(*xi, *f, ngb0, wg)[1]
        elif mode == "maxrand":
            rads = rtrn_cuda.rt_sweep_maxrand_radiances(*xi, *cl, ngb0,
                                                        wg)[1]
        else:
            rads = rtrn_cuda.rt_sweep_g_radiances(mode, *xi, cl, ngb0,
                                                  wg)[1]
        assert rads.shape == (want[idrv], L, 140, B), (mode, idrv)
        assert rtrn_cuda.rads_planes(mode, idrv) == want[idrv]


# --------------------------------------------------------------- (b)

def _clear():
    return dict(icld=0, imca=1), None, (), None


def _maxrand(icld):
    return (dict(icld=icld, imca=0, inflag=2), band_clouds(*SHAPE),
            CLOUD_GRADS, jtypes.BandClouds)


DDT_CASES = {"clear": _clear, **CASES,
             "maxrand": functools.partial(_maxrand, 2),
             "maxrand_icld3": functools.partial(_maxrand, 3)}
DDT_TYPES = dict(TYPES, maxrand=BandClouds, maxrand_icld3=BandClouds)


def _weights(B, L, seed=11):
    """Seeded weights of the linear losses, per Fluxes field (B, L+1)."""
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((B, L + 1)) for n in LOSSES["mixed"]}


@functools.lru_cache(maxsize=None)
def _jax(kind):
    """``jax.value_and_grad`` of the JAX model at idrv=1 for each loss of
    ``LOSSES`` on noisy_atmosphere and the kind's clouds: -> (the JAX
    model, natm, clouds, fields, cfg, {loss: (value, Atmosphere grads,
    cloud grads)})."""
    B, L = SHAPE
    cfg, clouds, fields, jtype = DDT_CASES[kind]()
    jm = jmake_model(JConfig(taumol_impl="xla", rt_impl="xla", idrv=1,
                             **CFLAGS, **cfg))
    natm = noisy_atmosphere(B, L)

    def jloss(a, cw, w):
        cl = None if jtype is None else jtype(
            *(jnp.asarray(x) for x in clouds))._replace(**cw)
        fl = jm(a, cl)
        return sum((w[n] * getattr(fl, n)).sum() for n in w)

    step = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))
    a = jax.tree_util.tree_map(jnp.asarray, natm)
    cw = {k: jnp.asarray(getattr(clouds, k)) for k in fields}
    w = _weights(B, L)
    out = {}
    for loss, names in LOSSES.items():
        ws = {n: jnp.asarray(w[n] if n in names else 0.0 * w[n])
              for n in LOSSES["mixed"]}
        jl, (ja, jc) = step(a, cw, ws)
        out[loss] = (float(jl), ja, jc)
    return jm, natm, clouds, fields, cfg, out


@pytest.mark.parametrize("kind", ["clear", "compact", "banded", "maxrand",
                                  "maxrand_icld3", "fused", "cldf_od"])
def test_ddt_grad_step_matches_jax_value_and_grad(kind):
    """The idrv=1 gradient step of a loss linear in uflx, duflx_dt and
    duflxc_dt, and of one reading duflx_dt alone, through the kernels'
    Functions (``impl="cuda"`` on the CPU) and through the plain versions,
    against ``jax.value_and_grad`` of the JAX model: the loss and every
    Atmosphere and cloud field's gradient."""
    jm, natm, clouds, fields, cfg, ref = _jax(kind)
    B, L = SHAPE
    tables = tables_from_numpy(jm.ktables, jm.static_np, device="cpu")
    atm = Atmosphere.from_numpy(natm, "cpu")
    cl = None if clouds is None else DDT_TYPES[kind].from_numpy(clouds,
                                                                "cpu")
    w = {n: torch.as_tensor(v) for n, v in _weights(B, L).items()}
    for impl in ("cuda", "eager"):
        model = make_model(LWConfig(idrv=1, **CFLAGS, **cfg), device="cpu",
                           tables=tables)
        model.impl = impl          # "cuda": the Functions, on the CPU
        for loss, names in LOSSES.items():
            def fn(f, names=names):
                return sum((w[n] * getattr(f, n)).sum() for n in names)
            out = make_grad_step(model, fn, cloud_fields=fields)(atm, cl)
            lv, g, gc = out if fields else (*out, ())
            jl, ja, jc = ref[loss]
            assert abs(float(lv) - jl) <= 1e-12 * abs(jl), (impl, loss)
            for name in Atmosphere._fields:
                assert rel_err(getattr(g, name), getattr(ja, name)) \
                    <= 1e-10, (kind, impl, loss, name)
            for name, got in zip(fields, gc):
                assert rel_err(got, jc[name]) <= 1e-10, (kind, impl, loss,
                                                         name)
            # the d/dT terms reach the surface temperature
            assert bool((g.tsfc != 0).any()), (kind, impl, loss)
