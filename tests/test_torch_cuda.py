"""The CUDA kernels of rrtmg_lw_torch against their plain PyTorch
versions on the card, at small and ragged shapes (chip_smoke.py covers
the main-path shapes), plus the wrappers' input checks and launch
counters: the four forward kernels (K1 in its clear, compact, banded,
maxrand, fused and cldf-odcld modes, each at idrv 0 and 1), the
overlap-rows kernel, and the three backward kernels (K3b Planck slope,
K5 taumol, K6 RT adjoint) against the plain vjps; K6 is fed the
radiances of K1's gradient-step launch (``rt_sweep_radiances``), whose
fluxes are bitwise those of K1's launch without them and whose
radiances are within 1e-5 of max |plain radiance|.

Marked ``cuda``: every test skips without a CUDA device.  This file
imports no JAX, so it also runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are chip_smoke.py's: 1e-6 relative (Planck, cloud
coefficients), 3.05e-5 (taug relative with |ref| floored at 1e-2,
fracs absolute) with every interpolation bin equal, 2e-5 of each
column's max |flux| (RT sweep, model); the overlap rows: the discrete
rows equal and the factors within 1e-6 of max |plain| (the same
elementwise f32 arithmetic).  Backward kernels (the same f32
math summed in another order): 1e-4 of max |plain| per output (K3b,
K5), 1e-3 (K6, a recurrence over the levels); the model's gradients
2e-2 of max |eager| per Atmosphere field (the gate the JAX package
holds its kernel backward to, tests/test_taumol_bwd.py:101).

Reduced spectral storage (RRTMG_SPEC_DTYPE, K7): K2 in bf16 / f16 equal
to the plain encode of its own float32 output, logu16 codes at most one
apart (logf against torch.log); K1 in every mode x idrv x storage within
2e-5 of the plain decode + aerosol add + sweep, bitwise over two runs, on
a seeded aerosol od that a dropped or misread add would fail.  K1's 48
instantiations on its edge cases (utils/snapshot.py k1_edge_args) at B
of K1's 16-column tile +-1 and off 16, L = 1, past the ring and 140, and
its launch configuration (at least two blocks per SM), K6's (256
threads, at least two blocks per SM, no spill) and K5's (128 threads,
at least MIN_BLOCKS blocks per SM, no spill); K5 also at B off, on and
past its 128-column tile, and refusing a descriptor of another band
structure, as K2 does.  The probes
(utils/probes.py) bitwise equal to tbl[idx].
"""

import functools

import numpy as np
import pytest
import torch

from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig,
                            McicaCloudsBlocked, McicaCloudsCompact,
                            make_model)
from rrtmg_lw_torch.ops import cldprop, rtrn, rtrnmr
from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.ops.planck_cuda import (planck_interp_blocked,
                                            planck_interp_vjp)
from rrtmg_lw_torch.ops.rtrn_cuda import (WRAPPERS, rt_fluxes_banded,
                                          rt_fluxes_blocked, rt_fluxes_maxrand,
                                          rt_sweep_radiances, rt_sweep_vjp)
from rrtmg_lw_torch.ops.rtrnmr_cuda import overlap_rows
from rrtmg_lw_torch.ops.setcoef import (interp_planck_blocked,
                                        interp_planck_vjp, setcoef)
from rrtmg_lw_torch.ops.taumol_cuda import (DESC_FIELDS, NBIN, TaumolFn,
                                            _pack_inputs, _unpack_inputs,
                                            taumol_blocked, taumol_packed,
                                            taumol_packed_vjp, taumol_vjp)
from rrtmg_lw_torch.parallel import make_grad_step
from rrtmg_lw_torch.utils.snapshot import (K2_EDGE_SHAPES, K5_BOOST,
                                           k2_edge_args)
from rrtmg_lw_torch.utils.synthetic import (make_atmosphere,
                                            make_band_clouds,
                                            make_mcica_clouds)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda", 0)


def _model(dev, icld=2, impl="cuda"):
    return make_model(LWConfig(icld=icld, imca=1, dtype="float32",
                               use_lut=False, impl=impl), device=dev)


def _case(dev, B, L, clear_frac=0.0, boost=None, aod=0.0):
    atm = Atmosphere.from_numpy(make_atmosphere(B, L, seed=B + L, aod=aod),
                                dev, torch.float32)
    clouds = McicaCloudsCompact.from_numpy(
        make_mcica_clouds(B, L, seed=L, mask_dtype=np.int8,
                          clear_frac=clear_frac), dev, torch.float32)
    prof = inatm(atm, torch.float32)
    if boost is not None:
        prof = prof._replace(wkl=prof.wkl * torch.as_tensor(
            boost, dtype=torch.float32, device=dev))
    return atm, clouds, prof


def flux_err(a, b):
    diff = (a.double() - b.double()).abs().flatten(0, -2).amax(0)
    scale = a.double().abs().flatten(0, -2).amax(0).clamp(min=1.0)
    return float((diff / scale).max())


@pytest.mark.parametrize("N,B", [(1, 1), (7, 37), (61, 300)])
def test_planck_kernel_matches_plain(dev, N, B):
    model = _model(dev)
    temp = 150.0 + 200.0 * torch.rand((N, B), device=dev)   # both clamps
    got = planck_interp_blocked(temp, model.totplnk)
    ref = interp_planck_blocked(temp, model.totplnk)
    assert got.shape == (N, 16, B)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-6


@pytest.mark.parametrize("iceflag", [2, 3])
def test_cldcoef_kernel_matches_plain(dev, iceflag):
    model = _model(dev)
    reic = torch.cat([torch.linspace(1.0, 150.0, 300),
                      torch.tensor([5.0, 131.0, 140.0, 3 * 46 + 2.0])])
    relq = torch.cat([torch.linspace(0.5, 65.0, 300),
                      torch.tensor([1.5, 2.0, 59.5, 60.0])])
    reic = reic.reshape(8, 38).to(dev)
    relq = relq.reshape(8, 38).to(dev)
    static = model.static_tensors()
    got = ice_liq_coeffs_blocked(reic, relq, iceflag, 1, static)
    ref = cldprop.ice_liq_coeffs_blocked(reic, relq, iceflag, 1, static)
    for g, r in zip(got, ref):
        assert g.shape == (38, 16, 8)
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-6


@pytest.mark.parametrize("spec", ["f32", "bf16", "f16", "logu16"])
@pytest.mark.parametrize("B,L,boost", [
    (37, 23, None), (1, 60, None), (64, 40, K5_BOOST),
    *((B, L, "edge") for B, L in K2_EDGE_SHAPES)])
def test_taumol_kernel_matches_plain(dev, B, L, boost, spec):
    """K2 against the plain engine (bins equal), on setcoef's output or
    on K2's edge inputs (``k2_edge_args``); in a reduced storage, against
    the plain encode of K2's own float32 output (bf16 / f16 bitwise,
    logu16 codes at most one apart: logf against torch.log)."""
    from rrtmg_lw_torch.ops.spec_codec import (SPEC_DTYPES, spec_order,
                                               spec_store)
    model = _model(dev)
    if boost == "edge":
        fld, ifld, _ = k2_edge_args(dev, model, B, L)
    else:
        _, _, prof = _case(dev, B, L, boost=boost)
        fld, ifld = _pack_inputs(
            setcoef(prof, model.static_tensors(), planck=False), prof)
    run = functools.partial(TaumolFn.apply, fld, ifld, model.engine,
                            model.kernel_tabs, model.kernel_desc)
    bins = torch.empty((16, NBIN, L, B), dtype=torch.int32, device=dev)
    tg, fr = run(bins, torch.float32)
    tg_p, fr_p = taumol_packed(model.engine, fld, ifld)
    assert torch.equal(bins, model.engine.bins(*_unpack_inputs(fld, ifld)))
    e_t = ((tg.double() - tg_p.double()).abs()
           / tg_p.double().abs().clamp(min=1e-2)).max()
    assert float(e_t) <= 3.05e-5
    assert float((fr - fr_p).abs().max()) <= 3.05e-5
    if spec != "f32":
        sdt = SPEC_DTYPES[spec]
        bins_s = torch.empty_like(bins)
        for k, x, which in zip(run(bins_s, sdt), (tg, fr), ("tg", "fr")):
            assert k.dtype == sdt and k.shape == (L, 140, B)
            d = (spec_order(k) - spec_order(spec_store(x, sdt, which))).abs()
            assert int(d.max()) <= (1 if spec == "logu16" else 0), spec
        assert torch.equal(bins_s, bins)


def test_taumol_kernel_refuses_other_band_structure(dev):
    """K2 compiles in the descriptor words that BAND_SPECS fixes: its
    wrapper raises on a descriptor whose such word differs (band 1
    lower's ng here), also after an in-place change to one it took."""
    model = _model(dev)
    _, _, prof = _case(dev, 5, 3)
    fld, ifld = _pack_inputs(
        setcoef(prof, model.static_tensors(), planck=False), prof)
    desc = model.kernel_desc.clone()

    def run():
        return TaumolFn.apply(fld, ifld, model.engine, model.kernel_tabs,
                              desc, None, torch.float32)

    run()
    desc[0, 0, DESC_FIELDS.index("NGB")] += 2
    with pytest.raises(RuntimeError, match="NGB of band 1"):
        run()


@pytest.mark.parametrize("B,L,clear_frac", [(37, 13, 0.0), (5, 1, 0.0),
                                            (96, 30, 0.5)])
def test_rt_kernel_matches_plain(dev, B, L, clear_frac):
    model = _model(dev)
    _, clouds, prof = _case(dev, B, L, clear_frac=clear_frac)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    play = interp_planck_blocked(prof.tavel.t().contiguous(), model.totplnk)
    plev = interp_planck_blocked(prof.tz.t().contiguous(), model.totplnk)
    abi, abl = cldprop.ice_liq_coeffs_blocked(clouds.reicmc, clouds.relqmc,
                                              3, 1, static)
    cw = torch.stack([clouds.ciwp.t(), clouds.clwp.t()], 1).contiguous()
    for fields in (None, (clouds.cldfmc, cw, abi, abl)):
        args = (tg, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
                model.ngb0, model.wg, fields)
        got = rt_fluxes_blocked(*args)
        ref = rtrn.rt_fluxes_blocked(*args)
        assert got.shape == (4, L + 1, B)
        assert torch.isfinite(got).all()
        assert flux_err(ref, got) <= 2e-5


@pytest.mark.parametrize("icld", [0, 2])
def test_model_cuda_matches_eager(dev, icld):
    atm, clouds, _ = _case(dev, 200, 30)
    cl = clouds if icld else None
    fk = _model(dev, icld)(atm, cl)
    fe = _model(dev, icld, impl="eager")(atm, cl)
    for name in ("uflx", "dflx", "uflxc", "dflxc"):
        assert flux_err(getattr(fe, name).t(), getattr(fk, name).t()) <= 2e-5
    if icld:
        assert torch.equal(fk.cld_bounds_ok, fe.cld_bounds_ok)


def test_launch_counters_count_kernel_launches(dev):
    wrappers = (taumol_blocked, planck_interp_blocked,
                ice_liq_coeffs_blocked, rt_fluxes_blocked)
    atm, clouds, _ = _case(dev, 64, 10)
    before = [w.launches for w in wrappers]
    _model(dev, 2)(atm, clouds)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 2, 1, 1]
    before = [w.launches for w in wrappers]
    _model(dev, 2, impl="eager")(atm, clouds)
    assert [w.launches for w in wrappers] == before


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    model = _model(dev)
    temp = torch.full((3, 8), 250.0, device=dev)
    with pytest.raises(TypeError):
        planck_interp_blocked(temp.double(), model.totplnk)
    with pytest.raises(ValueError):
        planck_interp_blocked(torch.full((8, 3), 250.0, device=dev).t(),
                              model.totplnk)
    with pytest.raises(ValueError):
        planck_interp_blocked(temp, model.totplnk[:100])
    with pytest.raises(NotImplementedError):
        ice_liq_coeffs_blocked(temp, temp, 0, 1, model.static_tensors())
    with pytest.raises(ValueError):
        make_model(LWConfig(icld=0, use_lut=False, impl="cuda"), device=dev)


def rel_err(got, ref):
    """max |got - ref| / max |ref| (0 when both are all zero)."""
    scale = float(ref.double().abs().max())
    diff = float((got.double() - ref.double()).abs().max())
    return diff / scale if scale > 0 else diff


def _randn(shape, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@pytest.mark.parametrize("N,B", [(1, 1), (7, 37), (61, 300)])
def test_planck_bwd_kernel_matches_plain_vjp(dev, N, B):
    model = _model(dev)
    temp = 150.0 + 200.0 * torch.rand((N, B), device=dev)   # both clamps
    ct = _randn((N, 16, B), dev, N + B)
    got = planck_interp_vjp(temp, model.totplnk, ct)
    ref = interp_planck_vjp(temp, model.totplnk, ct)
    assert got.shape == (N, B)
    assert rel_err(got, ref) <= 1e-4
    assert torch.equal(got, planck_interp_vjp(temp, model.totplnk, ct))


@pytest.mark.parametrize("B,L,boost", [
    (37, 7, None), (5, 1, None), (70, 7, K5_BOOST),
    *((B, L, None) for B in (1, 127, 128, 129, 300) for L in (1, 60))])
def test_taumol_bwd_kernel_matches_plain_vjp(dev, B, L, boost):
    """K5 against the plain vjp, per field, and bitwise over two runs;
    B off, on and past K5's 128-column tile, one layer and 60."""
    model = _model(dev)
    _, _, prof = _case(dev, B, L, boost=boost)
    sc = setcoef(prof, model.static_tensors(), planck=False)
    fld, ifld = _pack_inputs(sc, prof)
    ct_t = _randn((L, 140, B), dev, 1)
    ct_f = _randn((L, 140, B), dev, 2)
    args = (fld, ifld, model.engine, model.kernel_tabs, model.kernel_desc,
            ct_t, ct_f)
    got = taumol_vjp(*args)
    ref = taumol_packed_vjp(model.engine, fld, ifld, ct_t, ct_f)
    assert got.shape == fld.shape and torch.isfinite(got).all()
    for f in range(fld.shape[0]):
        assert rel_err(got[f], ref[f]) <= 1e-4, f
    assert torch.equal(got, taumol_vjp(*args))


def test_taumol_bwd_launch_configuration(dev):
    """K5 runs at its launch bounds: 128 threads for 128 columns, at
    least MIN_BLOCKS blocks per SM (csrc/taumol_bwd.cu), no local
    memory (no spill)."""
    import pathlib
    import re
    from rrtmg_lw_torch.ops.taumol_cuda import k5_info
    src = (pathlib.Path(__file__).resolve().parents[1] / "rrtmg_lw_torch"
           / "csrc" / "taumol_bwd.cu").read_text()
    min_blocks = int(re.search(r"\nconstexpr int MIN_BLOCKS = (\d+);",
                               src).group(1))
    info = k5_info()
    assert info["threads"] == 128 and info["columns"] == 128, info
    assert info["blocks_per_sm"] >= min_blocks, info
    assert info["registers"] <= 65536 // (128 * min_blocks), info
    assert info["local_bytes"] == 0, info
    assert info["static_smem"] <= 48 * 1024, info


def test_taumol_vjp_refuses_other_band_structure(dev):
    """K5 compiles in the descriptor words that BAND_SPECS fixes: its
    wrapper raises on a descriptor whose such word differs (band 1
    lower's ng here), also after an in-place change to one it took."""
    model = _model(dev)
    _, _, prof = _case(dev, 5, 3)
    fld, ifld = _pack_inputs(
        setcoef(prof, model.static_tensors(), planck=False), prof)
    cts = (_randn((3, 140, 5), dev, 1), _randn((3, 140, 5), dev, 2))
    desc = model.kernel_desc.clone()

    def run():
        return taumol_vjp(fld, ifld, model.engine, model.kernel_tabs, desc,
                          *cts)

    run()
    desc[0, 0, DESC_FIELDS.index("NGB")] += 2
    with pytest.raises(RuntimeError, match="NGB of band 1"):
        run()


def _k6_case(dev, args, fields, seed=3):
    """K1 keeping the radiances and K6 fed them, on the sweep inputs
    ``args`` (taut_t, fracs_t, planklay_t, planklev_t, plankbnd, semiss,
    pwvcm, ngb0, wg) with compact ``fields`` (mask, cw, abi, abl) or
    None: K1's fluxes bitwise those of its launch without the radiances,
    the radiances within 1e-5 of max |plain|; K6 within 1e-3 of max
    |plain vjp| per output and bitwise over two runs; K6 without the
    radiances raises."""
    taut, fr, play, plev, plankbnd, semiss, pwvcm, ngb0, wg = args
    L, _, B = taut.shape
    surf = rtrn.surf_rows(plankbnd, semiss, pwvcm, torch.float32)
    cf = (None,) * 4 if fields is None else (*fields[1:], fields[0])
    a = (taut, fr, play, plev, surf, *cf, ngb0, wg)
    fl, rads = rt_sweep_radiances(*a)
    assert rads.shape == (2 if fields is None else 4, L, 140, B)
    assert torch.equal(fl, rt_fluxes_blocked(*args, fields))
    _, rads_p = rtrn.rt_sweep_blocked(*a[:5], ngb0, wg, fields,
                                      radiances=True)
    assert rel_err(rads, rads_p) <= 1e-5
    ct = _randn((4, L + 1, B), dev, seed)
    with pytest.raises(ValueError, match="radiances"):
        rt_sweep_vjp(*a, ct)
    got = rt_sweep_vjp(*a, ct, rads=rads)
    ref = rtrn.rt_sweep_vjp(*a, ct)
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            assert g is None and fields is None
            continue
        assert g.shape == r.shape and torch.isfinite(g).all(), i
        assert rel_err(g, r) <= 1e-3, i
    again = rt_sweep_vjp(*a, ct, rads=rads)
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("B,L,cloudy", [(37, 7, True), (5, 1, True),
                                        (45, 7, False), (1, 7, True)])
def test_rt_bwd_kernel_matches_plain_vjp(dev, B, L, cloudy):
    model = _model(dev)
    _, clouds, prof = _case(dev, B, L, clear_frac=0.3)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    play = interp_planck_blocked(prof.tavel.t().contiguous(), model.totplnk)
    plev = interp_planck_blocked(prof.tz.t().contiguous(), model.totplnk)
    abi, abl = cldprop.ice_liq_coeffs_blocked(clouds.reicmc, clouds.relqmc,
                                              3, 1, static)
    cw = torch.stack([clouds.ciwp.t(), clouds.clwp.t()], 1).contiguous()
    _k6_case(dev, (tg, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
                   model.ngb0, model.wg),
             (clouds.cldfmc, cw, abi, abl) if cloudy else None)


@pytest.mark.parametrize("B,L", [(15, 5), (33, 9), (100, 140), (16, 7),
                                 (17, 7), (32, 60)])
def test_rt_bwd_kernel_on_k1_edge_cases(dev, B, L):
    """K1 keeping the radiances and K6 on ``utils.snapshot.k1_edge_args``
    (clear, overcast and top-and-bottom columns across the tiles, od
    exactly 0.06 and 0), clear and compact, with ``_k6_case``'s checks:
    B off K6's 16-column tile, one full tile, one column past it and two
    full tiles at the cells' depth; L = 140 is past the ring."""
    from rrtmg_lw_torch.utils.snapshot import k1_edge_args
    args, _, _ = _sweep_inputs(dev, B, L)
    args, modes, _ = k1_edge_args(dev, _model(dev).static_tensors(), args)
    for fields in (None, modes["compact"][1][0]):
        _k6_case(dev, args, fields, seed=B + L)


def test_rt_save_launches_once_per_grad_step(dev):
    """K1 keeps the radiances once in a gradient step (clear, McICA, and
    at idrv=1) and never in a forward step, nor under torch.no_grad."""
    from rrtmg_lw_torch.ops.rtrn_cuda import k1_info
    atm, clouds, _ = _case(dev, 40, 10)
    save = rt_fluxes_blocked.save
    for icld, idrv in ((0, 0), (2, 0), (2, 1)):
        model = make_model(LWConfig(icld=icld, imca=1, idrv=idrv,
                                    dtype="float32", use_lut=False),
                           device=dev)
        cl = clouds if icld else None
        before = (save.launches, rt_fluxes_blocked.launches)
        model(atm, cl)
        tlay = atm.tlay.clone().requires_grad_()
        with torch.no_grad():
            model(atm._replace(tlay=tlay), cl)
        assert (save.launches, rt_fluxes_blocked.launches) == \
            (before[0], before[1] + 2)
        make_grad_step(model)(atm, cl)
        assert (save.launches, rt_fluxes_blocked.launches) == \
            (before[0] + 1, before[1] + 3)
    for mode in ("clear", "compact"):
        for idrv in (0, 1):
            info = k1_info(mode, idrv, save=True)
            assert info["local_bytes"] == 0, (mode, idrv, info)
            assert info["blocks_per_sm"] >= 2, (mode, idrv, info)
    with pytest.raises(RuntimeError):
        k1_info("banded", 0, save=True)


def test_cldcoef_guard_raises_when_radii_require_grad(dev):
    model = _model(dev)
    reic = torch.full((4, 3), 30.0, device=dev, requires_grad=True)
    relq = torch.full((4, 3), 10.0, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ice_liq_coeffs_blocked(reic, relq, 3, 1, model.static_tensors())
    with torch.no_grad():
        ice_liq_coeffs_blocked(reic, relq, 3, 1, model.static_tensors())


@pytest.mark.parametrize("icld", [0, 2])
def test_model_cuda_backward_matches_eager(dev, icld):
    atm, clouds, _ = _case(dev, 67, 20)
    cl = clouds if icld else None
    tlay = atm.tlay.clone().requires_grad_()
    fl = _model(dev, icld)(atm._replace(tlay=tlay), cl)
    ((fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()).backward()
    assert tlay.grad is not None
    wrappers = (taumol_vjp, planck_interp_vjp, rt_sweep_vjp)
    before = [w.launches for w in wrappers]
    _, g_k = make_grad_step(_model(dev, icld))(atm, cl)
    # Planck at layer and at level temperatures
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 2, 1]
    assert rel_err(g_k.tlay, tlay.grad) <= 1e-6
    _, g_e = make_grad_step(_model(dev, icld, impl="eager"))(atm, cl)
    for name in Atmosphere._fields:
        assert rel_err(getattr(g_k, name), getattr(g_e, name)) <= 2e-2, name


def _band_clouds(dev, B, L, pattern):
    """make_band_clouds with the cloud fraction replaced by ``pattern``:
    "decks" (the generator's), "clear", "overcast" (cldfrac 1 in every
    layer) or "mixed" (random fractions, clear and overcast columns)."""
    bc = make_band_clouds(B, L, seed=L)
    rng = np.random.default_rng(B + L)
    cf = bc.cldfrac
    if pattern == "clear":
        cf = np.zeros_like(cf)
    elif pattern == "overcast":
        cf = np.ones_like(cf)
    elif pattern == "mixed":
        cf = rng.random(cf.shape) * (rng.random(cf.shape) < 0.5)
        cf[::3] = 0.0
        cf[1::5] = 1.0
    bc = bc._replace(cldfrac=cf, clwp=np.where(cf > 0, 20.0, 0.0),
                     ciwp=np.where(cf > 0.5, 5.0, 0.0))
    return BandClouds.from_numpy(bc, dev, torch.float32)


@pytest.mark.parametrize("B,L,pattern", [(37, 13, "decks"), (5, 1, "mixed"),
                                         (3, 2, "overcast"), (33, 7, "clear"),
                                         (96, 30, "mixed")])
def test_overlap_kernel_matches_plain(dev, B, L, pattern):
    cf = _band_clouds(dev, B, L, pattern).cldfrac
    got, ref = overlap_rows(cf), rtrnmr.overlap_rows(cf)
    assert got.shape == (L, 16, B)
    assert torch.equal(got[:, :4], ref[:, :4])
    assert rel_err(got[:, 4:], ref[:, 4:]) <= 1e-6
    assert torch.equal(got, overlap_rows(cf))


@pytest.mark.parametrize("B,L,pattern", [(37, 13, "decks"), (5, 1, "mixed"),
                                         (3, 2, "overcast"), (33, 7, "clear"),
                                         (96, 30, "mixed")])
def test_rt_band_modes_match_plain(dev, B, L, pattern):
    model = _model(dev)
    _, _, prof = _case(dev, B, L)
    bc = _band_clouds(dev, B, L, pattern)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    play = interp_planck_blocked(prof.tavel.t().contiguous(), model.totplnk)
    plev = interp_planck_blocked(prof.tz.t().contiguous(), model.totplnk)
    taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                              iceflag=3, liqflag=1)
    args = (tg, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
            model.ngb0, model.wg)
    for kern, plain, cld in (
            (rt_fluxes_banded, rtrn.rt_fluxes_banded,
             bc.cldfrac.t().contiguous()),
            (rt_fluxes_maxrand, rtrn.rt_fluxes_maxrand,
             rtrnmr.overlap_rows(bc.cldfrac))):
        got = kern(*args, cld, taucb)
        ref = plain(*args, cld, taucb)
        assert got.shape == (4, L + 1, B) and torch.isfinite(got).all()
        assert flux_err(ref, got) <= 2e-5
        assert torch.equal(got, kern(*args, cld, taucb))


@pytest.mark.parametrize("icld", [1, 2, 3])
def test_model_band_clouds_cuda_matches_eager(dev, icld):
    atm, _, _ = _case(dev, 200, 30)
    bc = _band_clouds(dev, 200, 30, "decks")
    cfg = dict(icld=icld, imca=0, dtype="float32", use_lut=False)
    wrappers = (taumol_blocked, planck_interp_blocked, ice_liq_coeffs_blocked,
                rt_fluxes_blocked, rt_fluxes_banded, rt_fluxes_maxrand,
                overlap_rows)
    before = [w.launches for w in wrappers]
    fk = make_model(LWConfig(**cfg), device=dev)(atm, bc)
    mr = int(icld > 1)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [1, 2, 1, 0, 1 - mr, mr, mr]
    fe = make_model(LWConfig(impl="eager", **cfg), device=dev)(atm, bc)
    for name in ("uflx", "dflx", "uflxc", "dflxc"):
        assert flux_err(getattr(fe, name).t(), getattr(fk, name).t()) <= 2e-5
    assert torch.equal(fk.cld_bounds_ok, fe.cld_bounds_ok)
    assert not torch.allclose(fk.uflx, fk.uflxc)


@pytest.mark.parametrize("icld", [1, 2])
def test_band_clouds_backward_raises_on_card(dev, icld):
    """The banded and maxrand adjoints are not ported: on the card their
    backward raises instead of dropping the gradient."""
    atm, _, _ = _case(dev, 40, 10)
    bc = _band_clouds(dev, 40, 10, "decks")
    model = make_model(LWConfig(icld=icld, imca=0, dtype="float32",
                                use_lut=False), device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_grad_step(model)(atm, bc)


def _sweep_inputs(dev, B, L):
    """The RT sweep's inputs on a small case, and each K1 mode's cloud
    arguments: compact, fused and cldf-odcld on make_mcica_clouds (the
    per-g arrays with an input cloud od for cldf-odcld), banded and
    maxrand on make_band_clouds."""
    model = _model(dev)
    _, clouds, prof = _case(dev, B, L, clear_frac=0.3)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    play = interp_planck_blocked(prof.tavel.t().contiguous(), model.totplnk)
    plev = interp_planck_blocked(prof.tz.t().contiguous(), model.totplnk)
    abi, abl = cldprop.ice_liq_coeffs_blocked(clouds.reicmc, clouds.relqmc,
                                              3, 1, static)
    cw = torch.stack([clouds.ciwp.t(), clouds.clwp.t()], 1).contiguous()
    blk = McicaCloudsBlocked.from_numpy(
        make_mcica_clouds(B, L, seed=L, layout="blocked", clear_frac=0.3),
        dev, torch.float32)
    tauc = blk._replace(taucmc=blk.cldfmc * (0.05 * blk.ciwpmc
                                             + 0.1 * blk.clwpmc))
    odc, cfc, _ = cldprop.cldprmc_blocked(tauc, static, inflag=0, iceflag=3,
                                          liqflag=1)
    bc = _band_clouds(dev, B, L, "mixed")
    taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                              iceflag=3, liqflag=1)
    args = (tg, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
            model.ngb0, model.wg)
    modes = {"clear": ("blocked", ()),
             "compact": ("blocked", ((clouds.cldfmc, cw, abi, abl),)),
             "fused": ("fused", ((*blk[:4], abi, abl),)),
             "cldf_od": ("cldf_od", ((cfc, odc),)),
             "banded": ("banded", (bc.cldfrac.t().contiguous(), taucb)),
             "maxrand": ("maxrand", (rtrnmr.overlap_rows(bc.cldfrac),
                                     taucb))}
    return args, sc.dplankbnd_dt, modes


@pytest.mark.parametrize("B,L", [(37, 13), (5, 1), (96, 30)])
def test_rt_all_modes_and_idrv_match_plain(dev, B, L):
    """Every K1 instantiation against its plain version; the idrv=1 flux
    rows bitwise equal to the idrv=0 launch's; two runs bitwise equal."""
    args, dpl, modes = _sweep_inputs(dev, B, L)
    for name, (w, extra) in modes.items():
        kern = WRAPPERS[w]
        k0 = kern(*args, *extra)
        k1, d1 = kern(*args, *extra, dplankbnd_dt=dpl)
        p1, pd1 = rtrn.FLUXES[w](*args, *extra, dplankbnd_dt=dpl)
        assert k0.shape == (4, L + 1, B) and d1.shape == (2, L + 1, B)
        assert torch.isfinite(d1).all(), name
        assert flux_err(rtrn.FLUXES[w](*args, *extra), k0) <= 2e-5, name
        assert flux_err(torch.cat([p1, pd1]), torch.cat([k1, d1])) <= 2e-5
        assert torch.equal(k0, k1), name
        again = kern(*args, *extra, dplankbnd_dt=dpl)
        assert torch.equal(k1, again[0]) and torch.equal(d1, again[1])


@pytest.mark.parametrize("B,L", [(15, 5), (16, 1), (17, 9), (37, 5),
                                 (100, 140)])
def test_rt_edge_cases_every_instantiation_matches_plain(dev, B, L):
    """K1's 48 instantiations (6 modes x idrv 0/1 x 4 storages) against
    their plain versions on ``utils.snapshot.k1_edge_args``: B at the
    16-column tile +-1 and off a multiple of 16 (element-wise staging),
    L = 1, longer than the ring, 140; clear, overcast and
    top-and-bottom-cloudy columns in runs across the tiles, per-g cloud
    fractions in (0, 0.5), the g-point od exactly 0.06 and 0.  The idrv=1
    flux rows bitwise equal to idrv=0's, two runs bitwise equal."""
    from rrtmg_lw_torch.ops.spec_codec import spec_store
    from rrtmg_lw_torch.utils.snapshot import k1_edge_args
    args, dpl, _ = _sweep_inputs(dev, B, L)
    args, modes, _ = k1_edge_args(dev, _model(dev).static_tensors(), args)
    gen = torch.Generator(device=dev).manual_seed(B + L)
    taua = 0.02 * torch.rand((L, 16, B), generator=gen, device=dev)
    for spec in ("f32", *SPECS):
        a, kw = args, {}
        if spec != "f32":
            a = (spec_store(args[0], SPECS[spec], "tg"),
                 spec_store(args[1], SPECS[spec], "fr"), *args[2:])
            kw = dict(taua_t=taua)
        for name, (w, extra) in modes.items():
            kern, plain = WRAPPERS[w], rtrn.FLUXES[w]
            k0 = kern(*a, *extra, **kw)
            k1, d1 = kern(*a, *extra, dplankbnd_dt=dpl, **kw)
            p1, pd1 = plain(*a, *extra, dplankbnd_dt=dpl, **kw)
            assert torch.isfinite(d1).all(), (spec, name)
            assert flux_err(plain(*a, *extra, **kw), k0) <= 2e-5, (spec, name)
            assert flux_err(torch.cat([p1, pd1]),
                            torch.cat([k1, d1])) <= 2e-5, (spec, name)
            assert torch.equal(k0, k1), (spec, name)
            again = kern(*a, *extra, dplankbnd_dt=dpl, **kw)
            assert torch.equal(k1, again[0]) and torch.equal(d1, again[1])


def test_rt_kernel_launch_configuration(dev):
    """Every K1 instantiation fits at least two 256-thread blocks on an
    SM, its ring of levels included."""
    from rrtmg_lw_torch.ops.rtrn_cuda import MODES, k1_info
    for spec in (torch.float32, *SPECS.values()):
        for mode in MODES:
            for idrv in (0, 1):
                info = k1_info(mode, idrv, spec)
                assert info["threads"] == 256 and info["columns"] == 16
                assert info["blocks_per_sm"] >= 2, (mode, idrv, spec, info)
                assert info["ring_levels"] in (3, 4)


def test_rt_adjoint_launch_configuration(dev):
    """K6, clear and compact: 256-thread blocks of 16 columns, at least
    two of them on an SM with their ring and buffers, at most 128
    registers and no local memory (spills)."""
    from rrtmg_lw_torch.ops.rtrn_cuda import k6_info
    for cloudy in (False, True):
        info = k6_info(cloudy)
        assert info["threads"] == 256 and info["columns"] == 16, info
        assert info["blocks_per_sm"] >= 2, (cloudy, info)
        assert info["registers"] <= 128, (cloudy, info)
        assert info["local_bytes"] == 0, (cloudy, info)
        assert info["ring_levels"] >= 2, (cloudy, info)


def test_rt_idrv_launch_counters(dev):
    args, dpl, modes = _sweep_inputs(dev, 40, 7)
    for name, (w, extra) in modes.items():
        kern = WRAPPERS[w]
        before = (kern.launches, kern.idrv.launches)
        kern(*args, *extra)
        kern(*args, *extra, dplankbnd_dt=dpl)
        assert (kern.launches - before[0], kern.idrv.launches - before[1]) \
            == (2, 1), name


@pytest.mark.parametrize("icld,inflag,layout", [(0, 2, None),
                                                (2, 2, "blocked"),
                                                (2, 0, "blocked"),
                                                (2, 2, "batch"),
                                                (2, 2, "float_mask")])
def test_model_per_g_and_idrv_cuda_matches_eager(dev, icld, inflag, layout):
    """McICA per-g clouds (fused, cldf-odcld), a float compact mask (to the
    fused mode) and idrv=1, through the kernels against eager."""
    from rrtmg_lw_torch import McicaClouds
    B, L = 200, 30
    atm, compact, _ = _case(dev, B, L)
    if layout == "float_mask":
        cl = compact._replace(cldfmc=compact.cldfmc.float())
    elif layout is None:
        cl = None
    else:
        n = make_mcica_clouds(B, L, seed=L, layout=layout)
        if inflag == 0:
            n = n._replace(taucmc=n.cldfmc * (0.05 * n.ciwpmc
                                              + 0.1 * n.clwpmc))
        cl = (McicaCloudsBlocked if layout == "blocked" else
              McicaClouds).from_numpy(n, dev, torch.float32)
    cfg = dict(icld=icld, imca=1, inflag=inflag, idrv=1, dtype="float32",
               use_lut=False)
    fk = make_model(LWConfig(**cfg), device=dev)(atm, cl)
    fe = make_model(LWConfig(impl="eager", **cfg), device=dev)(atm, cl)
    for name in ("uflx", "dflx", "uflxc", "dflxc", "duflx_dt", "duflxc_dt"):
        assert flux_err(getattr(fe, name).t(), getattr(fk, name).t()) <= 2e-5
    if cl is not None:
        assert not torch.allclose(fk.uflx, fk.uflxc)
    if layout == "float_mask":
        f8 = make_model(LWConfig(**cfg), device=dev)(atm, compact)
        for name in ("uflx", "dflx", "uflxc", "dflxc"):
            assert flux_err(getattr(f8, name).t(), getattr(fk, name).t()) \
                <= 2e-5


def test_unported_adjoints_raise_on_card(dev):
    """No gradient is dropped: a cotangent of duflx_dt, and a backward
    through the fused or cldf-odcld mode, raise; the default loss at
    idrv=1 runs and equals idrv=0's step."""
    atm, clouds, _ = _case(dev, 40, 10)
    cfg = dict(icld=2, imca=1, dtype="float32", use_lut=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_grad_step(make_model(LWConfig(idrv=1, **cfg), device=dev),
                       lambda f: f.duflx_dt.sum())(atm, clouds)
    # autograd's scatter-adds use float atomics unless deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        l0, g0 = make_grad_step(make_model(LWConfig(**cfg), device=dev))(
            atm, clouds)
        l1, g1 = make_grad_step(make_model(LWConfig(idrv=1, **cfg),
                                           device=dev))(atm, clouds)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    blk = McicaCloudsBlocked.from_numpy(
        make_mcica_clouds(40, 10, layout="blocked"), dev, torch.float32)
    for inflag in (0, 2):
        model = make_model(LWConfig(inflag=inflag, **cfg), device=dev)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_grad_step(model)(atm, blk)


# ---- reduced spectral storage (K7) and the probes ----

SPECS = {"bf16": torch.bfloat16, "f16": torch.float16,
         "logu16": torch.uint16}


@pytest.mark.parametrize("B,L", [(37, 23), (1, 60), (130, 7)])
def test_taumol_spec_kernel_matches_plain_encode(dev, B, L):
    from rrtmg_lw_torch.ops.spec_codec import spec_order, spec_store
    model = _model(dev)
    _, _, prof = _case(dev, B, L)
    sc = setcoef(prof, model.static_tensors(), planck=False)
    args = (sc, prof, model.engine, model.kernel_tabs, model.kernel_desc)
    f32 = taumol_blocked(*args)
    before = (taumol_blocked.launches, taumol_blocked.spec.launches)
    for spec, sdt in SPECS.items():
        got = taumol_blocked(*args, spec_dtype=sdt)
        for k, x, which in zip(got, f32, ("tg", "fr")):
            assert k.dtype == sdt and k.shape == (L, 140, B)
            d = (spec_order(k) - spec_order(spec_store(x, sdt, which))).abs()
            assert int(d.max()) <= (1 if spec == "logu16" else 0), spec
    assert (taumol_blocked.launches - before[0],
            taumol_blocked.spec.launches - before[1]) == (3, 3)


@pytest.mark.parametrize("B,L", [(37, 13), (5, 1), (96, 30)])
def test_rt_spec_modes_match_plain(dev, B, L):
    """Every K1 mode x idrv in each reduced storage against the plain
    decode + aerosol add + sweep on the same codes, with a seeded aerosol
    od that differs in every (layer, band, column): the same check of a
    K1 that dropped the add, or read taua at reversed bands or layers or
    shifted columns, fails."""
    from rrtmg_lw_torch.ops.spec_codec import spec_store
    args, dpl, modes = _sweep_inputs(dev, B, L)
    tg, fr = args[:2]
    gen = torch.Generator(device=dev).manual_seed(B + L)
    taua = 0.02 * torch.rand((L, 16, B), generator=gen, device=dev)
    faults = [torch.zeros_like(taua), taua.flip(1).contiguous()]
    if L > 1:
        faults.append(taua.flip(0).contiguous())
    if B > 1:
        faults.append(taua.roll(1, 2).contiguous())
    for spec, sdt in SPECS.items():
        codes = (spec_store(tg, sdt, "tg"), spec_store(fr, sdt, "fr"))
        for name, (w, extra) in modes.items():
            kern, plain = WRAPPERS[w], rtrn.FLUXES[w]
            ref = plain(*codes, *args[2:], *extra, taua_t=taua)
            for bad in faults:
                assert flux_err(ref, kern(*codes, *args[2:], *extra,
                                          taua_t=bad)) > 2e-5, (spec, name)
            for d in (None, dpl):
                kw = dict(taua_t=taua, dplankbnd_dt=d)
                got = kern(*codes, *args[2:], *extra, **kw)
                ref = plain(*codes, *args[2:], *extra, **kw)
                again = kern(*codes, *args[2:], *extra, **kw)
                if d is not None:
                    got, ref, again = (torch.cat(x) for x in (got, ref,
                                                              again))
                assert torch.isfinite(got).all(), (spec, name)
                assert flux_err(ref, got) <= 2e-5, (spec, name, d is None)
                assert torch.equal(got, again), (spec, name)


def test_rt_spec_wrappers_check_storage(dev):
    args, _, _ = _sweep_inputs(dev, 8, 4)
    taua = torch.zeros((4, 16, 8), device=dev)
    tg16 = args[0].to(torch.bfloat16)
    fr16 = args[1].to(torch.bfloat16)
    with pytest.raises(ValueError, match="taua_t"):
        rt_fluxes_blocked(tg16, fr16, *args[2:])
    with pytest.raises(ValueError, match="taua_t"):
        rt_fluxes_blocked(*args, taua_t=taua)
    with pytest.raises(TypeError):
        rt_fluxes_blocked(tg16, args[1], *args[2:], taua_t=taua)


@pytest.mark.parametrize("spec", ["logu16", "bf16"])
@pytest.mark.parametrize("icld", [0, 2])
def test_model_spec_cuda_matches_eager(dev, monkeypatch, spec, icld):
    atm, clouds, _ = _case(dev, 200, 30, aod=0.1)
    assert float(atm.tauaer.min()) > 0.0
    cl = clouds if icld else None
    monkeypatch.setenv("RRTMG_SPEC_DTYPE", spec)
    before = (taumol_blocked.spec.launches, rt_fluxes_blocked.spec.launches)
    fk = _model(dev, icld)(atm, cl)
    assert (taumol_blocked.spec.launches - before[0],
            rt_fluxes_blocked.spec.launches - before[1]) == (1, 1)
    fe = _model(dev, icld, impl="eager")(atm, cl)
    for name in ("uflx", "dflx", "uflxc", "dflxc"):
        assert flux_err(getattr(fe, name).t(), getattr(fk, name).t()) <= 2e-5
    with pytest.raises(NotImplementedError, match="RRTMG_SPEC_DTYPE"):
        make_grad_step(_model(dev, icld))(atm, cl)


@pytest.mark.parametrize("C,R,D,dout", [(245, 65, 300, 128),
                                        (1000, 17, 40, 37),
                                        (300, 128, 129, 129)])
def test_probe_onehot_kernel_is_the_row_selection(dev, C, R, D, dout):
    from rrtmg_lw_torch.utils import probes
    idx, tbl = probes.probe_inputs(dev, C=C, R=R, D=D)
    before = probes.onehot_select.launches
    for nsplit in (1, 3):
        got = probes.onehot_select(idx, tbl, dout, nsplit)
        want = tbl if nsplit == 3 else tbl.to(torch.bfloat16).float()
        assert torch.equal(got, want[:, :dout][idx.long()]), nsplit
        assert torch.equal(got, probes.onehot_plain(idx, tbl, dout, nsplit))
    assert probes.onehot_select.launches - before == 2


@pytest.mark.parametrize("C,R,D", [(4096 * 60, 1760, 16), (37, 5, 3)])
def test_probe_gather_kernel_is_the_row_gather(dev, C, R, D):
    from rrtmg_lw_torch.utils import probes
    idx, tbl = probes.probe_inputs(dev, C=C, R=R, D=D)
    assert torch.equal(probes.gather_rows(idx, tbl), tbl[idx.long()])
