"""The CUDA kernels of rrtmg_lw_torch against their plain PyTorch
versions on the card, at small and ragged shapes (chip_smoke.py covers
the main-path shapes), plus the wrappers' input checks and launch
counters: the four forward kernels (K1 in its clear, compact, banded,
maxrand, fused and cldf-odcld modes, each at idrv 0 and 1), the
overlap-rows kernel, and the backward kernels (K3b Planck slope, K5
taumol, K4b the effective radii, K6 RT adjoint in the clear, compact,
maxrand, banded, fused and cldf-odcld modes, the overlap rows' adjoint)
against the plain vjps; K6 is fed the radiances (maxrand: and
sub-streams) of K1's gradient-step launch (``rt_sweep_radiances``,
``rt_sweep_maxrand_radiances``, ``rt_sweep_g_radiances``), whose fluxes
are bitwise those of K1's launch without them and whose state is within
1e-5 of max |plain|; the maxrand, banded, fused and cldf-odcld gradient
steps (clouds and radii included) against eager; K6's instantiations
with the d/dT sweep's adjoint (idrv=1) in every mode against the plain
vjp of the 6-row cotangent, and the d/dT gradient step against eager.

Marked ``cuda``: every test skips without a CUDA device.  This file
imports no JAX, so it also runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are chip_smoke.py's: 1e-6 relative (Planck, cloud
coefficients), 3.05e-5 (taug relative with |ref| floored at 1e-2,
fracs absolute) with every interpolation bin equal, 2e-5 of each
column's max |flux| (RT sweep, model); the overlap rows bitwise equal
(the same elementwise f32 arithmetic).  Backward kernels (the same f32
math summed in another order): 1e-4 of max |plain| per output (K3b,
K5, the overlap adjoint), 1e-3 (K6, a recurrence over the levels); the
model's gradients 2e-2 of max |eager| per Atmosphere field (the gate the
JAX package holds its kernel backward to, tests/test_taumol_bwd.py:101),
the steps with clouds 1e-4 (a loss linear in the fluxes, as
chip_smoke.py).

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
(utils/probes.py) bitwise equal to tbl[idx].  K8, the McICA sampler,
bitwise its plain version (drawing and on given uniforms, icld 1-5,
both input types and mask types, ragged shapes on both store paths,
each launch counted in the path it took), its Philox equal to curand's,
and both generator layouts launching it.
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
from rrtmg_lw_torch.ops.rtrn_cuda import (KEEPS_DDT, WRAPPERS,
                                          rt_fluxes_banded,
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
    fl, rads, words = rt_sweep_radiances(*a)
    assert rads.shape == (2 if fields is None else 4, L, 140, B)
    assert words is None            # idrv=0: K6 reads no words
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
            for path in ("bulk", "scalar"):
                info = k1_info(mode, idrv, save=path)
                assert info["local_bytes"] == 0, (mode, idrv, path, info)
                assert info["blocks_per_sm"] >= 2, (mode, idrv, path, info)
    with pytest.raises(RuntimeError):
        k1_info("banded", 0, torch.bfloat16, save="bulk")


def _radii(dev, B, L, seed):
    """Effective radii (B, L) below, inside, exactly on the grid points of
    and above the ice (reic = 2 + 3k) and liquid (relq = 1.5 + k)
    tables."""
    rng = np.random.default_rng(seed)
    u = rng.random((B, L))
    k = rng.integers(0, 60, (B, L))
    reic = np.where(u < 0.5, 160.0 * u, 2.0 + 3.0 * k)
    relq = np.where(u < 0.5, 140.0 * u, 1.5 + k)
    return (torch.as_tensor(reic, dtype=torch.float32, device=dev),
            torch.as_tensor(relq, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("B,L,iceflag", [(37, 5, 3), (300, 3, 2),
                                         (1, 1, 3)])
def test_cldcoef_bwd_kernel_matches_plain_vjp(dev, B, L, iceflag):
    """K4b against the plain vjp of cldprop.ice_liq_coeffs_blocked within
    1e-4 of max |plain| (a 16-term sum in another order), on radii off,
    on and past the tables' grid; bitwise over two runs; counted."""
    from rrtmg_lw_torch.ops._autograd import plain_vjp
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_vjp
    static = _model(dev).static_tensors()
    reic, relq = _radii(dev, B, L, B + L)
    cts = (_randn((L, 16, B), dev, 1), _randn((L, 16, B), dev, 2))
    before = ice_liq_coeffs_vjp.launches
    got = ice_liq_coeffs_vjp(reic, relq, iceflag, 1, static, *cts)
    assert ice_liq_coeffs_vjp.launches == before + 1
    ref = plain_vjp(lambda r, q: cldprop.ice_liq_coeffs_blocked(
        r, q, iceflag, 1, static), (reic, relq), (True, True), cts)
    for g, r in zip(got, ref):
        assert g.shape == (B, L) and torch.isfinite(g).all()
        assert rel_err(g, r) <= 1e-4
    again = ice_liq_coeffs_vjp(reic, relq, iceflag, 1, static, *cts)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_cldcoef_backward_runs_when_radii_require_grad(dev):
    """The radii's gradient through K4 runs K4b (no raise), and equals the
    plain vjp's; under torch.no_grad K4 alone runs."""
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_vjp
    static = _model(dev).static_tensors()
    reic, relq = _radii(dev, 4, 3, 0)
    reic.requires_grad_()
    relq.requires_grad_()
    abi, abl = ice_liq_coeffs_blocked(reic, relq, 3, 1, static)
    ct = (_randn(abi.shape, dev, 3), _randn(abl.shape, dev, 4))
    before = ice_liq_coeffs_vjp.launches
    got = torch.autograd.grad((abi, abl), (reic, relq), ct)
    assert ice_liq_coeffs_vjp.launches == before + 1
    ref = torch.autograd.grad(cldprop.ice_liq_coeffs_blocked(
        reic, relq, 3, 1, static), (reic, relq), ct)
    assert all(rel_err(g, r) <= 1e-4 for g, r in zip(got, ref))
    with torch.no_grad():
        ice_liq_coeffs_blocked(reic, relq, 3, 1, static)
    assert ice_liq_coeffs_vjp.launches == before + 1


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
    assert torch.equal(got, ref)
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


G_MODES = ("banded", "fused", "cldf_od")


def _g_clouds(dev, B, L, pattern, static):
    """Each random-overlap mode's cloud inputs (``CLOUD_INPUTS`` order)
    on ``pattern``: banded on _band_clouds'; fused and cldf-odcld on
    make_mcica_clouds' per-g arrays with the cloud fraction "decks" (the
    generator's), "clear", "overcast" (1 everywhere) or "mixed" (a third
    each 0, in (0, 0.5) and in [0.5, 1)); water where cloudy, some
    cloudy g-points with no ice, and some with no water and an input
    cloud od (fused: where cldprmc takes taucmc)."""
    bc = _band_clouds(dev, B, L, pattern)
    taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                              iceflag=3, liqflag=1)
    n = make_mcica_clouds(B, L, seed=L, layout="blocked")
    rng = np.random.default_rng(B + L + 1)
    cf = n.cldfmc
    if pattern == "clear":
        cf = np.zeros_like(cf)
    elif pattern == "overcast":
        cf = np.ones_like(cf)
    elif pattern == "mixed":
        u = rng.random(cf.shape)
        cf = np.where(u < 1 / 3, 0.0, np.where(
            u < 2 / 3, 0.01 + 0.48 * rng.random(cf.shape),
            0.5 + 0.5 * rng.random(cf.shape)))
    cf[:, 140:] = 0.0
    u = rng.random(cf.shape)
    ci = np.where((cf > 0) & (u > 0.2), 5.0 * rng.random(cf.shape), 0.0)
    cl = np.where((cf > 0) & (u > 0.1), 20.0 + 20.0 * rng.random(cf.shape),
                  0.0)
    tc = np.where(u > 0.1, cf * (0.05 * ci + 0.1 * cl), 0.3 * cf)
    radii = _radii("cpu", B, L, L)
    blk = McicaCloudsBlocked.from_numpy(n._replace(
        cldfmc=cf, ciwpmc=ci, clwpmc=cl, taucmc=tc, reicmc=radii[0].numpy(),
        relqmc=radii[1].numpy()), dev, torch.float32)
    abi, abl = cldprop.ice_liq_coeffs_blocked(blk.reicmc, blk.relqmc, 3, 1,
                                              static)
    return {"banded": (bc.cldfrac.t().contiguous(), taucb),
            "fused": (*blk[:4], abi, abl),
            "cldf_od": (blk.cldfmc, blk.taucmc)}, blk


def _g_case(dev, args, mode, clouds, seed=3):
    """K1 keeping the radiances in ``mode`` and K6 in that mode fed them,
    on the sweep inputs ``args`` and the mode's ``clouds``: K1's fluxes
    bitwise those of its launch without the radiances, the radiances
    within 1e-5 of max |plain|, its store path bulk where B is a multiple
    of 4 and scalar elsewhere (``k1_save_path``), its cloudy-layer words
    (fused, cldf-odcld) the plain ones; K6 fed them within 1e-3 of max
    |plain vjp| per output, its pad rows zero, bitwise over two runs,
    staged as ``k6_g_info`` says its launch was (bulk tensor copies where
    B is a multiple of 4); K6 without the radiances (or the words)
    raises."""
    from rrtmg_lw_torch.ops.rtrn_cuda import (k1_save_path, k6_g_info,
                                              rt_sweep_banded_vjp,
                                              rt_sweep_g_radiances,
                                              rt_sweep_g_vjp)
    taut, fr, play, plev, plankbnd, semiss, pwvcm, ngb0, wg = args
    L, _, B = taut.shape
    x = (taut, fr, play, plev, rtrn.surf_rows(plankbnd, semiss, pwvcm,
                                               torch.float32))
    fl, rads, words = rt_sweep_g_radiances(mode, *x, clouds, ngb0, wg)
    assert rads.shape == (4, L, 140, B)
    assert k1_save_path(mode) == ("bulk" if B % 4 == 0 else "scalar")
    fields = clouds if mode == "banded" else (clouds,)
    assert torch.equal(fl, WRAPPERS[mode](*args, *fields))
    if mode == "banded":
        _, rads_p = rtrn.rt_sweep_banded(*x, *clouds, ngb0, wg,
                                         radiances=True)
        assert words is None
    else:
        _, rads_p, words_p = rtrn.rt_sweep_blocked(*x, ngb0, wg, clouds,
                                                   radiances=True)
        assert torch.equal(words, words_p)
    assert rel_err(rads, rads_p) <= 1e-5
    ct = _randn((4, L + 1, B), dev, seed)

    def k6(**kw):
        if mode == "banded":
            return rt_sweep_banded_vjp(*x, *clouds, ngb0, wg, ct, **kw)
        return rt_sweep_g_vjp(*x, clouds, ngb0, wg, ct, **kw)
    with pytest.raises(ValueError, match="radiances"):
        k6()
    kw = {} if mode == "banded" else dict(words=words)
    if kw:
        with pytest.raises(ValueError, match="words"):
            k6(rads=rads)
    got = k6(rads=rads, **kw)
    ref = (rtrn.rt_sweep_banded_vjp(*x, *clouds, ngb0, wg, ct)
           if mode == "banded" else
           rtrn.rt_sweep_g_vjp(*x, clouds, ngb0, wg, ct))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and torch.isfinite(g).all(), (mode, i)
        assert rel_err(g, r) <= 1e-3, (mode, i)
        if g.dim() == 3 and g.shape[1] == 144:
            assert not bool(g[:, 140:].any()), (mode, i)
    assert all(torch.equal(g, h) for g, h in zip(got, k6(rads=rads, **kw)))
    assert k6_g_info(mode, L)["staging"] == ("tma" if B % 4 == 0
                                             else "elements")


@pytest.mark.parametrize("B,L,pattern", [(37, 13, "decks"), (5, 1, "mixed"),
                                         (33, 7, "clear"), (40, 140, "mixed"),
                                         (16, 9, "overcast"), (31, 5, "decks"),
                                         (32, 6, "mixed"),
                                         (64, 4, "overcast"),
                                         (36, 60, "decks"), (20, 2, "mixed"),
                                         (36, 400, "decks")])
def test_rt_g_adjoint_matches_plain_vjp(dev, B, L, pattern):
    """``_g_case`` in the banded, fused and cldf-odcld modes: B off and on
    K6's 32-column tile (31, 32, 33, 64), one layer, all clear, past K1's
    ring; rows staged by the bulk tensor copies (B a multiple of 4: 16,
    20, 32, 36, 40, 64; a ragged last tile at 16, 20, 36, 40) and element
    by element (5, 31, 33, 37), as ``k6_g_info`` reports; at L = 400
    banded keeps its cloud-fraction shares in the launch's scratch."""
    args, _, _ = _sweep_inputs(dev, B, L)
    clouds, _ = _g_clouds(dev, B, L, pattern, _model(dev).static_tensors())
    for mode in G_MODES:
        _g_case(dev, args, mode, clouds[mode], seed=B + L)


@pytest.mark.parametrize("B,L", [(15, 5), (33, 9), (100, 140), (32, 60)])
def test_rt_g_adjoint_on_k1_edge_cases(dev, B, L):
    """``_g_case`` on ``utils.snapshot.k1_edge_args`` (clear, overcast
    and top-and-bottom columns across the tiles, per-g cloud fractions in
    (0, 0.5), od exactly 0.06 and 0)."""
    from rrtmg_lw_torch.utils.snapshot import k1_edge_args
    args, _, _ = _sweep_inputs(dev, B, L)
    args, modes, _ = k1_edge_args(dev, _model(dev).static_tensors(), args)
    for mode in G_MODES:
        cl = modes[mode][1]
        _g_case(dev, args, mode, tuple(cl) if mode == "banded"
                else tuple(cl[0]), seed=B + L)


def test_rt_g_adjoint_launch_configuration(dev):
    """K1 keeping the radiances in every mode fits two blocks per SM with
    no local memory; K6 banded, fused and cldf-odcld: 256-thread blocks
    of 32 columns, a group of whole bands each (groups covering the 16
    bands), copies in boxes of 8 rows, a ring of two slots or more, two
    blocks a SM at L = 60, 140 and 400, no local memory; banded's
    cloud-fraction shares in shared memory at L = 60 and 140, in the
    scratch at 400; their d/dT instantiations at most 128 registers, at
    most 64 B of local memory, two blocks per SM at those depths."""
    from rrtmg_lw_torch.ops.rtrn_cuda import MODES, k1_info, k6_g_info
    for mode in MODES:
        for idrv in (0, 1):
            for path in ("bulk", "scalar"):
                info = k1_info(mode, idrv, save=path)
                assert info["local_bytes"] == 0, (mode, idrv, path, info)
                assert info["blocks_per_sm"] >= 2, (mode, idrv, path, info)
    for mode in G_MODES:
        for nlay in (60, 140, 400):
            info = k6_g_info(mode, nlay)
            assert info["threads"] == 256 and info["columns"] == 32, info
            assert info["box_rows"] == 8 and info["groups"][0] == 0, info
            assert info["groups"][-1] == 16, info
            assert info["ring_levels"] >= 2, info
            assert info["blocks_per_sm"] >= 2, (mode, nlay, info)
            assert info["local_bytes"] == 0, (mode, info)
            assert info["shares_in_smem"] == (
                (nlay < 400) if mode == "banded" else None), (mode, info)
            # the d/dT instantiation (no scratch: K1 SAVE's derivatives)
            info = k6_g_info(mode, nlay, ddt=True)
            assert info["registers"] <= 128, (mode, nlay, info)
            assert info["local_bytes"] <= 64, (mode, nlay, info)
            assert info["blocks_per_sm"] == 2, (mode, nlay, info)


G_STEPS = {"banded": (dict(icld=1, imca=0), "band"),
           "fused": (dict(icld=2, imca=1, inflag=2), "blk"),
           "cldf_od": (dict(icld=2, imca=1, inflag=0), "blk")}


@pytest.mark.parametrize("mode,pattern", [("banded", "decks"),
                                          ("banded", "mixed"),
                                          ("fused", "mixed"),
                                          ("cldf_od", "decks")])
def test_random_overlap_grad_steps_run_on_card(dev, mode, pattern):
    """The banded (icld=1), fused (McICA per-g, inflag=2) and cldf-odcld
    (inflag=0) gradient steps on the card, w.r.t. every Atmosphere field
    and the clouds (banded: cldfrac, water paths and the effective radii
    through K4b; fused: every McicaCloudsBlocked field; cldf-odcld:
    cldfmc and taucmc): K1 keeping the radiances and K6 in the mode once
    a step (K4b where K4 runs), and a loss linear in the fluxes whose
    gradients are within 1e-4 of max |eager| (f32 against f32 through
    another order of sums), the cloud fraction's nonzero."""
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_vjp
    from rrtmg_lw_torch.ops.rtrn_cuda import (rt_sweep_banded_vjp,
                                              rt_sweep_g_vjp)
    from rrtmg_lw_torch.parallel import (CLOUD_GRADS, MCICA_GRADS,
                                         RADII_GRADS)
    B, L = 40, 10
    atm, _, _ = _case(dev, B, L)
    cfg, kind = G_STEPS[mode]
    static = _model(dev).static_tensors()
    _, blk = _g_clouds(dev, B, L, pattern, static)
    if kind == "band":
        bc = _band_clouds(dev, B, L, pattern)
        radii = _radii(dev, B, L, 5)
        cl = bc._replace(reic=10.0 + radii[0] / 2, relq=3.0 + radii[1] / 4)
        fields = CLOUD_GRADS + RADII_GRADS
    else:
        cl = blk
        fields = MCICA_GRADS if mode == "fused" else ("cldfmc", "taucmc")
    cts = [_randn((B, L + 1), dev, i) for i in range(4)]

    def loss(fl):
        return sum((c * x).sum() for c, x in zip(
            cts, (fl.uflx, fl.dflx, fl.uflxc, fl.dflxc)))

    k6 = rt_sweep_banded_vjp if mode == "banded" else getattr(
        rt_sweep_g_vjp, mode)
    counters = (WRAPPERS[mode].save, k6, ice_liq_coeffs_vjp)
    out = {}
    for impl in ("cuda", "eager"):
        model = make_model(LWConfig(dtype="float32", use_lut=False,
                                    impl=impl, **cfg), device=dev)
        before = [w.launches for w in counters]
        out[impl] = make_grad_step(model, loss, fields)(atm, cl)
        launched = [w.launches - b for w, b in zip(counters, before)]
        want = [1, 1, int(mode != "cldf_od")] if impl == "cuda" else [0] * 3
        assert launched == want, (impl, launched)
    (_, gk, ck), (_, ge, ce) = out["cuda"], out["eager"]
    for name in Atmosphere._fields:
        assert rel_err(getattr(gk, name), getattr(ge, name)) <= 1e-4, name
    for name, a, b in zip(fields, ck, ce):
        assert torch.isfinite(a).all() and rel_err(a, b) <= 1e-4, name
        assert bool(a.any()) == bool(b.any()), name
    assert bool(ck[0].any())


@pytest.mark.parametrize("icld,pattern", [(2, "decks"), (2, "mixed"),
                                           (3, "mixed")])
def test_maxrand_grad_step_runs_on_card(dev, icld, pattern):
    """The maxrand gradient step on the card (K1 keeping its state and K6
    maxrand once a step; the overlap adjoint where the cloud fraction
    needs a gradient): the gradients of a loss
    linear in the fluxes w.r.t. every Atmosphere field and the cloud
    fraction and water paths within 1e-4 of max |eager| (f32 against
    f32 through another order of sums)."""
    from rrtmg_lw_torch.ops.rtrn_cuda import rt_sweep_maxrand_vjp
    from rrtmg_lw_torch.ops.rtrnmr_cuda import overlap_rows_vjp
    from rrtmg_lw_torch.parallel import CLOUD_GRADS
    B, L = 40, 10
    atm, _, _ = _case(dev, B, L)
    bc = _band_clouds(dev, B, L, pattern)
    cts = [_randn((B, L + 1), dev, i) for i in range(4)]

    def loss(fl):
        return sum((c * x).sum() for c, x in zip(
            cts, (fl.uflx, fl.dflx, fl.uflxc, fl.dflxc)))

    out = {}
    for impl in ("cuda", "eager"):
        model = make_model(LWConfig(icld=icld, imca=0, dtype="float32",
                                    use_lut=False, impl=impl), device=dev)
        counters = (rt_fluxes_maxrand.save, rt_sweep_maxrand_vjp,
                    overlap_rows_vjp)
        before = [w.launches for w in counters]
        _, g = make_grad_step(model, loss)(atm, bc)
        _, _, gc = make_grad_step(model, loss, CLOUD_GRADS)(atm, bc)
        launched = [w.launches - b for w, b in zip(counters, before)]
        # the Atmosphere step reads no cloud cotangent: no overlap adjoint
        assert launched == ([2, 2, 1] if impl == "cuda" else [0, 0, 0])
        out[impl] = (g, gc)
    (gk, ck), (ge, ce) = out["cuda"], out["eager"]
    for name in Atmosphere._fields:
        assert rel_err(getattr(gk, name), getattr(ge, name)) <= 1e-4, name
    for name, a, b in zip(("cldfrac", "ciwp", "clwp"), ck, ce):
        assert torch.isfinite(a).all() and rel_err(a, b) <= 1e-4, name
    assert bool((ck[0] != 0).any())


@pytest.mark.parametrize("B,L,pattern", [(37, 13, "decks"), (5, 1, "mixed"),
                                         (3, 2, "overcast"), (33, 7, "clear"),
                                         (96, 30, "mixed"), (40, 140,
                                                             "mixed")])
def test_overlap_bwd_kernel_matches_plain_vjp(dev, B, L, pattern):
    """The overlap adjoint against the plain vjp of rtrnmr.overlap_rows
    within 1e-4 of max |plain|, bitwise over two runs; the flag rows'
    cotangent is not read."""
    from rrtmg_lw_torch.ops.rtrnmr_cuda import overlap_rows_vjp
    cf = _band_clouds(dev, B, L, pattern).cldfrac
    ct = _randn((L, 16, B), dev, B + L)
    got = overlap_rows_vjp(cf, ct)
    x = cf.clone().requires_grad_()
    ref, = torch.autograd.grad(rtrnmr.overlap_rows(x), x, ct)
    assert got.shape == (B, L) and torch.isfinite(got).all()
    assert rel_err(got, ref) <= 1e-4
    flags = ct.clone()
    flags[:, 1:4] = 1e3
    assert torch.equal(got, overlap_rows_vjp(cf, flags))
    assert torch.equal(got, overlap_rows_vjp(cf, ct))


def _mr_case(dev, args, rows, taucb, seed=3):
    """K1 maxrand keeping its state and K6 maxrand fed it, on the sweep
    inputs ``args`` and the clouds (rows, taucb): K1's fluxes bitwise
    those of its launch without the state, the state, the radiances and
    the packed sub-streams (K slots a sweep, ``rtrn.kept_depth``),
    within 1e-5 of max |plain| compared unpacked (``rtrn.unpack_state``);
    K6 within 1e-3 of max |plain vjp| per output, zeros in the flag rows,
    bitwise over two runs, the second with NaN in the slots past each
    column's count; K6 without the state raises."""
    from rrtmg_lw_torch.ops.rtrn_cuda import (rt_sweep_maxrand_radiances,
                                              rt_sweep_maxrand_vjp)
    taut, fr, play, plev, plankbnd, semiss, pwvcm, ngb0, wg = args
    L, _, B = taut.shape
    surf = rtrn.surf_rows(plankbnd, semiss, pwvcm, torch.float32)
    a = (taut, fr, play, plev, surf, rows, taucb, ngb0, wg)
    fl, rads, subs = rt_sweep_maxrand_radiances(*a)
    _, counts = rtrn.substream_slots(rows)
    K = rtrn.kept_depth(counts)
    assert rads.shape == (4, L, 140, B) and subs.shape == (2, 3, K, 140, B)
    assert torch.equal(fl, rt_fluxes_maxrand(*args, rows, taucb))
    _, *state_p = rtrn.rt_sweep_maxrand(*a, radiances=True)
    assert rel_err(rtrn.unpack_state(rads, subs, rows),
                   rtrn.unpack_state(*state_p, rows)) <= 1e-5
    ct = _randn((4, L + 1, B), dev, seed)
    with pytest.raises(ValueError, match="state"):
        rt_sweep_maxrand_vjp(*a, ct)
    got = rt_sweep_maxrand_vjp(*a, ct, state=(rads, subs))
    ref = rtrn.rt_sweep_maxrand_vjp(*a, ct)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and torch.isfinite(g).all(), i
        assert rel_err(g, r) <= 1e-3, i
    assert torch.equal(got[5][:, 1:4], torch.zeros_like(got[5][:, 1:4]))
    past = torch.arange(K, device=dev)[None, :, None] >= counts[:, None, :]
    subs.masked_fill_(past[:, None, :, None, :], float("nan"))
    again = rt_sweep_maxrand_vjp(*a, ct, state=(rads, subs))
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("B,L,pattern", [(37, 13, "decks"), (5, 1, "mixed"),
                                         (33, 7, "overcast"), (96, 30,
                                                               "mixed"),
                                         (31, 400, "mixed"),
                                         (64, 140, "decks")])
def test_rt_maxrand_adjoint_matches_plain_vjp(dev, B, L, pattern):
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
    _mr_case(dev, (tg, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
                   model.ngb0, model.wg), overlap_rows(bc.cldfrac), taucb,
             seed=B + L)


@pytest.mark.parametrize("B,L", [(15, 5), (33, 9), (100, 140), (32, 60)])
def test_rt_maxrand_adjoint_on_k1_edge_cases(dev, B, L):
    """``_mr_case`` on ``utils.snapshot.k1_edge_args`` (clear, overcast
    and top-and-bottom columns across the tiles, od exactly 0.06 and 0)."""
    from rrtmg_lw_torch.utils.snapshot import k1_edge_args
    args, _, _ = _sweep_inputs(dev, B, L)
    args, modes, _ = k1_edge_args(dev, _model(dev).static_tensors(), args)
    _mr_case(dev, args, *modes["maxrand"][1], seed=B + L)


def test_rt_maxrand_adjoint_launch_configuration(dev):
    """K1 keeping the maxrand state fits two blocks per SM with no local
    memory; K6 maxrand: 256-thread blocks of 32 columns and one of five
    band groups, a ring of two slots or more, two blocks a SM at L = 60,
    140 and 1,000, no local memory."""
    from rrtmg_lw_torch.ops.rtrn_cuda import k1_info, k6_mr_info
    for idrv in (0, 1):
        for path in ("bulk", "scalar"):
            info = k1_info("maxrand", idrv, save=path)
            assert (info["local_bytes"] == 0
                    and info["blocks_per_sm"] >= 2), (path, info)
    for nlay in (60, 140, 1000):
        info = k6_mr_info(nlay)
        assert info["threads"] == 256 and info["columns"] == 32, info
        assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0, info
        assert info["ring_levels"] >= 2 and len(info["groups"]) == 6, info


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
    """No gradient is dropped: a loss reading duflx_dt and duflxc_dt (and
    one reading duflx_dt alone) runs on the card through K6 with the
    d/dT sweep's adjoint (McICA compact, fused and cldf-odcld) and matches
    eager within 1e-4 of max |eager| per Atmosphere field (linear in the
    outputs); the default loss at idrv=1 equals idrv=0's step."""
    from rrtmg_lw_torch.ops.rtrn_cuda import DDT_LAUNCHES
    atm, clouds, _ = _case(dev, 40, 10)
    cfg = dict(icld=2, imca=1, dtype="float32", use_lut=False)
    w = [_randn((40, 11), dev, s) for s in (1, 2, 3)]

    def linear(f):
        return sum((c * x).sum() for c, x in zip(
            w, (f.uflx, f.duflx_dt, f.duflxc_dt)))

    def ddt_only(f):
        return (w[1] * f.duflx_dt).sum()
    blk = McicaCloudsBlocked.from_numpy(
        make_mcica_clouds(40, 10, layout="blocked"), dev, torch.float32)
    for inflag, mode, cl in ((2, "compact", clouds), (2, "fused", blk),
                             (0, "cldf_od", blk)):
        for loss in (linear, ddt_only):
            before = DDT_LAUNCHES[mode].launches
            _, gk = make_grad_step(make_model(LWConfig(
                inflag=inflag, idrv=1, **cfg), device=dev), loss)(atm, cl)
            assert DDT_LAUNCHES[mode].launches == before + 1, mode
            _, ge = make_grad_step(make_model(LWConfig(
                inflag=inflag, idrv=1, impl="eager", **cfg), device=dev),
                loss)(atm, cl)
            for name, g, r in zip(Atmosphere._fields, gk, ge):
                assert torch.isfinite(g).all(), (mode, name)
                assert rel_err(g, r) <= 1e-4, (mode, loss.__name__, name)
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


def _ddt_case(dev, args, dpl, modes, seed):
    """K6 with the d/dT sweep's adjoint in every mode, on the sweep inputs
    ``args`` (as ``_sweep_inputs``') at idrv=1 (``dpl``) with ``modes``'
    clouds, fed the state K1 kept on the same inputs: within 1e-3 of max
    |plain vjp| of the 6-row cotangent per output, with the flux
    cotangent and without (None), bitwise over two runs, counted once a
    launch in ``DDT_LAUNCHES``, the cotangent of dplankbnd_dt nonzero."""
    from rrtmg_lw_torch.ops.rtrn_cuda import DDT_LAUNCHES
    from rrtmg_lw_torch.utils.snapshot import (DDT_MODES, ddt_plain_vjp,
                                               ddt_state, ddt_vjp,
                                               flat_clouds)
    taut, fr, play, plev, plankbnd, semiss, pwvcm, ngb0, wg = args
    L, _, B = taut.shape
    x = (taut, fr, play, plev,
         rtrn.surf_rows(plankbnd, semiss, pwvcm, torch.float32, dpl))
    ct = _randn((4, L + 1, B), dev, seed)
    ct_ddt = _randn((2, L + 1, B), dev, seed + 1)
    for mode in DDT_MODES:
        cl = flat_clouds(mode, modes[mode][1])
        kw = ddt_state(mode, x, cl, ngb0, wg)
        for c in (ct, None):
            before = DDT_LAUNCHES[mode].launches
            got = ddt_vjp(mode, x, cl, ngb0, wg, c, ct_ddt, kw)
            assert DDT_LAUNCHES[mode].launches == before + 1, mode
            ref = ddt_plain_vjp(mode, x, cl, ngb0, wg, c, ct_ddt)
            for i, (g, r) in enumerate(zip(got, ref)):
                if r is None:
                    assert g is None, (mode, i)
                    continue
                assert g.shape == r.shape and torch.isfinite(g).all(), \
                    (mode, i)
                assert rel_err(g, r) <= 1e-3, (mode, i, c is None)
            assert bool(got[4][3].any()), mode
        again = ddt_vjp(mode, x, cl, ngb0, wg, None, ct_ddt, kw)
        assert all(g is None or torch.equal(g, h)
                   for g, h in zip(got, again)), mode


@pytest.mark.parametrize("B,L", [(37, 13), (5, 1), (33, 9), (64, 140),
                                 (32, 60)])
def test_rt_ddt_adjoint_matches_plain_vjp(dev, B, L):
    """``_ddt_case``: B off and on the tiles (16 columns clear / compact,
    32 the others; 37, 5, 33 element copies in the per-band modes), one
    layer, past K1's ring and at the cells' depth."""
    args, dpl, modes = _sweep_inputs(dev, B, L)
    _ddt_case(dev, args, dpl, modes, seed=B + L)


@pytest.mark.parametrize("B,L", [(15, 5), (33, 9), (100, 140)])
def test_rt_ddt_adjoint_on_k1_edge_cases(dev, B, L):
    """``_ddt_case`` on ``utils.snapshot.k1_edge_args`` (clear, overcast
    and top-and-bottom columns across the tiles, per-g cloud fractions in
    (0, 0.5), od exactly 0.06 and 0)."""
    from rrtmg_lw_torch.utils.snapshot import k1_edge_args
    args, dpl, _ = _sweep_inputs(dev, B, L)
    args, modes, _ = k1_edge_args(dev, _model(dev).static_tensors(), args)
    _ddt_case(dev, args, dpl, modes, seed=B + L)


def test_rt_adjoint_launch_configurations_at_idrv(dev):
    """K6's idrv=0 instantiations keep the launch configuration PERF.md
    records from before the d/dT ones came in (registers: clear 96, the
    other modes 128; no local memory; two blocks per SM at L = 60); the
    d/dT ones: 256 threads, at most 64 B of local memory (maxrand and
    banded spill a few bytes at two blocks per SM), two blocks per SM at
    L = 60 and 140 (compact's on K6-g's tile)."""
    from rrtmg_lw_torch.ops.rtrn_cuda import k6_g_info, k6_info, k6_mr_info
    old = {"clear": k6_info(False), "compact": k6_info(True),
           "maxrand": k6_mr_info(60),
           **{m: k6_g_info(m, 60) for m in G_MODES}}
    for mode, info in old.items():
        assert info["registers"] == (96 if mode == "clear" else 128), mode
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] == 2, mode
    for nlay in (60, 140):
        new = {"clear": k6_info(False, ddt=True),
               "compact": k6_g_info("compact", nlay, ddt=True),
               "maxrand": k6_mr_info(nlay, ddt=True),
               **{m: k6_g_info(m, nlay, ddt=True) for m in G_MODES}}
        for mode, info in new.items():
            assert info["threads"] == 256, (mode, info)
            assert info["local_bytes"] <= 64, (mode, info)
            assert info["blocks_per_sm"] == 2, (mode, nlay, info)


# compact's d/dT adjoint on K6-g's tile: its cw shares in shared memory up
# to this depth (csrc/rtrn_bwd_g.cu, SMEM_BWD_G_COMPACT's static_assert)
COMPACT_SHARES_MAX_L = 153


@pytest.mark.parametrize("B,L", [(2048, 60), (2048, 140), (37, 13),
                                 (36, 30), (2052, 9), (40, 200)])
def test_rt_compact_ddt_adjoint_matches_plain_vjp(dev, B, L):
    """Compact's d/dT adjoint (``rt_bwd_g_ddt_kernel`` in the compact mode)
    fed K1 SAVE compact's radiances and cloudy-layer words at idrv=1: the
    words equal ``rtrn.cloudy_words`` of the mask; within 1e-3 of max
    |plain vjp| of the 6-row cotangent per output, with the flux cotangent
    and without; bitwise over two runs; one launch counted in
    ``DDT_LAUNCHES["compact"]``; raising without the words; staged by
    bulk tensor copies where B % 16 == 0 (2048), element by element
    elsewhere (37 ragged; 36 and 2052 with float rows 16-byte aligned
    but not the mask's); its cw shares in shared memory up to L = 153
    and in the launch's scratch at L = 200."""
    from rrtmg_lw_torch.ops.rtrn_cuda import DDT_LAUNCHES, k6_g_info
    from rrtmg_lw_torch.utils.snapshot import (ddt_plain_vjp, ddt_state,
                                               ddt_vjp, flat_clouds)
    args, dpl, modes = _sweep_inputs(dev, B, L)
    taut, fr, play, plev, plankbnd, semiss, pwvcm, ngb0, wg = args
    x = (taut, fr, play, plev,
         rtrn.surf_rows(plankbnd, semiss, pwvcm, torch.float32, dpl))
    cl = flat_clouds("compact", modes["compact"][1])
    kw = ddt_state("compact", x, cl, ngb0, wg)
    assert torch.equal(kw["words"], rtrn.cloudy_words(cl[0]))
    ct = _randn((4, L + 1, B), dev, B + L)
    ct_ddt = _randn((2, L + 1, B), dev, B + L + 1)
    with pytest.raises(ValueError, match="words"):
        ddt_vjp("compact", x, cl, ngb0, wg, ct, ct_ddt, dict(rads=kw["rads"]))
    for c in (ct, None):
        before = DDT_LAUNCHES["compact"].launches
        got = ddt_vjp("compact", x, cl, ngb0, wg, c, ct_ddt, kw)
        assert DDT_LAUNCHES["compact"].launches == before + 1
        ref = ddt_plain_vjp("compact", x, cl, ngb0, wg, c, ct_ddt)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert g.shape == r.shape and torch.isfinite(g).all(), i
            assert rel_err(g, r) <= 1e-3, (i, c is None)
        assert bool(got[5].any()) and bool(got[4][3].any())
    again = ddt_vjp("compact", x, cl, ngb0, wg, None, ct_ddt, kw)
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    info = k6_g_info("compact", L, ddt=True)
    assert info["staging"] == ("tma" if B % 16 == 0 else "elements"), info
    assert info["shares_in_smem"] == (L <= COMPACT_SHARES_MAX_L), info


def test_rt_compact_ddt_adjoint_launch_configuration(dev):
    """Compact's d/dT adjoint on K6-g's tile, and the d/dT instantiations
    of banded, fused and cldf-odcld on it: 256-thread blocks of 32
    columns, a group of whole bands each, boxes of 8 rows, a ring of two
    slots, at most 128 registers, at most 64 B of local memory (the d/dT
    instantiations' spill gate), two blocks per SM at
    L = 60, 140 and past the depth where compact's cw shares leave shared
    memory (which they do there; banded's stay to L = 381); no idrv=0
    instantiation of compact (compact's idrv=0 K6 is rtrn_bwd.cu's), nor
    an instantiation of that file's with the d/dT adjoint in compact."""
    from rrtmg_lw_torch.ops.rtrn_cuda import k6_g_info, k6_info
    for mode in ("compact", *G_MODES):
        for nlay in (60, 140, COMPACT_SHARES_MAX_L + 1):
            info = k6_g_info(mode, nlay, ddt=True)
            assert info["threads"] == 256 and info["columns"] == 32, info
            assert info["box_rows"] == 8 and info["groups"][0] == 0, info
            assert info["groups"][-1] == 16, info
            assert info["ring_levels"] == 2, info
            assert info["registers"] <= 128, (mode, nlay, info)
            assert info["local_bytes"] <= 64, (mode, nlay, info)
            assert info["blocks_per_sm"] == 2, (mode, nlay, info)
            assert info["shares_in_smem"] == (
                nlay <= COMPACT_SHARES_MAX_L if mode == "compact"
                else True if mode == "banded" else None), (mode, info)
    with pytest.raises(RuntimeError):
        k6_g_info("compact", 60)
    with pytest.raises(RuntimeError):
        k6_info(True, ddt=True)


# banded's cloud-fraction shares leave shared memory past L = 381
BANDED_SHARES_MAX_L = 381


@pytest.mark.parametrize("mode,B,L", [
    *((m, B, L) for m in KEEPS_DDT
      for B, L in ((2048, 60), (2048, 140), (37, 13), (36, 13),
                   (2054, 9))),
    ("banded", 64, 400)])
def test_rt_ddt_adjoint_reads_k1_derivatives(dev, monkeypatch, mode, B,
                                              L):
    """The d/dT adjoint of banded, maxrand, fused, cldf-odcld and compact
    reads the derivatives K1 SAVE keeps at idrv=1.  K1 SAVE: rads (6, L,
    140, B), planes 4-5 (P, PC entering each layer) within 1e-6 of max
    |plain| (the plain sweep in float64 on the same inputs), planes 0-3
    bitwise those of K1 SAVE at idrv=0 (maxrand: its kept sub-streams
    too), the fluxes bitwise those of K1 at idrv=1 without SAVE.  K6:
    within 1e-3 of max |plain vjp| of the 6-row cotangent per output, with
    the flux cotangent and without; no scratch allocated; one launch
    counted in ``DDT_LAUNCHES[mode]`` each; bitwise over two runs; staged
    by bulk tensor copies where the rows allow them (B % 4, compact's mask
    B % 16), element by element elsewhere (37 ragged, 2054 unaligned);
    banded's shares in its scratch at L = 400.  K1 SAVE takes its bulk
    stores at 2048 and 36 (a ragged last tile of 4 columns), its scalar
    stores at 37 and 2054."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    from rrtmg_lw_torch.utils.snapshot import (ddt_plain_planes,
                                               ddt_plain_vjp, ddt_state,
                                               ddt_vjp, flat_clouds)
    args, dpl, modes = _sweep_inputs(dev, B, L)
    taut, fr, play, plev, plankbnd, semiss, pwvcm, ngb0, wg = args
    x = (taut, fr, play, plev,
         rtrn.surf_rows(plankbnd, semiss, pwvcm, torch.float32, dpl))
    cl = flat_clouds(mode, modes[mode][1])
    mr = mode == "maxrand"

    def kept_rads(kw):
        return kw["state"][0] if mr else kw["rads"]
    kw = ddt_state(mode, x, cl, ngb0, wg)
    rads = kept_rads(kw)
    assert rads.shape == (6, L, 140, B) and torch.isfinite(rads).all()
    ref = ddt_plain_planes(mode, x, cl, ngb0, wg)
    for p in (0, 1):
        assert rel_err(rads[4 + p], ref[p]) <= 1e-6, (mode, p)
    kw0 = ddt_state(mode, (*x[:4], x[4][:3]), cl, ngb0, wg)
    assert torch.equal(rads[:4], kept_rads(kw0))
    if mr:
        assert torch.equal(rtrn.unpack_state(rads[:4], kw["state"][1], cl[0]),
                           rtrn.unpack_state(*kw0["state"], cl[0]))
    del kw0, ref
    w, extra = modes[mode]
    fwd = WRAPPERS[w](*args, *extra, dplankbnd_dt=dpl)
    with torch.no_grad():
        if mode == "compact":
            kept = rtrn_cuda.rt_sweep_radiances(*x, *cl[1:], cl[0], ngb0, wg)
        elif mr:
            kept = rtrn_cuda.rt_sweep_maxrand_radiances(*x, *cl, ngb0, wg)
        else:
            kept = rtrn_cuda.rt_sweep_g_radiances(mode, *x, cl, ngb0, wg)
    assert torch.equal(kept[0], torch.cat(fwd)), mode
    del kept
    lams = []

    def spy(*a, **k):
        out = operands(*a, **k)
        lams.append(out[2])
        return out
    operands = rtrn_cuda._ddt_operands
    monkeypatch.setattr(rtrn_cuda, "_ddt_operands", spy)
    ct = _randn((4, L + 1, B), dev, B + L)
    ct_ddt = _randn((2, L + 1, B), dev, B + L + 1)
    for c in (ct, None):
        before = rtrn_cuda.DDT_LAUNCHES[mode].launches
        got = ddt_vjp(mode, x, cl, ngb0, wg, c, ct_ddt, kw)
        assert rtrn_cuda.DDT_LAUNCHES[mode].launches == before + 1
        want = ddt_plain_vjp(mode, x, cl, ngb0, wg, c, ct_ddt)
        for i, (g, r) in enumerate(zip(got, want)):
            if r is None:
                assert g is None, (mode, i)
                continue
            assert g.shape == r.shape and torch.isfinite(g).all(), i
            assert rel_err(g, r) <= 1e-3, (mode, i, c is None)
        assert bool(got[4][3].any()), mode
    again = ddt_vjp(mode, x, cl, ngb0, wg, None, ct_ddt, kw)
    assert all(g is None or torch.equal(g, h) for g, h in zip(got, again))
    assert len(lams) == 3 and all(lam is None for lam in lams), lams
    info = (rtrn_cuda.k6_mr_info(L, ddt=True) if mr
            else rtrn_cuda.k6_g_info(mode, L, ddt=True))
    aligned = B % (16 if mode == "compact" else 4) == 0
    assert info["staging"] == ("tma" if aligned else "elements"), info
    if mode == "banded":
        assert info["shares_in_smem"] == (L <= BANDED_SHARES_MAX_L), info


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


# K8, the McICA sampler (csrc/mcica.cu): bitwise its plain version at
# ragged shapes (columns off its 128-column tile and off a lane's 4
# columns, so both store paths run: whole-line vector stores where B % 4
# == 0, element stores elsewhere; one layer, layers off the 4- and 2-layer
# Philox blocks, and L=140, whose float64 and icld 4/5 layers are staged in
# chunks), drawing and fed given uniforms, int8 and float masks, every byte
# of the mask written (pad rows zero), each launch counted in its path
K8_SHAPES = [(1, 1), (31, 2), (33, 5), (100, 61)] + [
    (B, L) for B in (4, 127, 128, 129, 130, 515, 2048)
    for L in (1, 3, 4, 61, 140)]


@pytest.mark.parametrize("B,L", K8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("icld", [1, 2, 3, 4, 5])
def test_mcica_kernel_matches_plain(dev, B, L, dtype, icld):
    from rrtmg_lw_torch.ops import mcica
    from rrtmg_lw_torch.ops.mcica_cuda import subcol_mask
    g = torch.Generator(device=dev).manual_seed(B * L + icld)
    cf = torch.rand((B, L), generator=g, device=dev, dtype=dtype)
    cf = torch.where(cf < 0.3, 0.0, torch.where(cf > 0.9, 1.0, cf))
    al = torch.rand((B, L), generator=g, device=dev, dtype=dtype)
    k = mcica.fold_in(mcica.key(B), L)
    u = torch.rand((L, 140, B), generator=g, device=dev, dtype=dtype)
    u2 = torch.rand((L, 140, B), generator=g, device=dev, dtype=dtype)
    for mdt in (torch.int8, dtype):
        for g_pad in (144, 141):
            n0, n1 = subcol_mask.launches, subcol_mask.given.launches
            v0, s0 = subcol_mask.vector.launches, subcol_mask.scalar.launches
            got = subcol_mask(k, icld, cf, al, g_pad, mdt)
            given = subcol_mask(None, icld, cf, al, g_pad, mdt,
                                uniforms=(u, u2))
            torch.cuda.synchronize()
            assert (subcol_mask.launches - n0,
                    subcol_mask.given.launches - n1) == (1, 1)
            assert (subcol_mask.vector.launches - v0,
                    subcol_mask.scalar.launches - s0) == (
                        (2, 0) if B % 4 == 0 else (0, 2))
            assert torch.equal(got, mcica.subcol_mask(k, icld, cf, al, g_pad,
                                                      mdt))
            assert torch.equal(given, mcica.mask_from_uniforms(
                icld, cf, u, u2, al, g_pad, mdt))
            assert not got[:, 140:].any()


def test_mcica_philox_matches_curand(dev):
    from rrtmg_lw_torch.ops import mcica
    from rrtmg_lw_torch.ops.mcica_cuda import philox_words
    g = torch.Generator(device=dev).manual_seed(0)
    ctr = torch.randint(-2 ** 31, 2 ** 31 - 1, (1000, 4), generator=g,
                        device=dev, dtype=torch.int32)
    for k in ((0, 0), (0xFFFFFFFF, 1), mcica.key(2 ** 40 + 5)):
        hand = philox_words(ctr, k)
        assert torch.equal(hand, philox_words(ctr, k, curand=True))
        assert torch.equal(hand.cpu().to(torch.int64) & mcica.M32,
                           philox_words(ctr.cpu(), k))


def test_mcica_wrapper_rejects_what_k8_does_not_take(dev):
    from rrtmg_lw_torch.ops import mcica
    from rrtmg_lw_torch.ops.mcica_cuda import subcol_mask
    cf = torch.rand((8, 5), device=dev)
    k = mcica.key(0)
    with pytest.raises(ValueError):
        subcol_mask(k, 0, cf)
    with pytest.raises(TypeError):
        subcol_mask(k, 2, cf.half())
    with pytest.raises(TypeError):
        subcol_mask(k, 2, cf, mask_dtype=torch.float64)
    with pytest.raises(ValueError):
        subcol_mask(k, 2, cf, g_pad=139)
    with pytest.raises(ValueError):
        subcol_mask(k, 2, cf.t().contiguous().t())
    with pytest.raises(ValueError):
        subcol_mask(k, 4, cf, torch.rand((5, 8), device=dev))


def test_mcica_batch_layout_runs_k8(dev):
    """mcica_subcol_lw on the card launches K8 for its mask and equals the
    plain version on the CPU with the same key (tauc through ngb)."""
    from rrtmg_lw_torch.ops import mcica
    from rrtmg_lw_torch.ops.mcica_cuda import subcol_mask
    g = torch.Generator().manual_seed(5)
    B, L = 40, 9
    cpu = [torch.rand((B, L), generator=g, dtype=torch.float64)
           for _ in range(5)] + [torch.rand((B, L, 16), generator=g,
                                            dtype=torch.float64)]
    for icld in (2, 4):
        n0 = subcol_mask.launches
        got = mcica.mcica_subcol_lw(mcica.key(9), icld,
                                    *(x.to(dev) for x in cpu),
                                    alpha=cpu[1].to(dev))
        assert subcol_mask.launches - n0 == 1
        ref = mcica.mcica_subcol_lw(mcica.key(9), icld, *cpu, alpha=cpu[1])
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)


# K9, the wire format's decode (csrc/wire.cu): every channel of a batch in
# one launch against the plain twin on the same device tensors (logratio
# within 2 ulps: expf against torch.exp; the other codecs, the ok flags and
# the mask unpack bitwise), at ragged widths, off the 8-element vectors
WIRE_SHAPES = [(1, 1), (7, 3), (8, 5), (33, 2), (130, 61), (515, 13)]


def _ulps(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    m = torch.maximum(a.abs(), b.abs()).float()
    sp = (torch.nextafter(m, torch.full_like(m, float("inf"))) - m).double()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, (a - b).abs() / sp)
    return float(d.nan_to_num(nan=float("inf")).max()) if d.numel() else 0.0


def _wire_batches(B, L):
    from rrtmg_lw_torch.parallel import wire as w
    atm = make_atmosphere(B, L, seed=B + L, dtype=np.float32)
    coded = w.encode_atmosphere(atm, schema="coded")
    auto = w.encode_atmosphere(atm._replace(covmr=np.zeros_like(atm.covmr)))
    refs = dict(coded.refs)
    ref, lo, hi = refs["play"]
    refs["play"] = (ref, hi, lo)
    inverted = w.WireBatch(dict(coded.cols), refs)
    cols = dict(coded.cols)
    p = np.array(cols["play"])
    p[::2] = 0
    cols["play"] = p
    return {"coded": coded, "auto": auto, "inverted": inverted,
            "zero_codes": w.WireBatch(cols, dict(coded.refs))}


def _plain_decode(fn, *args, **kw):
    """``fn`` (a ``parallel.wire`` decoder) with K9's wrappers swapped for
    their plain twins, on the same device tensors."""
    from rrtmg_lw_torch.ops import wire_cuda
    from rrtmg_lw_torch.parallel import wire as w
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wire_cuda, "wire_decode", w.decode_plain)
        mp.setattr(wire_cuda, "wire_unpack_mask", w.unpack_mask)
        return fn(*args, **kw)


@pytest.mark.parametrize("B,L", WIRE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sanitize", [False, True])
def test_wire_decode_kernel_matches_plain(dev, B, L, dtype, sanitize):
    from rrtmg_lw_torch.ops.wire_cuda import wire_decode
    from rrtmg_lw_torch.parallel import make_mesh, shard_batch, wire as w
    from rrtmg_lw_torch.utils.synthetic import make_cloud_profile_fields
    mesh = make_mesh(device=dev)
    taua = torch.zeros((B, L, 16), device=dev)
    for tag, enc in _wire_batches(B, L).items():
        if tag in ("inverted", "zero_codes") and not sanitize:
            continue
        ea = shard_batch(enc, mesh)
        n0 = wire_decode.launches
        got = w.decode_atmosphere(ea, taua, dtype, sanitize=sanitize)
        assert wire_decode.launches - n0 == 1
        ref = _plain_decode(w.decode_atmosphere, ea, taua, dtype,
                            sanitize=sanitize)
        if sanitize:
            (got, ok), (ref, rok) = got, ref
            assert torch.equal(ok, rok), tag
        for name, kind in w.ATM_FIELDS.items():
            a, b = getattr(got, name), getattr(ref, name)
            assert a.is_contiguous() and a.dtype == dtype
            if kind == "logratio":
                assert _ulps(a, b) <= 2, (tag, name)
            else:
                assert torch.equal(a, b), (tag, name)
    ec = shard_batch(w.encode_cloud_profiles(
        make_cloud_profile_fields(B, L, seed=B), schema="coded"), mesh)
    got = w.decode_cloud_profiles(ec, dtype, sanitize=sanitize)
    ref = _plain_decode(w.decode_cloud_profiles, ec, dtype, sanitize=sanitize)
    if sanitize:
        (got, ok), (ref, rok) = got, ref
        assert torch.equal(ok, rok)
    for name, kind in w.CLOUD_FIELDS.items():
        assert _ulps(got[name], ref[name]) <= (2 if kind == "logratio"
                                               else 0), name


@pytest.mark.parametrize("L,nb,B", [(1, 1, 1), (3, 18, 37), (5, 18, 64),
                                    (60, 18, 130), (2, 3, 6)])
def test_wire_unpack_kernel_matches_plain(dev, L, nb, B):
    from rrtmg_lw_torch.ops.wire_cuda import wire_unpack_mask
    from rrtmg_lw_torch.parallel import wire as w
    g = torch.Generator(device=dev).manual_seed(L * B)
    bits = torch.randint(0, 256, (L, nb, B), generator=g, device=dev,
                         dtype=torch.uint8)
    n0 = wire_unpack_mask.launches
    got = wire_unpack_mask(bits)
    assert wire_unpack_mask.launches - n0 == 1
    assert torch.equal(got, w.unpack_mask(bits))
    assert torch.equal(got.cpu(), w.unpack_mask(bits.cpu()))


def test_wire_decode_wrapper_rejects_what_k9_does_not_take(dev):
    from rrtmg_lw_torch.ops.wire_cuda import wire_decode
    from rrtmg_lw_torch.parallel import wire as w
    enc = _wire_batches(8, 3)["coded"]
    shape_of = {"tsfc": (8,), "emis": (8, 16), "plev": (8, 4),
                "tlev": (8, 4)}.get
    chans = w._channels(w.ATM_FIELDS, enc, lambda n: shape_of(n, (8, 3)),
                        torch.float32, dev)
    with pytest.raises(TypeError):
        wire_decode(chans, torch.float16, dev, 8)
    with pytest.raises(ValueError):
        wire_decode(chans * 2, torch.float32, dev, 8)
    with pytest.raises(ValueError):
        wire_decode(chans, torch.float32, dev, 9)
    bad = chans[0]._replace(codes=chans[0].codes.t().contiguous().t())
    with pytest.raises(ValueError):
        wire_decode([bad], torch.float32, dev, 8)


def test_streams_on_the_card(dev):
    """prefetch's pinned copies on the copy stream give the host values,
    in order; the wire step launches K9 twice a step and K8 once."""
    from rrtmg_lw_torch.examples import wire_streaming as ws
    from rrtmg_lw_torch.ops.mcica_cuda import subcol_mask
    from rrtmg_lw_torch.ops.wire_cuda import wire_decode
    from rrtmg_lw_torch.parallel import make_mesh, prefetch, shard_batch
    mesh = make_mesh(device=dev)
    batches = [make_atmosphere(37, 9, seed=s, dtype=np.float32)
               for s in range(5)]
    seen = list(prefetch(batches, mesh, depth=2))
    assert len(seen) == 5
    for a, b in zip(seen, batches):
        assert a.tsfc.device == dev
        assert torch.equal(a.play.cpu(), torch.from_numpy(b.play))
    model = make_model(ws.CONFIG, device=dev)
    step = ws.make_step(model, mesh, 37, 9)
    host = list(ws.host_batches(37, 9, 3))
    n0, k0 = wire_decode.launches, subcol_mask.launches
    outs = [step(*b) for b in prefetch(host, mesh)]
    assert (wire_decode.launches - n0, subcol_mask.launches - k0) == (6, 3)
    again = ws.make_step(model, mesh, 37, 9)
    ref = [again(*shard_batch(b, mesh)) for b in host]
    for a, b in zip(outs, ref):
        assert torch.equal(a.uflx, b.uflx) and bool(a.wire_ok.all())


def test_sharded_steps_on_two_nccl_ranks(dev):
    """``make_sharded_step`` on two NCCL ranks, one GPU each, bitwise the
    one-device step on the same global batch (B=16384, L=60), its shard
    and the fluxes gathered from both ranks; ``make_sharded_grad_step``
    within 1e-6 of ``make_grad_step`` at B=4096
    (``rrtmg_lw_torch.utils.dist_check`` under torchrun)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    from rrtmg_lw_torch import _build
    _build.build()
    repo = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "rrtmg_lw_torch.utils.dist_check"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    print(out)
    assert out["world"] == 2 and out["fluxes_bitwise"] is True
    assert (out["ncol"], out["ncol_grad"], out["nlay"]) == (16384, 4096, 60)
    assert out["grad_rel_err"] <= 1e-6 and out["loss_rel_err"] <= 1e-6
