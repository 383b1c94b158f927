"""Kernel outputs of one checkout, to hold two checkouts bitwise equal.

    PYTHONPATH=<checkout> python rrtmg_lw_torch/utils/snapshot.py --out A.pt
    python rrtmg_lw_torch/utils/snapshot.py --compare A.pt B.pt

    PYTHONPATH=<checkout> python rrtmg_lw_torch/utils/snapshot.py \\
        --k1-times T1.json --k2-times T2.json --k5-times T5.json \\
        --k6-times T6.json --k6-ddt-times TD.json

``--out`` runs, on the card, K2 in all four storages with its bins, K3
at layer and level temperatures, K4, K5 and K6 (clear and compact; both
on seeded cotangents; and, where the checkout has them, banded, fused
and cldf-odcld, kept as SHA-256 digests of their outputs), the overlap
rows, and K1 in all six modes at idrv 0 and 1, on the
inputs of ``chip_smoke.py``'s phase 3 (``utils/profiling.py``'s
``mcica_cloudy``, ``band_cloudy``, ``mcica_blocked`` and ``mcica_tauc``
cells at B=16384, L=60), K1 and K6 also on K1's edge cases
(``k1_edge_args``), K2 and K5 on K2's (``k2_edge_args``,
``K2_EDGE_SHAPES``) and K5 on the boosted profile (``K5_BOOST``), and
saves their outputs.  Run it from each
checkout (its own ``rrtmg_lw_torch`` first on the path), then ``--compare`` prints, per output, whether the
two are bitwise equal, and exits non-zero unless every output of the
first is (outputs only the second has are listed: K1 SAVE's d/dT
derivatives where a newer checkout keeps them).
``--k1-times`` writes the profiler's device ms of K1 in every mode,
idrv and storage on the same inputs, and of compact at L=140;
``--k2-times`` those of K2 in every storage at L=60 and L=140;
``--k5-times`` those of K5 at L=60 and L=140;
``--k6-times`` those of K6 and of the K1 launch that keeps the
radiances K6 reads, clear, compact and (where the checkout has them)
maxrand, banded, fused and cldf-odcld at L=60, the last four also at
L=140; ``--k6-ddt-times`` those of K6's instantiation with the d/dT
sweep's adjoint (idrv=1) in every mode at L=60 and L=140 (``ddt_times``;
its cases ``ddt_cases``, the calls ``ddt_state`` / ``ddt_vjp`` and their
plain version ``ddt_plain_vjp``, which ``chip_smoke.py`` and the tests
share; also of K1 SAVE at idrv=1 in the mode, and their sum);
``--overlap-times``
those of the overlap-rows kernel and (where the checkout has it) its
adjoint; ``--k8-times`` those of K8, the McICA sampler (``k8_times``).  ``--ddt-out`` saves the d/dT instantiations' outputs in every
mode on ``ddt_cases`` at L=60 (``ddt_outputs``, their first 512
columns), which ``--compare`` holds against another checkout's,
counting the elements bitwise equal where an output differs.  The
imports are
absolute, so ``PYTHONPATH`` picks the checkout whose kernels run; only
entry points that every checkout since reduced storage came in has are
used, and K6 through whichever API the checkout has (``k6_vjp``; the
maxrand state and K6 maxrand: ``mr_state``, ``mr_vjp``; K6-g's
cloudy-layer words where K1 returns them: ``g_state``).  ``--out``
keeps the maxrand state unpacked (``rtrn.unpack_state``, zeros where
nothing is kept, whatever layout the checkout's K1 writes) and the
cotangent of the cloud fraction that K6 maxrand's overlap-row
cotangents give through the overlap adjoint; and the fluxes and
radiances (maxrand: the state unpacked) of K1 keeping the state in
every mode at idrv 0 and 1 on phase 3's inputs, on K1's edge cases and
on the first ``SAVE_COLUMNS`` columns of phase 3's inputs (the bulk and
the scalar store paths, ``k1_save_digests``).
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np
import torch


def k1_cloud_args(device, static, mc) -> dict:
    """Each K1 mode's cloud arguments on the clouds of
    ``utils/profiling.py``'s cells: {mode: (``rtrn_cuda.WRAPPERS`` key,
    cloud args)}.  clear: none; compact: ``mc``, the ``mcica_cloudy``
    cell's compact clouds; banded and maxrand: ``band_cloudy``'s; fused:
    ``mcica_blocked``'s; cldf-odcld: ``mcica_tauc``'s.  The plain cloud
    optics and overlap rows make the arguments.  ``chip_smoke.py`` uses
    it too; it stays here, where a run against an older checkout finds
    it."""
    from rrtmg_lw_torch.ops import cldprop, rtrnmr
    from rrtmg_lw_torch.utils.profiling import cell_inputs
    _, bc = cell_inputs("band_cloudy", device)
    taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                              iceflag=3, liqflag=1)
    _, cb = cell_inputs("mcica_blocked", device)
    abi_b, abl_b = cldprop.ice_liq_coeffs_blocked(cb.reicmc, cb.relqmc, 3,
                                                  1, static)
    _, tc = cell_inputs("mcica_tauc", device)
    odc, cfc, _ = cldprop.cldprmc_blocked(tc, static, inflag=0, iceflag=3,
                                          liqflag=1)
    return {"clear": ("blocked", ()),
            "compact": ("blocked", (compact_args(static, mc),)),
            "banded": ("banded", (bc.cldfrac.t().contiguous(), taucb)),
            "maxrand": ("maxrand", (rtrnmr.overlap_rows(bc.cldfrac),
                                    taucb)),
            "fused": ("fused", ((*cb[:4], abi_b, abl_b),)),
            "cldf_od": ("cldf_od", ((cfc, odc),))}


def compact_args(static, mc) -> tuple:
    """K1's compact cloud fields of McicaCloudsCompact ``mc``: (mask,
    cw (L, 2, B), abi, abl (L, 16, B)), the coefficients by the plain
    cloud optics."""
    from rrtmg_lw_torch.ops import cldprop
    abi, abl = cldprop.ice_liq_coeffs_blocked(mc.reicmc, mc.relqmc, 3, 1,
                                              static)
    cw = torch.stack([mc.ciwp.t(), mc.clwp.t()], 1).contiguous()
    return mc.cldfmc, cw, abi, abl


EDGE_KINDS = ("clear", "overcast", "top_bottom", "mixed")


def make_edge_clouds(ncol, nlay, seed=9, ngpt=140):
    """Clouds of K1's edge cases, float32 numpy arrays in the kernel
    layouts.  Columns come in runs of 1-23 (so runs straddle K1's column
    tiles; at most ncol // 4, so every kind is there from 4 columns on)
    of four kinds (``EDGE_KINDS``): clear; overcast (every layer
    and g-point cloudy); cloudy only in the bottom and the top layer;
    mixed (per layer and g-point a third each clear, a cloud fraction in
    (0, 0.5) and one in [0.5, 1)).  -> dict: kind (ncol,) index into
    EDGE_KINDS; cldf_g, ciwp_g, clwp_g, tauc_g (nlay, 144, ncol) per-g
    cloud fraction, water paths and cloud od; mask (nlay, 144, ncol) the
    g-points with cldf_g >= 0.5 (compact); cw (nlay, 2, ncol) the layer
    water paths (compact); cldfrac (nlay, ncol) and taucb (nlay, 16,
    ncol) the per-band clouds (banded, maxrand), of the same kinds."""
    rng = np.random.default_rng(seed)
    kind = np.empty(ncol, np.int64)
    i = k = 0
    while i < ncol:
        n = int(rng.integers(1, min(23, max(1, ncol // 4)) + 1))
        kind[i:i + n] = k % len(EDGE_KINDS)
        i, k = i + n, k + 1
    gp = -(-ngpt // 8) * 8
    f32 = np.float32

    def rand(shape, lo, span):
        return f32(lo) + f32(span) * rng.random(shape, dtype=f32)

    shape = (nlay, ngpt, ncol)
    high = rand(shape, 0.5, 0.5)                      # in [0.5, 1)
    u = rng.random(shape, dtype=f32)
    # mixed: clear, in (0, 0.5), in [0.5, 1), a third each
    mixed = np.where(u < f32(1 / 3), f32(0.0),
                     np.where(u < f32(2 / 3), rand(shape, 0.01, 0.48), high))
    del u
    ends = np.zeros((nlay, 1, 1), bool)
    ends[[0, -1]] = True
    cldf_g = np.zeros((nlay, gp, ncol), f32)
    cldf_g[:, :ngpt] = np.select(
        [kind == 1, kind == 2, kind == 3],
        [high, np.where(ends, high, f32(0.0)), mixed], f32(0.0))
    del high, mixed
    cloudy = cldf_g > 0
    ciwp_g = np.where(cloudy, rand(cldf_g.shape, 0.0, 5.0), f32(0.0))
    clwp_g = np.where(cloudy, rand(cldf_g.shape, 20.0, 20.0), f32(0.0))
    tauc_g = cldf_g * (f32(0.05) * ciwp_g + f32(0.1) * clwp_g)
    lay = cloudy.any(1)                               # (nlay, ncol)
    cw = np.stack([np.where(lay, rand(lay.shape, 0.0, 5.0), f32(0.0)),
                   np.where(lay, rand(lay.shape, 20.0, 20.0), f32(0.0))], 1)
    frac = rand((nlay, ncol), 0.3, 0.7)
    mixed_l = rng.random((nlay, ncol), dtype=f32) * (
        rng.random((nlay, ncol), dtype=f32) < 0.5)
    cldfrac = np.select([kind == 1, kind == 2, kind == 3],
                        [frac, np.where(ends[:, 0], frac, f32(0.0)), mixed_l],
                        f32(0.0))
    taucb = np.where(cldfrac[:, None] > 0, rand((nlay, 16, ncol), 0.2, 5.0),
                     f32(0.0))
    return dict(kind=kind, cldf_g=cldf_g, ciwp_g=ciwp_g, clwp_g=clwp_g,
                tauc_g=tauc_g, mask=(cldf_g >= 0.5).astype(np.int8), cw=cw,
                cldfrac=cldfrac, taucb=taucb)


def force_od(taut_t, secd, ngb0, where, od):
    """taut_t (L, 140, B) with secd[band of g] x taut_t equal to ``od``
    in taut_t's floating type (the product the sweeps form) wherever
    ``where`` (L, 140, B) holds and one value of taut_t reaches it;
    secd (16, B).  -> (taut_t, the elements set)."""
    s = secd[ngb0.long()].to(taut_t.dtype)               # (140, B)
    target = torch.tensor(od, dtype=taut_t.dtype, device=taut_t.device)
    t = (target / s).expand_as(taut_t)
    for _ in range(2):                                   # one ulp either way
        p = s * t
        t = torch.where(p > target, torch.nextafter(t, torch.zeros_like(t)),
                        torch.where(p < target,
                                    torch.nextafter(t, torch.ones_like(t)),
                                    t))
    hit = where & (s * t == target)
    return torch.where(hit, t, taut_t), hit


def k1_edge_args(device, static, args, seed=9) -> tuple:
    """K1's edge cases on the sweep inputs ``args`` (taut_t, fracs_t,
    planklay_t, planklev_t, plankbnd, semiss, pwvcm, ngb0, wg; float32):
    the clouds of ``make_edge_clouds`` in every mode, and taut_t with the
    g-point od exactly 0.06 in every 13th element (the branch point of
    the gas and total-sky factors) and 0 in every 17th.  -> (args with
    that taut_t, {mode: (``rtrn_cuda.WRAPPERS`` key, cloud args)}, number
    of elements at od 0.06 in the g-points with a cloud fraction in
    (0, 0.5))."""
    from rrtmg_lw_torch.ops import cldprop, rtrn, rtrnmr
    taut, ngb0 = args[0], args[7]
    L, _, B = taut.shape
    e = make_edge_clouds(B, L, seed)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)

    idx = torch.arange(taut.numel(), device=device).reshape(taut.shape)
    secd = rtrn.surf_rows(args[4], args[5], args[6], torch.float32)[0]
    taut, hit = force_od(taut, secd, ngb0, idx % 13 == 0, 0.06)
    taut = torch.where(idx % 17 == 0, torch.zeros_like(taut), taut)
    cf = t(e["cldf_g"])
    low = int((hit & (cf[:, :140] > 0) & (cf[:, :140] < 0.5)).sum())
    radius = torch.ones((B, L), device=device)
    abi, abl = cldprop.ice_liq_coeffs_blocked(30.0 * radius, 10.0 * radius,
                                              3, 1, static)
    cldfrac = t(e["cldfrac"])
    taucb = t(e["taucb"])
    modes = {"clear": ("blocked", ()),
             "compact": ("blocked", ((t(e["mask"], torch.int8), t(e["cw"]),
                                      abi, abl),)),
             "banded": ("banded", (cldfrac, taucb)),
             "maxrand": ("maxrand",
                         (rtrnmr.overlap_rows(cldfrac.t().contiguous()),
                          taucb)),
             "fused": ("fused", ((cf, t(e["ciwp_g"]), t(e["clwp_g"]),
                                  t(e["tauc_g"]), abi, abl),)),
             "cldf_od": ("cldf_od", ((cf, t(e["tauc_g"])),))}
    return (taut, *args[1:]), modes, low


# K2's edge shapes (columns, layers): one column, a warp's 32 columns
# -1 and +1, a width off K2's 128-column tile, one layer
K2_EDGE_SHAPES = ((1, 60), (31, 60), (33, 60), (1000, 60), (77, 1))
K2_EDGE_KINDS = ("switch", "lower", "upper")
# per-column gas factors (h2o, co2, o3, n2o, co, ch4, o2), in turn: none;
# co2 and n2o over-abundant (their minor adjustments' ratio > threshold);
# o3 (the o3-co2 eta at its top bins); ch4 (the h2o-ch4 eta at bin 0)
K2_BOOSTS = ((1, 1, 1, 1, 1, 1, 1), (1, 8, 1, 20, 1, 1, 1),
             (1, 1, 300, 1, 1, 1, 1), (1, 1, 1, 1, 1, 30, 1))


def k2_edge_args(device, model, ncol, nlay, seed=11) -> tuple:
    """K2's edge inputs at ``ncol`` columns and ``nlay`` layers: the
    packed fields (fld (NF, nlay, ncol), ifld (NI, nlay, ncol)) that
    ``taumol_cuda.TaumolFn`` takes, every cell a cell of setcoef's output
    on a ``make_atmosphere`` at 60 layers.  Column b's gases are scaled by
    ``K2_BOOSTS[(b // 2) % 4]``; every fourth column is hot and high (its
    pressures x 0.2, so the top layers reach jp's last row, 57, and
    temperatures above the reference's, so a single-key band's rows in
    the upper region clip at nrow - 1).  Columns come in runs of 1-23 of
    three kinds (``K2_EDGE_KINDS``): switch (the column's layers as
    setcoef gave them, lower below laytrop and upper above; at nlay < 60
    every (60 // nlay)-th), lower (its lower cells only) and upper (its
    upper cells only, from the top down).  -> (fld, ifld, facts): counts
    of columns of each kind that hold both regions, only lower or only
    upper cells, of upper cells at jp = 57 and jt1 = 3 (the last-row
    clip), and of cells whose n2o adjustment ratio is above / at most
    its threshold 1.5."""
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.setcoef import setcoef
    from rrtmg_lw_torch.ops.taumol_cuda import (FLOAT_FIELDS, INT_FIELDS,
                                                _pack_inputs)
    from rrtmg_lw_torch.types import Atmosphere
    from rrtmg_lw_torch.utils.synthetic import make_atmosphere
    src_l = 60
    a = make_atmosphere(ncol, src_l, seed=seed, dtype=np.float32)._asdict()
    cols = np.arange(ncol)
    high = cols % 4 == 3
    scale = np.where(high, np.float32(0.2), np.float32(1.0))[:, None]
    a["play"], a["plev"] = a["play"] * scale, a["plev"] * scale
    a["tlay"] = np.where(high[:, None], np.float32(310.0), a["tlay"])
    boost = np.asarray(K2_BOOSTS, np.float32)[(cols // 2) % len(K2_BOOSTS)]
    for i, gas in enumerate(("h2o", "co2", "o3", "n2o", "co", "ch4", "o2")):
        a[gas + "vmr"] = a[gas + "vmr"] * boost[:, i:i + 1]
    prof = inatm(Atmosphere.from_numpy(Atmosphere(**a), device,
                                       torch.float32), torch.float32)
    sc = setcoef(prof, model.static_tensors(), planck=False)
    fld, ifld = _pack_inputs(sc, prof)                  # (N, 60, ncol)

    rng = np.random.default_rng(seed)
    kind = np.empty(ncol, np.int64)
    i = k = 0
    while i < ncol:
        n = int(rng.integers(1, 24))
        kind[i:i + n] = k % len(K2_EDGE_KINDS)
        i, k = i + n, k + 1
    nlow = ifld[INT_FIELDS.index("laytrop")].sum(0).cpu().numpy()
    lay = np.arange(nlay)[:, None]
    step = src_l // nlay
    src = np.select(
        [(kind == 1) & (nlow > 0), (kind == 2) | ((kind == 1) & (nlow == 0))],
        [lay % np.maximum(nlow, 1),
         src_l - 1 - lay % np.maximum(src_l - nlow, 1)], lay * step)
    idx = torch.as_tensor(src, device=fld.device)[None].expand(
        fld.shape[0], -1, -1)
    fld = fld.gather(1, idx).contiguous()
    ifld = ifld.gather(1, idx[:ifld.shape[0]]).contiguous()

    lower = ifld[INT_FIELDS.index("laytrop")] != 0
    jp = ifld[INT_FIELDS.index("jp")]
    F = {n: fld[i] for i, n in enumerate(FLOAT_FIELDS)}
    chi = model.engine.chi_t.to(fld.device, torch.float32)[3]     # n2o
    ratio = 1.0e20 * F["coln2o"] / (F["coldry"] * chi[jp.long() + 1])
    facts = dict(
        both=int((lower.any(0) & ~lower.all(0)).sum()),
        lower_only=int(lower.all(0).sum()),
        upper_only=int((~lower).all(0).sum()),
        last_row=int((~lower & (jp == 57)
                      & (ifld[INT_FIELDS.index("jt1")] == 3)).sum()),
        n2o_over=int((ratio > 1.5).sum()),
        n2o_under=int((ratio <= 1.5).sum()))
    return fld, ifld, facts


# gas factors (h2o, co2, o3, n2o, co, ch4, o2) of K5's boosted profile:
# co2, n2o and ch4 over-abundant, so minor adjustments cross their
# thresholds
K5_BOOST = (1.0, 8.0, 1.0, 50.0, 1.0, 20.0, 1.0)


def k5_inputs(device, model, cell="mcica_cloudy", boost=None) -> tuple:
    """K5's packed fields (fld, ifld) on ``utils/profiling.py``'s
    ``cell`` (B=16384; mcica_cloudy: L=60, mcica_cloudy_deep: L=140),
    the profile's gases scaled by ``boost`` (or not)."""
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.setcoef import setcoef
    from rrtmg_lw_torch.ops.taumol_cuda import _pack_inputs
    from rrtmg_lw_torch.utils.profiling import cell_inputs
    prof = inatm(cell_inputs(cell, device)[0], torch.float32)
    if boost is not None:
        prof = prof._replace(wkl=prof.wkl * torch.tensor(boost,
                                                         device=device))
    return _pack_inputs(setcoef(prof, model.static_tensors(), planck=False),
                        prof)


def k5_cotangents(fld, seed=6) -> tuple:
    """Seeded cotangents of taug and fracs (L, 140, B) for fields
    ``fld`` (NF, L, B)."""
    gen = torch.Generator(device=fld.device).manual_seed(seed)
    shape = (fld.shape[1], 140, fld.shape[2])
    return tuple(torch.randn(shape, generator=gen, device=fld.device)
                 for _ in range(2))


def sweep_inputs(device, cell="mcica_cloudy") -> dict:
    """Phase 3's K1 inputs (``cell``, B=16384; mcica_cloudy: L=60): the
    model, profile, setcoef output, static tensors, compact clouds, the
    sweep arguments (taut_t = taug + taua, fracs_t, planklay_t,
    planklev_t, plankbnd, semiss, pwvcm, ngb0, wg) and the aerosol od
    (L, 16, B)."""
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.setcoef import interp_planck_blocked, setcoef
    from rrtmg_lw_torch.utils.profiling import cell_inputs
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False), device=device)
    atm, mc = cell_inputs(cell, device)
    prof = inatm(atm, torch.float32)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    taua = prof.taua.permute(1, 2, 0).contiguous()
    taut = tg + taua[:, model.ngb0.long(), :]
    play, plev = (interp_planck_blocked(t.t().contiguous(), model.totplnk)
                  for t in (prof.tavel, prof.tz))
    args = (taut, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
            model.ngb0, model.wg)
    return dict(model=model, prof=prof, sc=sc, static=static, mc=mc,
                args=args, taug=tg, taua=taua)


def k6_vjp(args, ct):
    """K6 on ``args`` (taut_t, fracs_t, planklay_t, planklev_t, surf,
    cw_t, abi_t, abl_t, mask, ngb0, wg) and the flux cotangents ``ct``,
    through the checkout's API: fed the radiances of K1 on the same
    inputs (``rtrn_cuda.rt_sweep_radiances``) where K1 keeps them, else
    K6 alone (a checkout whose K6 sweeps forward itself)."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    keep = getattr(rtrn_cuda, "rt_sweep_radiances", None)
    if keep is None:
        return rtrn_cuda.rt_sweep_vjp(*args, ct)
    return rtrn_cuda.rt_sweep_vjp(*args, ct, rads=keep(*args)[1])


def mr_state(a):
    """K1 maxrand keeping its state on ``a`` (taut_t, fracs_t,
    planklay_t, planklev_t, surf, rows_t, taucb_t, ngb0, wg), through the
    checkout's API: -> (the state as K6 takes it, the state (10, L, 140,
    B) with zeros where the sub-streams are not kept)."""
    from rrtmg_lw_torch.ops import rtrn, rtrn_cuda
    _, *state = rtrn_cuda.rt_sweep_maxrand_radiances(*a)
    if len(state) == 2:                 # (rads, subs): packed
        return state, rtrn.unpack_state(*state, a[5])
    return state[0], rtrn.kept_state(state[0].clone(), a[5])


def mr_vjp(a, ct, state):
    """K6 maxrand on ``a`` (as ``mr_state``'s) and ``ct``, fed
    ``state`` (``mr_state``'s first), through the checkout's API."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    if isinstance(state, torch.Tensor):
        return rtrn_cuda.rt_sweep_maxrand_vjp(*a, ct, rads=state)
    return rtrn_cuda.rt_sweep_maxrand_vjp(*a, ct, state=state)


def digests(tag, outs) -> dict:
    """{tag_i: output i} of up to 128 MB, else {tag_i_sha256: the SHA-256
    of its bytes (uint8 (32,))}: holds two checkouts bitwise equal
    without keeping 1-2 GB of outputs a case."""
    import hashlib
    out = {}
    for i, g in enumerate(outs):
        if g.numel() * g.element_size() <= 128 << 20:
            out[f"{tag}_{i}"] = g.cpu()
            continue
        h = hashlib.sha256(raw(g).cpu().numpy().tobytes()).digest()
        out[f"{tag}_{i}_sha256"] = torch.tensor(list(h), dtype=torch.uint8)
    return out


def k6mr_digests(tag, x, modes, model, ct) -> dict:
    """The maxrand state (unpacked) and K6 maxrand, where the checkout
    has them, on the sweep inputs ``x`` (taut_t, fracs_t, planklay_t,
    planklev_t, surf) with ``modes``' maxrand clouds, as ``digests``; and
    the cloud fraction's cotangent from K6's overlap-row cotangents
    through the overlap adjoint."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    from rrtmg_lw_torch.ops.rtrnmr_cuda import overlap_rows_vjp
    if not hasattr(rtrn_cuda, "rt_sweep_maxrand_radiances"):
        return {}
    a = (*x, *modes["maxrand"][1], model.ngb0, model.wg)
    state, full = mr_state(a)
    out = digests(f"{tag}_state", (full,))
    del full
    grads = mr_vjp(a, ct, state)
    del state
    out.update(digests(tag, grads))
    cf = modes["banded"][1][0].t().contiguous()
    out[f"{tag}_cldfrac"] = overlap_rows_vjp(cf, grads[5]).cpu()
    return out


def outputs(device) -> dict:
    """K2-K6 on phase 3's inputs, and K1 in every mode at idrv 0 and 1
    on them and on ``k1_edge_args``' edge cases, without and with the
    state kept (``k1_save_digests``, also at ``SAVE_COLUMNS``)."""
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.planck_cuda import planck_interp_blocked
    from rrtmg_lw_torch.ops.rtrn_cuda import WRAPPERS
    from rrtmg_lw_torch.ops.spec_codec import SPEC_DTYPES
    from rrtmg_lw_torch.ops.taumol_cuda import (NBIN, TaumolFn, _pack_inputs,
                                                taumol_vjp)
    x = sweep_inputs(device)
    model, prof, sc, static, mc = (x[k] for k in ("model", "prof", "sc",
                                                  "static", "mc"))
    args = x["args"]
    taut, fr, play, plev = args[:4]
    fld, ifld = _pack_inputs(sc, prof)
    out = {}
    k2_in = [("k2", fld, ifld)] + [
        (f"k2_edge_{B}x{L}", *k2_edge_args(device, model, B, L)[:2])
        for B, L in K2_EDGE_SHAPES]
    for tag, f, i in k2_in:
        for spec, sdt in SPEC_DTYPES.items():
            if not spec:
                continue
            bins = torch.empty((16, NBIN, *f.shape[1:]), dtype=torch.int32,
                               device=device)
            k2 = TaumolFn.apply(f, i, model.engine, model.kernel_tabs,
                                model.kernel_desc, bins, sdt)
            out.update({f"{tag}_{spec}_taug": k2[0],
                        f"{tag}_{spec}_fracs": k2[1],
                        f"{tag}_{spec}_bins": bins})
    for name, t in (("k3_lay", prof.tavel), ("k3_lev", prof.tz)):
        out[name] = planck_interp_blocked(t.t().contiguous(), model.totplnk)
    out["k4_abi"], out["k4_abl"] = ice_liq_coeffs_blocked(
        mc.reicmc, mc.relqmc, 3, 1, static)
    gen = torch.Generator(device=device).manual_seed(5)
    ct_t, ct_f = (torch.randn(taut.shape, generator=gen, device=device)
                  for _ in range(2))
    out["k5"] = taumol_vjp(fld, ifld, model.engine, model.kernel_tabs,
                           model.kernel_desc, ct_t, ct_f)
    k5_in = [("k5_boost", *k5_inputs(device, model, boost=K5_BOOST))] + [
        (f"k5_edge_{B}x{L}", *k2_edge_args(device, model, B, L)[:2])
        for B, L in K2_EDGE_SHAPES]
    for tag, f, i in k5_in:
        out[tag] = taumol_vjp(f, i, model.engine, model.kernel_tabs,
                              model.kernel_desc, *k5_cotangents(f))
    del k5_in
    modes = k1_cloud_args(device, static, mc)
    eargs, emodes, _ = k1_edge_args(device, static, args)
    for tag, a, ms in (("k1", args, modes), ("k1_edge", eargs, emodes)):
        for name, (w, clouds) in ms.items():
            out[f"{tag}_{name}"] = WRAPPERS[w](*a, *clouds)
            out[f"{tag}_{name}_idrv"] = torch.cat(
                WRAPPERS[w](*a, *clouds, dplankbnd_dt=sc.dplankbnd_dt))
    # the overlap-rows kernel on the band_cloudy cell's decks and on
    # K1's edge clouds
    from rrtmg_lw_torch.ops.rtrnmr_cuda import overlap_rows
    for tag, ms in (("overlap", modes), ("overlap_edge", emodes)):
        out[tag] = overlap_rows(ms["banded"][1][0].t().contiguous())
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float32)
    gen = torch.Generator(device=device).manual_seed(5)
    ct = torch.randn(out["k1_clear"].shape, generator=gen, device=device)
    for tag, a, ms in (("k6", args, modes), ("k6_edge", eargs, emodes)):
        mask, cw, abi, abl = ms["compact"][1][0]
        for name, cf in (("clear", (None,) * 4),
                         ("compact", (cw, abi, abl, mask))):
            grads = k6_vjp((*a[:4], surf, *cf, model.ngb0, model.wg), ct)
            out.update({f"{tag}_{name}_{i}": g for i, g in enumerate(grads)
                        if g is not None})
    out = {k: v.cpu() for k, v in out.items()}
    for tag, a, ms in (("k6g", args, modes), ("k6g_edge", eargs, emodes)):
        out.update(k6g_digests(tag, (*a[:4], surf), ms, model, ct))
    for tag, a, ms in (("k6mr", args, modes), ("k6mr_edge", eargs, emodes)):
        out.update(k6mr_digests(tag, (*a[:4], surf), ms, model, ct))
    # K1 keeping the state, on both store paths where the checkout has
    # two (phase 3's inputs are B=16384; SAVE_COLUMNS cut them)
    dpl = sc.dplankbnd_dt
    B = args[0].shape[2]
    saves = [("k1save", args, modes, dpl), ("k1save_edge", eargs, emodes,
                                            dpl)]
    saves += [(f"k1save_{n}", cut_columns(args, n, B),
               {m: (w, cut_columns(c, n, B)) for m, (w, c) in modes.items()},
               cut_columns(dpl, n, B)) for n in SAVE_COLUMNS]
    for tag, a, ms, d in saves:
        out.update(k1_save_digests(tag, a, ms, d))
    return out


def k6g_digests(tag, x, modes, model, ct) -> dict:
    """K6 in the banded, fused and cldf-odcld modes, where the checkout
    has them, on the sweep inputs ``x`` (taut_t, fracs_t, planklay_t,
    planklev_t, surf) with ``modes``' clouds (``k1_cloud_args`` or
    ``k1_edge_args``) and K1's radiances in the mode: each output of up
    to 128 MB, and the SHA-256 of the bytes (uint8 (32,)) of each larger
    one (the per-g cotangents), which holds two checkouts bitwise equal
    without keeping 1-2 GB of them a case."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    keep = getattr(rtrn_cuda, "rt_sweep_g_radiances", None)
    if keep is None:
        return {}
    out = {}
    for mode in ("banded", "fused", "cldf_od"):
        cl = modes[mode][1]
        cl = tuple(cl) if mode == "banded" else tuple(cl[0])
        kw = g_state(keep(mode, *x, cl, model.ngb0, model.wg))
        if mode == "banded":
            grads = rtrn_cuda.rt_sweep_banded_vjp(*x, *cl, model.ngb0,
                                                  model.wg, ct, **kw)
        else:
            grads = rtrn_cuda.rt_sweep_g_vjp(*x, cl, model.ngb0, model.wg,
                                             ct, **kw)
        out.update(digests(f"{tag}_{mode}", grads))
        del kw, grads
    return out


# K1's modes, each with K6's instantiation that runs the d/dT sweep's
# adjoint (idrv=1)
DDT_MODES = ("clear", "compact", "banded", "maxrand", "fused", "cldf_od")
# the symbol of that instantiation in each mode (csrc/rtrn_bwd*.cu;
# compact's whichever tile the checkout runs it on: rt_bwd_g_ddt_kernel<1>
# on K6-g's, rt_bwd_ddt_kernel<true> on K1's 16 x 16)
DDT_SYMBOLS = {"clear": "rt_bwd_ddt_kernel", "compact": "_ddt_kernel",
               "maxrand": "rt_bwd_mr_ddt_kernel",
               "banded": "rt_bwd_g_ddt_kernel",
               "fused": "rt_bwd_g_ddt_kernel",
               "cldf_od": "rt_bwd_g_ddt_kernel"}


def flat_clouds(mode, cl) -> tuple:
    """``k1_cloud_args``' cloud arguments of ``mode`` -> its clouds as
    ``rtrn.rt_sweep_ddt_vjp`` takes them: clear (), compact (mask, cw,
    abi, abl), the others ``rtrn_cuda.CLOUD_INPUTS[mode]``."""
    if mode in ("banded", "maxrand"):
        return tuple(cl)
    return tuple(cl[0]) if cl else ()


def _rt_fields(mode, cl):
    """RTFn's four cloud inputs (cw, abi, abl, mask) of flat clouds
    ``cl``, None in clear sky."""
    return (None,) * 4 if mode == "clear" else (*cl[1:], cl[0])


def ddt_state(mode, x, cl, ngb0, wg) -> dict:
    """K1 keeping the state K6 reads in ``mode``, on x (taut_t, fracs_t,
    planklay_t, planklev_t, surf) and flat clouds ``cl``
    (``flat_clouds``): -> the state keywords of ``ddt_vjp``."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    if mode in ("clear", "compact"):
        return g_state(rtrn_cuda.rt_sweep_radiances(
            *x, *_rt_fields(mode, cl), ngb0, wg))
    if mode == "maxrand":
        _, *state = rtrn_cuda.rt_sweep_maxrand_radiances(*x, *cl, ngb0, wg)
        return dict(state=tuple(state))
    return g_state(rtrn_cuda.rt_sweep_g_radiances(mode, *x, cl, ngb0, wg))


def ddt_vjp(mode, x, cl, ngb0, wg, ct, ct_ddt, kw):
    """K6 in ``mode`` with the d/dT sweep's adjoint: x as ``ddt_state``'s
    with surf (4, 16, B), flux cotangents ``ct`` (4, L+1, B) or None, the
    d/dT ones ``ct_ddt`` (2, L+1, B), fed ``kw`` (``ddt_state``'s)."""
    from rrtmg_lw_torch.ops import rtrn_cuda as rc
    if mode in ("clear", "compact"):
        return rc.rt_sweep_vjp(*x, *_rt_fields(mode, cl), ngb0, wg, ct,
                               ct_ddt=ct_ddt, **kw)
    if mode == "maxrand":
        return rc.rt_sweep_maxrand_vjp(*x, *cl, ngb0, wg, ct, ct_ddt=ct_ddt,
                                       **kw)
    if mode == "banded":
        return rc.rt_sweep_banded_vjp(*x, *cl, ngb0, wg, ct, ct_ddt=ct_ddt,
                                      **kw)
    return rc.rt_sweep_g_vjp(*x, cl, ngb0, wg, ct, ct_ddt=ct_ddt, **kw)


def ddt_plain_vjp(mode, x, cl, ngb0, wg, ct, ct_ddt):
    """``ddt_vjp``'s plain version: the plain vjp of the mode's sweep on
    the cotangent (ct, or zeros where None, then ct_ddt)."""
    from rrtmg_lw_torch.ops import rtrn, rtrn_cuda
    ct6 = rtrn_cuda._full_ct(ct, ct_ddt)
    if mode in ("clear", "compact"):
        return rtrn.rt_sweep_vjp(*x, *_rt_fields(mode, cl), ngb0, wg, ct6)
    if mode == "maxrand":
        return rtrn.rt_sweep_maxrand_vjp(*x, *cl, ngb0, wg, ct6)
    if mode == "banded":
        return rtrn.rt_sweep_banded_vjp(*x, *cl, ngb0, wg, ct6)
    return rtrn.rt_sweep_g_vjp(*x, cl, ngb0, wg, ct6)


def ddt_plain_planes(mode, x, cl, ngb0, wg):
    """The d/dT derivatives entering each layer and their clear twins that
    K1 SAVE keeps at idrv=1 in ``mode`` (``rtrn_cuda.KEEPS_DDT``), from the
    plain sweep in float64 on x (taut_t, fracs_t, planklay_t, planklev_t,
    surf (4, 16, B)) and flat clouds ``cl``: (2, L, 140, B)."""
    from rrtmg_lw_torch.ops import rtrn
    xd = tuple(t.double() for t in x)
    cd = tuple(t if t.dtype == torch.int8 else t.double() for t in cl)
    if mode == "banded":
        _, rads = rtrn.rt_sweep_banded(*xd, *cd, ngb0, wg.double(),
                                       radiances=True)
    elif mode == "maxrand":
        _, rads, _ = rtrn.rt_sweep_maxrand(*xd, *cd, ngb0, wg.double(),
                                           radiances=True)
    else:
        rads = rtrn.rt_sweep_blocked(*xd, ngb0, wg.double(), cd,
                                     radiances=True)[1]
    return rads[4:6]


def ddt_cases(device, nlay) -> tuple:
    """The inputs of K6's d/dT cases at B=16384: phase 3's (nlay=60) or the
    mcica_cloudy_deep cell's (nlay=140) sweep inputs with surf (4, 16,
    B), and each mode's flat clouds (``flat_clouds``) on the cells of
    ``k1_cloud_args`` (nlay=60) or ``g_cloud_args`` (140): -> (x (taut_t,
    fracs_t, planklay_t, planklev_t, surf), ngb0, wg, {mode: clouds})."""
    from rrtmg_lw_torch.ops import rtrn, rtrnmr
    xs = sweep_inputs(device, "mcica_cloudy" if nlay == 60
                      else "mcica_cloudy_deep")
    args, sc, prof, static = xs["args"], xs["sc"], xs["prof"], xs["static"]
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float32, sc.dplankbnd_dt)
    if nlay == 60:
        clouds = {m: flat_clouds(m, cl) for m, (_, cl) in
                  k1_cloud_args(device, static, xs["mc"]).items()}
    else:
        clouds = dict(g_cloud_args(device, static, nlay), clear=(),
                      compact=compact_args(static, xs["mc"]))
        cf, taucb = clouds["banded"]
        clouds["maxrand"] = (rtrnmr.overlap_rows(cf.t()), taucb)
    return (*args[:4], surf), args[7], args[8], clouds


def ddt_times(device, reps=5) -> list:
    """Device ms per launch (``torch.profiler``, as ``k6_times``) of K6's
    instantiation with the d/dT sweep's adjoint in every mode, on
    ``ddt_cases`` at L=60 and L=140, fed the state K1 kept on the same
    inputs, on seeded flux and d/dT cotangents, and of that K1 launch
    (K1 SAVE at idrv=1, whatever state the checkout keeps: compact's
    cloudy-layer words too where it keeps them).  -> [{mode, nlay,
    k6_ddt_ms, k1_save_ms, sum_ms}]."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(5)
    for nlay in (60, 140):
        x, ngb0, wg, clouds = ddt_cases(device, nlay)
        L, _, B = x[0].shape
        ct = torch.randn((4, L + 1, B), generator=gen, device=device)
        ct_ddt = torch.randn((2, L + 1, B), generator=gen, device=device)
        for mode in DDT_MODES:
            cl = clouds[mode]
            kw = ddt_state(mode, x, cl, ngb0, wg)
            rows.append(dict(mode=mode, nlay=L, k6_ddt_ms=kernel_ms(
                lambda: ddt_vjp(mode, x, cl, ngb0, wg, ct, ct_ddt, kw),
                DDT_SYMBOLS[mode], reps), k1_save_ms=kernel_ms(
                lambda: ddt_state(mode, x, cl, ngb0, wg), "rt_kernel<",
                reps)))
            rows[-1]["sum_ms"] = rows[-1]["k6_ddt_ms"] + rows[-1]["k1_save_ms"]
            print(rows[-1], flush=True)
            del kw
        del x, clouds
    return rows


# columns of ``ddt_outputs``' cases kept in the file
DDT_OUT_COLUMNS = 512


def ddt_outputs(device) -> dict:
    """K6's outputs with the d/dT sweep's adjoint in every mode, fed the
    state K1 kept, on ``ddt_cases`` at L=60 with seeded flux and d/dT
    cotangents (``ddt_times``'), each output's first DDT_OUT_COLUMNS
    columns (a column's outputs do not depend on the others'):
    {"ddt_<mode>_<i>": output i}."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(5)
    x, ngb0, wg, clouds = ddt_cases(device, 60)
    L, _, B = x[0].shape
    ct = torch.randn((4, L + 1, B), generator=gen, device=device)
    ct_ddt = torch.randn((2, L + 1, B), generator=gen, device=device)
    for mode in DDT_MODES:
        cl = clouds[mode]
        kw = ddt_state(mode, x, cl, ngb0, wg)
        got = ddt_vjp(mode, x, cl, ngb0, wg, ct, ct_ddt, kw)
        out.update({f"ddt_{mode}_{i}": g[..., :DDT_OUT_COLUMNS].cpu()
                    for i, g in enumerate(got) if g is not None})
        del kw, got
    return out


def g_state(kept) -> dict:
    """The keywords of K6 in the banded, fused or cldf-odcld mode for
    what ``rt_sweep_g_radiances`` returned (and of K6 clear or compact for
    ``rt_sweep_radiances``'), through the checkout's API: the radiances,
    and the cloudy-layer words where it returns them."""
    kw = dict(rads=kept[1])
    if len(kept) > 2 and kept[2] is not None:
        kw["words"] = kept[2]
    return kw


def cut_columns(t, n, B):
    """The first n columns of a sweep or cloud input at B columns ((L,
    *, B), (L, B), (B, *) or (B,); nested tuples element by element);
    others as they are."""
    if not isinstance(t, torch.Tensor):
        return tuple(cut_columns(u, n, B) for u in t)
    if t.dim() >= 2 and t.shape[-1] == B:
        return t[..., :n].contiguous()
    return t[:n].contiguous() if t.shape[0] == B else t


# columns of K1 SAVE's narrow cases: a last 16-column tile of 4 columns
# with rows 16-byte aligned (B % 4 == 0), and rows that are not
SAVE_COLUMNS = (4100, 37)


def k1_save_digests(tag, args, modes, dpl) -> dict:
    """K1 keeping the state K6 reads, in every mode at idrv 0 and 1, on
    the sweep arguments ``args`` (as ``sweep_inputs``') with ``modes``'
    clouds (``k1_cloud_args`` or ``k1_edge_args``), through the
    checkout's API: its fluxes and radiances (maxrand: the fluxes and the
    state unpacked), as ``digests``; where it keeps the d/dT derivatives
    too (idrv=1), those planes as a third output, so that the first two
    compare with a checkout that keeps none."""
    from rrtmg_lw_torch.ops import rtrn, rtrn_cuda
    out = {}
    ngb0, wg = args[7:]
    for mode, (_, clouds) in modes.items():
        for idrv in (0, 1):
            surf = rtrn.surf_rows(*args[4:7], torch.float32,
                                  dpl if idrv else None)
            x = (*args[:4], surf)
            if mode in ("clear", "compact"):
                cf = ((None,) * 4 if not clouds
                      else (*clouds[0][1:], clouds[0][0]))
                kept = rtrn_cuda.rt_sweep_radiances(*x, *cf, ngb0, wg)[:2]
            elif mode == "maxrand":
                fl = rtrn_cuda.rt_sweep_maxrand_radiances(
                    *x, *clouds, ngb0, wg)[0]
                kept = (fl, mr_state((*x, *clouds, ngb0, wg))[1])
            else:
                cl = tuple(clouds) if mode == "banded" else tuple(clouds[0])
                kept = rtrn_cuda.rt_sweep_g_radiances(mode, *x, cl, ngb0,
                                                      wg)[:2]
            # the planes of a checkout that keeps no d/dT derivative
            base = 10 if mode == "maxrand" else 4
            if kept[1].shape[0] > base:
                kept = (kept[0], kept[1][:base], kept[1][base:])
            out.update(digests(f"{tag}_{mode}_idrv{idrv}", kept))
            del kept
    return out


def k1_times(device, reps=5) -> list:
    """Device ms per launch of K1 (``torch.profiler``, the mean of
    ``reps`` launches after one warm-up) in every mode x idrv 0/1 x
    storage on phase 3's inputs, of compact float32 with the mask all
    zero, and of compact float32 at L=140 (the mcica_cloudy_deep cell's
    inputs).  -> [{mode, idrv, storage, nlay,
    device_ms}]."""
    from rrtmg_lw_torch.ops.rtrn_cuda import WRAPPERS
    from rrtmg_lw_torch.ops.spec_codec import SPEC_DTYPES, spec_store

    def run(fn):
        return kernel_ms(fn, "rt_kernel", reps)

    x = sweep_inputs(device)
    args, dpl = x["args"], x["sc"].dplankbnd_dt
    modes = k1_cloud_args(device, x["static"], x["mc"])
    rows = []
    for spec in ("f32", "bf16", "f16", "logu16"):
        if spec == "f32":
            a, kw = args, {}
        else:
            sdt = SPEC_DTYPES[spec]
            a = (spec_store(x["taug"], sdt, "tg"),
                 spec_store(args[1], sdt, "fr"), *args[2:])
            kw = dict(taua_t=x["taua"])
        for name, (w, clouds) in modes.items():
            for idrv in (0, 1):
                d = dict(dplankbnd_dt=dpl) if idrv else {}
                ms = run(lambda: WRAPPERS[w](*a, *clouds, **kw, **d))
                rows.append(dict(mode=name, idrv=idrv, storage=spec,
                                 nlay=args[0].shape[0], device_ms=ms))
                print(rows[-1], flush=True)
    # compact with its mask all zero: the per-g machinery without clouds
    mask, *rest = modes["compact"][1][0]
    rows.append(dict(mode="compact, mask all zero", idrv=0, storage="f32",
                     nlay=args[0].shape[0], device_ms=run(
                         lambda: WRAPPERS["blocked"](
                             *args, (torch.zeros_like(mask), *rest)))))
    print(rows[-1], flush=True)
    del x, args, modes
    torch.cuda.empty_cache()
    x = sweep_inputs(device, "mcica_cloudy_deep")
    cf = compact_args(x["static"], x["mc"])
    rows.append(dict(mode="compact", idrv=0, storage="f32", nlay=140,
                     device_ms=run(lambda: WRAPPERS["blocked"](*x["args"],
                                                               cf))))
    print(rows[-1], flush=True)
    return rows


# the H100's L2
L2_BYTES = 50 * 2**20


def rotating(fn, *tensors, spread=4 * L2_BYTES):
    """A call with no arguments that runs ``fn`` on the next of enough
    copies of ``tensors`` that the other copies hold ``spread`` bytes: a
    kernel timed on repeats reads its inputs from device memory, not from
    the L2 its previous launch left them in."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    copies = [tuple(t.clone() for t in tensors)
              for _ in range(1 + -(-spread // size))]
    it = itertools.cycle(copies)
    return lambda: fn(*next(it))


def kernel_ms(fn, symbol, reps=5, tries=3) -> float:
    """Device ms of one launch of the kernel whose symbol holds
    ``symbol`` (``torch.profiler``, kernel time alone), ``fn`` launching
    it once a call: the mean over ``reps`` calls after one warm-up.  A
    trace can hold fewer launches than were made (on the H100, 3 of 5 in
    a long process), so the mean is over the launches it holds, their count is printed when short, and a
    trace that holds none is taken again, up to ``tries`` times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if symbol in e.name]
        if us:
            break
    if not us or len(us) > reps:
        raise RuntimeError(f"kernel_ms: {len(us)} launches of {symbol} in "
                           f"a trace of {reps} calls ({tries} traces)")
    if len(us) < reps:
        print(f"kernel_ms {symbol}: the trace held {len(us)} of {reps} "
              "launches", flush=True)
    return sum(us) / len(us) / 1e3


def k6_times(device, reps=5) -> list:
    """Device ms per launch (``torch.profiler``, the mean of ``reps``
    launches after one warm-up) of K1 without and with the radiances kept
    (the forward step's and the gradient step's launch) and of K6 fed
    them, clear and compact, on phase 3's inputs (B=16384, L=60), and
    where the checkout has them maxrand and banded on the band_cloudy
    cell's clouds, fused on mcica_blocked's, cldf-odcld on mcica_tauc's,
    the last four also at L=140 (``g_cloud_args`` on the
    mcica_cloudy_deep cell's atmosphere).
    In a checkout whose K6 sweeps forward itself, K6 alone (k1_save_ms
    None).  -> [{mode, nlay, k1_ms, k1_save_ms, k6_ms}]."""
    from rrtmg_lw_torch.ops import rtrn, rtrn_cuda, rtrnmr
    x = sweep_inputs(device)
    args, model, sc, prof = x["args"], x["model"], x["sc"], x["prof"]
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float32)
    gen = torch.Generator(device=device).manual_seed(5)
    ct = torch.randn((4, args[0].shape[0] + 1, args[0].shape[2]),
                     generator=gen, device=device)
    mask, cw, abi, abl = compact_args(x["static"], x["mc"])
    keep = getattr(rtrn_cuda, "rt_sweep_radiances", None)
    rows = []
    for name, fields, cf in (("clear", None, (None,) * 4),
                             ("compact", (mask, cw, abi, abl),
                              (cw, abi, abl, mask))):
        a = (*args[:4], surf, *cf, model.ngb0, model.wg)
        row = dict(mode=name, nlay=args[0].shape[0], k1_ms=kernel_ms(
            lambda: rtrn_cuda.rt_fluxes_blocked(*args, fields), "rt_kernel",
            reps), k1_save_ms=None)
        kw = {}
        if keep is not None:
            row["k1_save_ms"] = kernel_ms(lambda: keep(*a), "rt_kernel",
                                          reps)
            kw = dict(rads=keep(*a)[1])
        row["k6_ms"] = kernel_ms(lambda: rtrn_cuda.rt_sweep_vjp(*a, ct, **kw),
                                 "rt_bwd_kernel", reps)
        rows.append(row)
        print(row, flush=True)
        del kw
    if hasattr(rtrn_cuda, "rt_sweep_maxrand_radiances"):
        # maxrand on the band_cloudy cell's clouds; then the same clouds
        # at L=140 on the mcica_cloudy_deep cell's atmosphere
        cl = k1_cloud_args(device, x["static"], x["mc"])["maxrand"][1]
        rows += mr_times(args, surf, model, ct, cl, reps)
        xd = sweep_inputs(device, "mcica_cloudy_deep")
        sd = rtrn.surf_rows(xd["sc"].plankbnd, xd["prof"].semiss,
                            xd["prof"].pwvcm, torch.float32)
        Ld, _, Bd = xd["args"][0].shape
        cd = torch.randn((4, Ld + 1, Bd), generator=gen, device=device)
        cf, taucb = g_cloud_args(device, x["static"], Ld)["banded"]
        rows += mr_times(xd["args"], sd, model, cd,
                         (rtrnmr.overlap_rows(cf.t()), taucb), reps)
        del xd
    keep_g = getattr(rtrn_cuda, "rt_sweep_g_radiances", None)
    if keep_g is not None:
        # banded on the band_cloudy cell's clouds, fused on
        # mcica_blocked's, cldf-odcld on mcica_tauc's; then the same
        # clouds at L=140 on the mcica_cloudy_deep cell's atmosphere
        cells = {m: tuple(cl) if m == "banded" else tuple(cl[0])
                 for m, (_, cl) in k1_cloud_args(device, x["static"],
                                                 x["mc"]).items()
                 if m in G_MODES}
        rows += g_times(device, args, surf, model, ct, cells, keep_g, reps)
        del cells
        xd = sweep_inputs(device, "mcica_cloudy_deep")
        sd = rtrn.surf_rows(xd["sc"].plankbnd, xd["prof"].semiss,
                            xd["prof"].pwvcm, torch.float32)
        Ld, _, Bd = xd["args"][0].shape
        cd = torch.randn((4, Ld + 1, Bd), generator=gen, device=device)
        rows += g_times(device, xd["args"], sd, model, cd,
                        g_cloud_args(device, x["static"], Ld), keep_g, reps)
    return rows


G_MODES = ("banded", "fused", "cldf_od")


def g_cloud_args(device, static, nlay) -> dict:
    """The clouds of ``k1_cloud_args``' banded, fused and cldf-odcld modes
    at ``nlay`` layers (the band_cloudy, mcica_blocked and mcica_tauc
    cells' generators and seeds): {mode: cloud tensors}."""
    import numpy as np

    from rrtmg_lw_torch.ops import cldprop
    from rrtmg_lw_torch.types import BandClouds, McicaCloudsBlocked
    from rrtmg_lw_torch.utils.profiling import NCOL
    from rrtmg_lw_torch.utils.synthetic import (make_band_clouds,
                                                make_mcica_clouds)
    bc = BandClouds.from_numpy(make_band_clouds(NCOL, nlay, seed=1), device,
                               torch.float32)
    taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                              iceflag=3, liqflag=1)
    cb = McicaCloudsBlocked.from_numpy(
        make_mcica_clouds(NCOL, nlay, seed=2, dtype=np.float32,
                          layout="blocked"), device, torch.float32)
    abi, abl = cldprop.ice_liq_coeffs_blocked(cb.reicmc, cb.relqmc, 3, 1,
                                              static)
    tc = cb._replace(taucmc=cb.cldfmc * (0.05 * cb.ciwpmc
                                         + 0.1 * cb.clwpmc))
    odc, cfc, _ = cldprop.cldprmc_blocked(tc, static, inflag=0, iceflag=3,
                                          liqflag=1)
    return {"banded": (bc.cldfrac.t().contiguous(), taucb),
            "fused": (*cb[:4], abi, abl), "cldf_od": (cfc, odc)}


def mr_times(args, surf, model, ct, clouds, reps) -> list:
    """``k6_times``' rows of the maxrand mode on the sweep arguments
    ``args`` with ``clouds`` (rows_t, taucb_t): K1 without and with the
    state kept, and K6 fed it."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    a = (*args[:4], surf, *clouds, model.ngb0, model.wg)
    row = dict(mode="maxrand", nlay=args[0].shape[0], k1_ms=kernel_ms(
        lambda: rtrn_cuda.rt_fluxes_maxrand(*args, *clouds), "rt_kernel",
        reps), k1_save_ms=kernel_ms(
            lambda: rtrn_cuda.rt_sweep_maxrand_radiances(*a), "rt_kernel",
            reps))
    state, _ = mr_state(a)
    row["k6_ms"] = kernel_ms(lambda: mr_vjp(a, ct, state),
                             "rt_bwd_mr_kernel", reps)
    print(row, flush=True)
    return [row]


def g_times(device, args, surf, model, ct, clouds, keep_g, reps) -> list:
    """``k6_times``' rows of the banded, fused and cldf-odcld modes on the
    sweep arguments ``args`` with ``clouds`` ({mode: cloud tensors}): K1
    without and with the radiances kept, and K6 fed them."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    rows = []
    for mode, cl in clouds.items():
        a = (*args[:4], surf)
        fields = cl if mode == "banded" else (cl,)
        row = dict(mode=mode, nlay=args[0].shape[0], k1_ms=kernel_ms(
            lambda: rtrn_cuda.WRAPPERS[mode](*args, *fields), "rt_kernel",
            reps), k1_save_ms=kernel_ms(lambda: keep_g(mode, *a, cl,
                                                       model.ngb0, model.wg),
                                        "rt_kernel", reps))
        kw = g_state(keep_g(mode, *a, cl, model.ngb0, model.wg))
        if mode == "banded":
            def run():
                rtrn_cuda.rt_sweep_banded_vjp(*a, *cl, model.ngb0, model.wg,
                                              ct, **kw)
        else:
            def run():
                rtrn_cuda.rt_sweep_g_vjp(*a, cl, model.ngb0, model.wg, ct,
                                         **kw)
        row["k6_ms"] = kernel_ms(run, "rt_bwd_g_kernel", reps)
        rows.append(row)
        print(row, flush=True)
        del kw
    return rows


def overlap_times(device, reps=20) -> list:
    """Device ms per launch of the overlap-rows kernel and (where the
    checkout has it) its adjoint, on the band_cloudy cell's cloud
    fraction (B=16384, L=60) and on the same with fractions varying
    inside the decks.  -> [{clouds, overlap_ms, overlap_bwd_ms}]."""
    from rrtmg_lw_torch.ops import rtrnmr_cuda
    from rrtmg_lw_torch.utils.profiling import cell_inputs
    _, bc = cell_inputs("band_cloudy", device)
    gen = torch.Generator(device=device).manual_seed(3)
    cf = bc.cldfrac
    varied = cf * (0.6 + 0.4 * torch.rand(cf.shape, generator=gen,
                                          device=device))
    bwd = getattr(rtrnmr_cuda, "overlap_rows_vjp", None)
    rows = []
    for name, c in (("decks", cf), ("varied", varied.contiguous())):
        row = dict(clouds=name, overlap_ms=kernel_ms(
            rotating(rtrnmr_cuda.overlap_rows, c), "overlap_kernel", reps),
            overlap_bwd_ms=None)
        if bwd is not None:
            ct = torch.randn((c.shape[1], 16, c.shape[0]), generator=gen,
                             device=device)
            row["overlap_bwd_ms"] = kernel_ms(rotating(bwd, c, ct),
                                              "overlap_bwd_kernel", reps)
        rows.append(row)
        print(row, flush=True)
    return rows


def k8_times(device, reps=5) -> list:
    """Device ms per launch of K8 (the McICA sampler, int8 mask) on the
    generate-then-radiate cells' cloud profiles (``profiling.cloud_profile``,
    B=16384): float32 in at icld 2 and 4 (L=60), icld 2 at L=140, icld 1
    and 3, and float64 in at icld 2 and 4; with the mask's write rate.
    -> [{icld, nlay, dtype, device_ms, mask_gb_s}]."""
    from rrtmg_lw_torch.ops import mcica
    from rrtmg_lw_torch.ops.mcica_cuda import subcol_mask
    from rrtmg_lw_torch.types import NGPT_PAD, Atmosphere
    from rrtmg_lw_torch.utils.profiling import NCOL, cloud_profile
    from rrtmg_lw_torch.utils.synthetic import make_atmosphere
    rows = []
    for icld, nlay, dt in ((2, 60, "float32"), (4, 60, "float32"),
                           (2, 140, "float32"), (1, 60, "float32"),
                           (3, 60, "float32"), (2, 60, "float64"),
                           (4, 60, "float64")):
        dtype = getattr(torch, dt)
        atm = Atmosphere.from_numpy(make_atmosphere(NCOL, nlay), device,
                                    dtype)
        f = cloud_profile(atm, icld, device)
        cf = f["cldfrac"].to(dtype)
        al = None if f["alpha"] is None else f["alpha"].to(dtype)
        k = mcica.key(0)
        ms = kernel_ms(lambda: subcol_mask(k, icld, cf, al,
                                           mask_dtype=torch.int8),
                       "mcica_kernel", reps)
        rows.append(dict(icld=icld, nlay=nlay, dtype=dt, device_ms=ms,
                         mask_gb_s=nlay * NGPT_PAD * NCOL / ms * 1e-6))
        print(rows[-1], flush=True)
    return rows


def k2_times(device, reps=5) -> list:
    """Device ms per launch of K2 in every storage on phase 3's inputs
    (L=60) and the mcica_cloudy_deep cell's (L=140), B=16384.  -> [{nlay,
    storage, device_ms}]."""
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.setcoef import setcoef
    from rrtmg_lw_torch.ops.spec_codec import SPEC_DTYPES
    from rrtmg_lw_torch.ops.taumol_cuda import taumol_blocked
    from rrtmg_lw_torch.utils.profiling import cell_inputs
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False), device=device)
    rows = []
    for cell in ("mcica_cloudy", "mcica_cloudy_deep"):
        prof = inatm(cell_inputs(cell, device)[0], torch.float32)
        sc = setcoef(prof, model.static_tensors(), planck=False)
        for spec in ("f32", "bf16", "f16", "logu16"):
            ms = kernel_ms(lambda: taumol_blocked(
                sc, prof, model.engine, model.kernel_tabs, model.kernel_desc,
                spec_dtype=SPEC_DTYPES[spec]), "taumol_kernel", reps)
            rows.append(dict(nlay=prof.pavel.shape[1], storage=spec,
                             device_ms=ms))
            print(rows[-1], flush=True)
    return rows


def k5_times(device, reps=5) -> list:
    """Device ms per launch of K5 on phase 3's inputs (L=60) and the
    mcica_cloudy_deep cell's (L=140), B=16384, on seeded cotangents.
    -> [{nlay, device_ms}]."""
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops.taumol_cuda import taumol_vjp
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False), device=device)
    rows = []
    for cell in ("mcica_cloudy", "mcica_cloudy_deep"):
        fld, ifld = k5_inputs(device, model, cell)
        cts = k5_cotangents(fld)
        ms = kernel_ms(lambda: taumol_vjp(
            fld, ifld, model.engine, model.kernel_tabs, model.kernel_desc,
            *cts), "taumol_bwd_kernel", reps)
        rows.append(dict(nlay=fld.shape[1], device_ms=ms))
        print(rows[-1], flush=True)
        del fld, ifld, cts
    return rows


def raw(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bits: a floating tensor viewed as integers of its width."""
    if not x.is_floating_point():
        return x
    return x.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[
        x.element_size()])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--k1-times", metavar="OUT",
                    help="time K1 in every mode, idrv and storage into OUT "
                         "(JSON)")
    ap.add_argument("--k2-times", metavar="OUT",
                    help="time K2 in every storage at L=60 and 140 into OUT "
                         "(JSON)")
    ap.add_argument("--k5-times", metavar="OUT",
                    help="time K5 at L=60 and 140 into OUT (JSON)")
    ap.add_argument("--k6-times", metavar="OUT",
                    help="time K6 and K1 keeping the radiances, clear, "
                         "compact and maxrand, into OUT (JSON)")
    ap.add_argument("--k6-ddt-times", metavar="OUT",
                    help="time K6 with the d/dT sweep's adjoint in every "
                         "mode at L=60 and 140 into OUT (JSON)")
    ap.add_argument("--overlap-times", metavar="OUT",
                    help="time the overlap rows and their adjoint into OUT "
                         "(JSON)")
    ap.add_argument("--k8-times", metavar="OUT",
                    help="time K8, the McICA sampler, into OUT (JSON)")
    ap.add_argument("--ddt-out", metavar="OUT",
                    help="save K6's d/dT outputs in every mode (ddt_outputs) "
                         "to OUT, for --compare")
    args = ap.parse_args(argv)
    for opt, times in ((args.k1_times, k1_times), (args.k2_times, k2_times),
                       (args.k5_times, k5_times), (args.k6_times, k6_times),
                       (args.k6_ddt_times, ddt_times),
                       (args.overlap_times, overlap_times),
                       (args.k8_times, k8_times)):
        if not opt:
            continue
        if not torch.cuda.is_available():
            raise SystemExit("snapshot needs a CUDA device")
        import json
        import pathlib
        rows = times(torch.device("cuda", 0))
        pathlib.Path(opt).write_text(json.dumps(rows, indent=1))
    for opt, outs in ((args.out, outputs), (args.ddt_out, ddt_outputs)):
        if not opt:
            continue
        if not torch.cuda.is_available():
            raise SystemExit("snapshot needs a CUDA device")
        torch.save(outs(torch.device("cuda", 0)), opt)
    if args.compare:
        # every output of the first bitwise in the second; outputs only the
        # second has (a newer checkout's) are listed, not compared
        a, b = (torch.load(p) for p in args.compare)
        same = True
        for k in b.keys() - a.keys():
            print(f"{k}: only in {args.compare[1]}")
        for k in a:
            eq = (k in b and a[k].dtype == b[k].dtype
                  and torch.equal(raw(a[k]), raw(b[k])))
            same &= eq
            diff = ""
            if (not eq and k in b and a[k].is_floating_point()
                    and a[k].shape == b[k].shape):
                d = float((a[k].double() - b[k].double()).abs().max())
                n = int((raw(a[k]) == raw(b[k])).sum())
                diff = (f" (max |diff| {d:.3g}, "
                        f"{d / max(float(a[k].abs().max()), 1e-300):.3g} of"
                        f" max |first|; {n} of {a[k].numel()} elements "
                        "bitwise equal)")
            print(f"{k}: {'bitwise equal' if eq else 'DIFFERS'}{diff}")
        print(f"all {len(a)} bitwise equal" if same else "outputs differ")
        return 0 if same else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
