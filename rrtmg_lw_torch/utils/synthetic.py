"""Deterministic synthetic inputs (atmospheres, McICA and band clouds).

numpy-only copies of ``rrtmg_lw_tpu.utils.synthetic.make_atmosphere``,
``make_band_clouds``, ``make_mcica_clouds`` (every layout) and
``make_cloud_profile_fields`` (the McICA generator's inputs): the
same RNG calls in the same order, so for one seed the arrays are
bitwise equal to the JAX package's.  ``write_column_deck`` writes a
column-mode input deck (INPUT_RRTM, and IN_CLD_RRTM for a cloudy one)
for the CLI.  ``make_ncbands_clouds`` (per-band
clouds ordered to reach each final running ncbands) is the port's own.
Arrays are host numpy inside the port's NamedTuples; turn them into
tensors with ``Atmosphere.from_numpy(atm, device, dtype)``.
"""

from __future__ import annotations

import numpy as np

from ..types import (Atmosphere, BandClouds, McicaClouds, McicaCloudsBlocked,
                     McicaCloudsCompact)


def make_atmosphere(ncol=4, nlay=51, seed=0, dtype=np.float64, aod=0.0):
    """A smooth, physically plausible batch of mid-latitude-ish columns.

    ``aod`` > 0 fills tauaer with a boundary-layer aerosol of total
    column optical depth ~aod per band, decaying over ~2 km."""
    rng = np.random.default_rng(seed)
    # sigma-coordinate levels, surface ~1013 mb to exactly 0.03 mb
    lev = np.linspace(0, 1, nlay + 1)
    plev = 1013.0 * (0.03 / 1013.0) ** (lev ** 1.15)
    plev = np.broadcast_to(plev, (ncol, nlay + 1)).copy()
    plev *= (1.0 + 0.02 * rng.standard_normal((ncol, 1)))
    play = 0.5 * (plev[:, :-1] + plev[:, 1:])

    # temperature: lapse to tropopause at ~12 km, warming stratosphere
    z = -7.0 * np.log(play / plev[:, :1])
    tsfc = 288.0 + 5.0 * rng.standard_normal(ncol)
    tlay = np.where(z < 12.0, tsfc[:, None] - 6.5 * z,
                    np.where(z < 20.0, tsfc[:, None] - 6.5 * 12.0,
                             tsfc[:, None] - 78.0 + 1.5 * (z - 20.0)))
    tlay = np.clip(tlay, 180.0, 320.0)
    zlev = -7.0 * np.log(plev / plev[:, :1])
    tlev = np.where(zlev < 12.0, tsfc[:, None] - 6.5 * zlev,
                    np.where(zlev < 20.0, tsfc[:, None] - 6.5 * 12.0,
                             tsfc[:, None] - 78.0 + 1.5 * (zlev - 20.0)))
    tlev = np.clip(tlev, 180.0, 320.0)

    h2o = 0.02 * (play / 1013.0) ** 3 + 3e-6
    o3 = 1e-6 * np.exp(-((np.log(play) - np.log(10.0)) ** 2) / 2.0) + 1e-8

    ones = np.ones_like(play)

    tauaer = np.zeros((ncol, nlay, 16))
    if aod > 0.0:
        w = np.exp(-z / 2.0)
        w /= w.sum(axis=1, keepdims=True)
        band = 1.0 - 0.4 * np.arange(16) / 15.0
        tauaer = aod * w[:, :, None] * band

    def arr(x):
        return np.asarray(x, dtype)

    return Atmosphere(
        play=arr(play), plev=arr(plev), tlay=arr(tlay), tlev=arr(tlev),
        tsfc=arr(tsfc),
        h2ovmr=arr(h2o), co2vmr=arr(3.55e-4 * ones), o3vmr=arr(o3),
        n2ovmr=arr(3.2e-7 * ones), covmr=arr(1.5e-7 * ones),
        ch4vmr=arr(1.7e-6 * ones), o2vmr=arr(0.209 * ones),
        cfc11vmr=arr(2.6e-10 * ones), cfc12vmr=arr(5.4e-10 * ones),
        cfc22vmr=arr(1.0e-10 * ones), ccl4vmr=arr(1.0e-10 * ones),
        emis=arr(np.full((ncol, 16), 0.95)),
        tauaer=arr(tauaer),
    )


def make_band_clouds(ncol=4, nlay=51, seed=1, dtype=np.float64):
    """A plausible two-deck per-band cloud state (imca=0): a liquid deck
    of 3 layers from layer 3-5 and an ice deck of 2 layers from
    nlay // 2 + 0-2, each of one cloud fraction per column."""
    rng = np.random.default_rng(seed)
    cldfrac = np.zeros((ncol, nlay))
    ciwp = np.zeros((ncol, nlay))
    clwp = np.zeros((ncol, nlay))
    lo = 3 + rng.integers(0, 3, ncol)
    hi = nlay // 2 + rng.integers(0, 3, ncol)
    cols = np.arange(ncol)
    # decks past the top layer pile onto it (tiny nlay)
    lo_rows = np.minimum(lo[:, None] + np.arange(3), nlay - 1)  # (ncol, 3)
    hi_rows = np.minimum(hi[:, None] + np.arange(2), nlay - 1)  # (ncol, 2)
    cldfrac[cols[:, None], lo_rows] = 0.4 + 0.4 * rng.random((ncol, 1))
    clwp[cols[:, None], lo_rows] = 20.0 + 30.0 * rng.random((ncol, 1))
    cldfrac[cols[:, None], hi_rows] = 0.3 + 0.5 * rng.random((ncol, 1))
    ciwp[cols[:, None], hi_rows] = 10.0 + 20.0 * rng.random((ncol, 1))

    def arr(x):
        return np.asarray(x, dtype)

    return BandClouds(
        cldfrac=arr(cldfrac), tauc=arr(np.zeros((ncol, nlay, 16))),
        ciwp=arr(ciwp), clwp=arr(clwp),
        reic=arr(np.full((ncol, nlay), 30.0)),
        relq=arr(np.full((ncol, nlay), 10.0)))


# the column kinds of ``make_ncbands_clouds``, by the layers (of four
# slots, bottom to top) that hold pure ice (i), ice and liquid (m) or
# liquid only (w)
NCBANDS_KINDS = ("imw.", "imwi", "i.i.", ".w.w", "....", "im..", "..mi",
                 "w.i.")


def make_ncbands_clouds(ncol=8, nlay=16, seed=3, dtype=np.float64):
    """Per-band clouds (imca=0) whose layer order drives the reference's
    running ncbands (rrtmg_lw_cldprop.f90:173-295) to each final value:
    column c takes ``NCBANDS_KINDS[c % 8]``, four slots at layers 1, 3,
    5 and max(7, nlay // 2) (where make_band_clouds puts its decks: a
    slot at the cold layers between them takes the outgoing flux of
    make_atmosphere's columns below 100 W/m2), each clear or holding
    pure ice, ice and liquid, or liquid only (the pattern of the scalar
    oracle's ordered field: pure ice below and above a mixed layer, a
    liquid-only layer).  Under iceflag 1 / liqflag 1 the final ncbands
    are 16 (ends on liquid) and 5 (ends on pure ice); under iceflag 0 a
    pure-ice column stays at 1; under liqflag 0 a liquid-only column
    stays at 1; a clear column keeps 1.  Cloud fractions 0.2-1, water
    paths 5-40 g/m2, radii across each parameterization's bounds
    (reic 8-140, relq 2-65 um)."""
    rng = np.random.default_rng(seed)
    rows = np.minimum([1, 3, 5, max(7, nlay // 2)], nlay - 1)
    cldfrac = np.zeros((ncol, nlay))
    ciwp = np.zeros((ncol, nlay))
    clwp = np.zeros((ncol, nlay))
    for c in range(ncol):
        for row, k in zip(rows, NCBANDS_KINDS[c % len(NCBANDS_KINDS)]):
            if k == ".":
                continue
            cldfrac[c, row] = 0.2 + 0.8 * rng.random()
            if k in "im":
                ciwp[c, row] = 5.0 + 35.0 * rng.random()
            if k in "mw":
                clwp[c, row] = 5.0 + 35.0 * rng.random()

    def arr(x):
        return np.asarray(x, dtype)

    return BandClouds(
        cldfrac=arr(cldfrac), tauc=arr(np.zeros((ncol, nlay, 16))),
        ciwp=arr(ciwp), clwp=arr(clwp),
        reic=arr(8.0 + 132.0 * rng.random((ncol, nlay))),
        relq=arr(2.0 + 63.0 * rng.random((ncol, nlay))))


def make_mcica_clouds(ncol=4, nlay=51, seed=2, dtype=np.float64, ngpt=140,
                      layout="compact", mask_dtype=None, clear_frac=0.0):
    """A plausible binary McICA cloud state: ~4 cloudy layers per column
    whose sub-columns are cloudy with probability 0.6, one ice and one
    liquid water path per column.  ``clear_frac`` leaves that fraction
    of columns cloud-free.

    ``layout``: "compact" (the default here; the JAX package's is
    "batch") gives ``McicaCloudsCompact``, the (nlay, 144, ncol)
    sub-column mask (float, or ``mask_dtype``) plus per-layer water
    paths; "blocked" ``McicaCloudsBlocked``, the per-g arrays
    (nlay, 144, ncol); "batch" ``McicaClouds``, (ncol, nlay, 140)."""
    rng = np.random.default_rng(seed)
    npdt = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    lo = 3 + rng.integers(0, 3, ncol)
    first = int(round(clear_frac * ncol))
    ncld = ncol - first
    cols = np.arange(first, ncol)
    rows = np.minimum(lo[cols, None] + np.arange(4), nlay - 1)  # (ncld, 4)
    if ncld:
        m = rng.random((ncld, 4, ngpt)) < 0.6
        cw = 25.0 + 20.0 * rng.random((ncld, 1, 1))
        ci = 5.0 * rng.random((ncld, 1, 1))
    else:
        m = np.zeros((0, 4, ngpt), bool)
        cw = ci = np.zeros((0, 1, 1))

    def arr(x):
        return np.asarray(x, dtype)

    reic = arr(np.full((ncol, nlay), 30.0))
    relq = arr(np.full((ncol, nlay), 10.0))
    gp = -(-ngpt // 8) * 8

    def fill_blocked(values, out_dtype=npdt):
        """(nlay, gp, ncol) with values[c, j, g] at [rows[c, j], g,
        cols[c]]: only the ~4 cloudy layers per column are written."""
        out = np.zeros((nlay, gp, ncol), out_dtype)
        for j in range(4):
            out[rows[:, j], :ngpt, cols] = values[:, j, :]
        return out

    if layout == "compact":
        mask = fill_blocked(m, npdt if mask_dtype is None else mask_dtype)
        anyc = m.any(axis=2)                        # (ncld, 4)
        ciwp_l = np.zeros((ncol, nlay))
        clwp_l = np.zeros((ncol, nlay))
        ciwp_l[cols[:, None], rows] = np.where(anyc, ci[:, :, 0], 0.0)
        clwp_l[cols[:, None], rows] = np.where(anyc, cw[:, :, 0], 0.0)
        return McicaCloudsCompact(
            cldfmc=mask, ciwp=arr(ciwp_l), clwp=arr(clwp_l),
            reicmc=reic, relqmc=relq)
    if layout == "blocked":
        return McicaCloudsBlocked(
            cldfmc=fill_blocked(m),
            ciwpmc=fill_blocked(np.where(m, ci, 0.0)),
            clwpmc=fill_blocked(np.where(m, cw, 0.0)),
            taucmc=np.zeros((nlay, gp, ncol), npdt),
            reicmc=reic, relqmc=relq)
    if layout != "batch":
        raise ValueError(f"layout must be compact, blocked or batch, got "
                         f"{layout!r}")
    cldf = np.zeros((ncol, nlay, ngpt), npdt)
    ciwp = np.zeros((ncol, nlay, ngpt), npdt)
    clwp = np.zeros((ncol, nlay, ngpt), npdt)
    if ncld:
        cldf[cols[:, None], rows] = m
        clwp[cols[:, None], rows] = np.where(m, cw, 0.0)
        ciwp[cols[:, None], rows] = np.where(m, ci, 0.0)
    return McicaClouds(
        cldfmc=arr(cldf), ciwpmc=arr(ciwp), clwpmc=arr(clwp),
        taucmc=arr(np.zeros((ncol, nlay, ngpt), npdt)), reicmc=reic,
        relqmc=relq)


def make_cloud_profile_fields(ncol=4, nlay=51, seed=0):
    """(B, L) cloud profile fields {cldfrac, ciwp, clwp, rei, rel} —
    the device-side McICA generator's inputs (mcica_subcol_lw_compact).
    One 4-layer deck of partial cloud per column."""
    rng = np.random.default_rng(seed)
    cldfrac = np.zeros((ncol, nlay), np.float32)
    lo = 3 + rng.integers(0, 3, ncol)
    rows = np.minimum(lo[:, None] + np.arange(4), nlay - 1)
    cols = np.arange(ncol)[:, None]
    cldfrac[cols, rows] = (0.3 + 0.5 * rng.random((ncol, 1))
                           ).astype(np.float32)
    wet = cldfrac > 0
    return dict(
        cldfrac=cldfrac,
        ciwp=np.where(wet, 20.0 + 15.0 * rng.random((ncol, nlay)),
                      0.0).astype(np.float32),
        clwp=np.where(wet, 15.0 + 10.0 * rng.random((ncol, nlay)),
                      0.0).astype(np.float32),
        rei=np.full((ncol, nlay), 25.0, np.float32),
        rel=np.full((ncol, nlay), 12.0, np.float32))


# the cloudy layers of write_column_deck's IN_CLD_RRTM: (layer, cloud
# fraction, cloud water path, ice fraction, rei, rel)
DECK_CLOUD_LAYERS = ((3, 0.6, 40.0, 0.2, 30.0, 10.0),
                     (4, 0.8, 60.0, 0.1, 35.0, 12.0),
                     (5, 0.3, 20.0, 0.0, 25.0, 8.0),
                     (9, 0.5, 15.0, 0.9, 60.0, 14.0),
                     (10, 0.5, 10.0, 1.0, 70.0, 14.0))


def write_column_deck(path, xsec=False, icld=0, imca=0):
    """An INPUT_RRTM in the directory ``path``: IATM=1 with AUTLAY
    layering of the built-in MODEL 2 atmosphere from 0 to 70 km, IOUT=0
    (one block, bands 1-16); with ``xsec`` four cross sections (XAMNTS,
    CCL4, CFC11, CFC12, CFC22 standard profiles); with ``icld`` the cloud
    flags (``imca``: McICA) and an IN_CLD_RRTM beside it (inflag 2,
    iceflag 3, liqflag 1, ``DECK_CLOUD_LAYERS``), icld 4/5 with records
    1.5 (IDCOR=1, JULDAT=200).  Record layouts:
    doc/rrtmg_lw_instructions.txt; -> the INPUT_RRTM path."""
    import pathlib

    def put(line, col, text):
        line = line.ljust(col - 1 + len(text))
        return line[:col - 1] + text + line[col - 1 + len(text):]

    path = pathlib.Path(path)
    rec12 = put(put("", 50, "1"), 88, "  0")        # IATM, IOUT
    if xsec:
        rec12 = put(rec12, 70, "1")                 # IXSECT
    if icld:
        rec12 = put(put(rec12, 94, str(imca)), 95, str(icld))
    lines = ["$ synthetic column deck", rec12, "294.2"]
    if icld in (4, 5):
        lines += [f"{'':8}{1:2d}", f"{'':5}{200:5d}{0.0:10.3f}"]
    lines += ["    2    2    0    1    1    7    0",
              f"{0.0:10.3f}{70.0:10.3f}", ""]
    if xsec:
        lines += ["    4    1    0",
                  "CCL4      CFC11     CFC12     CFC22     "]
    path.mkdir(parents=True, exist_ok=True)
    (path / "INPUT_RRTM").write_text("\n".join(lines + ["%"]) + "\n")
    if icld:
        rows = [f"   {2:2d}    {3:1d}    {1:1d}"] + [
            f"  {lay:3d}" + "".join(f"{v:10.5f}" for v in vals)
            for lay, *vals in DECK_CLOUD_LAYERS] + ["%"]
        (path / "IN_CLD_RRTM").write_text("\n".join(rows) + "\n")
    return path / "INPUT_RRTM"
