"""Readers for the column-mode input decks.

A numpy-only copy of ``rrtmg_lw_tpu.io.column_input`` (that package
imports JAX), unchanged.

Reimplements the reference's input processing for IATM=0 layer input:
``readprof`` (rrtmg_lw.1col.f90:755-1150, record formats :1138-1147),
``readcld`` (:1152-1209), ``readaer`` (:1211-1294) and ``xsident``
(:1296-1363).  Record layouts per doc/rrtmg_lw_instructions.txt:58-960.

The RRTATM atmosphere builder lives in rrtmg_lw_torch.io.rrtatm and is
routed to below when record 1.2 sets IATM=1.  Of the reference's
shipped decks exactly one uses it — input_rrtm_ICRCCM_sonde (a
user-supplied profile through RDUNIT records 3.4-3.6); the 12 others
carry explicit layer data (IATM=0, records 2.1.1-2.1.3), having been
*generated* with RRTATM MODEL atmospheres offline.  MODEL 1-6 profiles
and AUTLAY layering are exposed in rrtatm for programmatic use.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np

from .fortran_format import ffloat, fint, fstr

AMD = 28.9660
AMW = 18.0160
GRAV = 9.8066

# xsident alias table (rrtmg_lw.1col.f90:1322-1334): target slots are
# 1 ccl4, 2 cfc11, 3 cfc12, 4 cfc22.
_XS_ALIASES = {
    "CCL4": 1,
    "CCL3F": 2, "CFCL3": 2, "CFC11": 2, "F11": 2,
    "CCL2F2": 3, "CF2CL2": 3, "CFC12": 3, "F12": 3,
    "CHCLF2": 4, "CHF2CL": 4, "CFC22": 4, "F22": 4,
}

# IATM=1 path: XSREAD's master-list index -> RRTMG slot
# (data ixtrans /0,0,0,1,2,3,0,0,0,0,0,4,0,0/, rrtmg_lw.1col.f90:887)
_IXTRANS = {4: 1, 5: 2, 6: 3, 12: 4}


@dataclasses.dataclass
class CloudInput:
    inflag: int = 2
    iceflag: int = 3
    liqflag: int = 1
    cldfrac: Optional[np.ndarray] = None     # (L,)
    tauc: Optional[np.ndarray] = None        # (16, L)
    ciwp: Optional[np.ndarray] = None
    clwp: Optional[np.ndarray] = None
    rei: Optional[np.ndarray] = None
    rel: Optional[np.ndarray] = None


@dataclasses.dataclass
class ColumnCase:
    """Everything parsed from one INPUT_RRTM '$' block."""
    iaer: int = 0
    iatm: int = 0
    ixsect: int = 0
    numangs: int = 0
    iout: int = 0
    idrv: int = 0
    imca: int = 0
    icld: int = 0
    tbound: float = 0.0
    dtbound: float = 0.0
    semiss: Optional[np.ndarray] = None      # (16,)
    idcor: int = 0
    decorr_con: float = 0.0
    juldat: int = 0
    lat: float = 0.0
    nlayers: int = 0
    pavel: Optional[np.ndarray] = None       # (L,)
    tavel: Optional[np.ndarray] = None
    pz: Optional[np.ndarray] = None          # (L+1,) level 0 = surface
    tz: Optional[np.ndarray] = None
    altz: Optional[np.ndarray] = None        # (L+1,) km
    dz: Optional[np.ndarray] = None          # (L,) m
    coldry: Optional[np.ndarray] = None
    wkl: Optional[np.ndarray] = None         # (7, L) molec/cm2
    wbrodl: Optional[np.ndarray] = None
    wx: Optional[np.ndarray] = None          # (4, L) *1e-20
    pwvcm: float = 0.0
    clouds: Optional[CloudInput] = None
    tauaer: Optional[np.ndarray] = None      # (L, 16)


def read_input_rrtm(path, cld_path=None, aer_path=None) -> ColumnCase:
    lines = pathlib.Path(path).read_text().splitlines()
    i = 0
    # record 1.1: skip until '$'
    while i < len(lines) and not lines[i].startswith("$"):
        i += 1
    if i >= len(lines):
        raise ValueError("no '$' record in INPUT_RRTM")
    i += 1

    case = ColumnCase()
    # record 1.2  (format 9011: 18x,i2,29x,i1,19x,i1,13x,i2,2x,i3,1x,i1,1x,i1,i1)
    l = lines[i]; i += 1
    case.iaer = fint(l, 19, 2)
    case.iatm = fint(l, 50, 1)
    case.ixsect = fint(l, 70, 1)
    case.numangs = fint(l, 84, 2)
    case.iout = fint(l, 88, 3)
    case.idrv = fint(l, 92, 1)
    case.imca = fint(l, 94, 1)
    case.icld = fint(l, 95, 1)

    clouds = None
    if case.icld >= 1:
        clouds = read_in_cld_rrtm(
            cld_path or pathlib.Path(path).parent / "IN_CLD_RRTM")
    tauaer16 = None
    if case.iaer == 10:
        tauaer16 = read_in_aer_rrtm(
            aer_path or pathlib.Path(path).parent / "IN_AER_RRTM")

    # record 1.4  (format 9012: e10.3,1x,i1,2x,i1,16e5.3)
    l = lines[i]; i += 1
    case.tbound = ffloat(l, 1, 10)
    iemis = fint(l, 12, 1)
    # ireflect = fint(l, 15, 1)  (specular option not available)
    semis = np.array([ffloat(l, 16 + 5 * b, 5) for b in range(16)])
    semiss = np.ones(16)
    if iemis == 1 and semis[0] != 0.0:
        semiss[:] = semis[0]
    elif iemis == 2:
        semiss = np.where(semis != 0.0, semis, 1.0)
    case.semiss = semiss

    if case.idrv == 1:                       # record 1.4.1
        case.dtbound = ffloat(lines[i], 1, 10); i += 1
    if case.icld in (4, 5):                  # records 1.5 / 1.5.1 / 1.5.2
        case.idcor = fint(lines[i], 9, 2); i += 1
        if case.idcor == 0:
            case.decorr_con = ffloat(lines[i], 1, 10); i += 1
        elif case.idcor == 1:
            case.juldat = fint(lines[i], 6, 5)
            case.lat = ffloat(lines[i], 11, 10)
            i += 1

    if case.iatm != 0:
        # RRTATM layering (records 3.1-3.6); rrtmg_lw.1col.f90:999-1008
        from . import rrtatm as rrtatm_mod
        res, i = rrtatm_mod.read_rrtatm(lines, i, ixsect=case.ixsect)
        nlayers = res.nlayers
        nmol = res.amount.shape[0]
        case.nlayers = nlayers
        pavel, tavel = res.pavel, res.tavel
        pz, tz, altz = res.pz, res.tz, res.altz
        wkl_in = np.zeros((max(nmol, 7), nlayers))
        wkl_in[:nmol] = res.amount
        wbrodl = res.wn2l
        if case.icld in (4, 5) and case.idcor == 1:
            case.lat = res.ref_lat        # :947 (iatm=1 -> ref_lat)
        if case.ixsect == 1 and res.nxmol:
            # ixindx = ixtrans(ixindx0): master-list index -> RRTMG
            # slot (rrtmg_lw.1col.f90:887,1004-1006); wx0 = XAMNT
            nxmol0 = res.nxmol
            ixindx = [_IXTRANS.get(m, 0) for m in res.ixindx]
            wx0 = res.xamnt
        else:
            nxmol0, ixindx, wx0 = 0, [], None
        return _finish_case(case, nlayers, nmol, pavel, tavel, pz, tz,
                            altz, wkl_in, wbrodl, nxmol0, ixindx, wx0,
                            clouds, tauaer16)

    # record 2.1 (1x,i1,i3,i5)
    l = lines[i]; i += 1
    iform = fint(l, 2, 1)
    nlayers = fint(l, 3, 3)
    nmol = fint(l, 6, 5) or 7
    case.nlayers = nlayers

    pavel = np.zeros(nlayers); tavel = np.zeros(nlayers)
    pz = np.zeros(nlayers + 1); tz = np.zeros(nlayers + 1)
    altz = np.zeros(nlayers + 1)
    wkl_in = np.zeros((max(nmol, 7), nlayers))
    wbrodl = np.zeros(nlayers)

    def read_layer_head(l, first):
        if iform == 1:
            pave = ffloat(l, 1, 15)
            tave = ffloat(l, 16, 10)
            if first:     # 2(g7.2,g8.3,g7.2) after 1x at col 41
                vals = (ffloat(l, 42, 7), ffloat(l, 49, 8), ffloat(l, 57, 7),
                        ffloat(l, 64, 7), ffloat(l, 71, 8), ffloat(l, 79, 7))
            else:         # 23x then one (g7.2,g8.3,g7.2)
                vals = (ffloat(l, 64, 7), ffloat(l, 71, 8), ffloat(l, 79, 7))
        else:
            pave = ffloat(l, 1, 10)
            tave = ffloat(l, 11, 10)
            if first:     # 1x then 2(f7.2,f8.3,f7.2) from col 37
                vals = (ffloat(l, 37, 7), ffloat(l, 44, 8), ffloat(l, 52, 7),
                        ffloat(l, 59, 7), ffloat(l, 66, 8), ffloat(l, 74, 7))
            else:         # 23x then (f7.2,f8.3,f7.2) from col 59
                vals = (ffloat(l, 59, 7), ffloat(l, 66, 8), ffloat(l, 74, 7))
        return pave, tave, vals

    def read_vals(l, n, wide):
        w = 15 if wide else 10
        return [ffloat(l, 1 + k * w, w) for k in range(n)]

    for lay in range(nlayers):
        pave, tave, vals = read_layer_head(lines[i], lay == 0); i += 1
        pavel[lay], tavel[lay] = pave, tave
        if lay == 0:
            altz[0], pz[0], tz[0] = vals[0], vals[1], vals[2]
            altz[1], pz[1], tz[1] = vals[3], vals[4], vals[5]
        else:
            altz[lay + 1], pz[lay + 1], tz[lay + 1] = vals
        row = read_vals(lines[i], 8, iform == 1); i += 1
        wkl_in[:7, lay] = row[:7]
        wbrodl[lay] = row[7]
        m = 7
        while m < nmol:
            n = min(8, nmol - m)
            row = read_vals(lines[i], n, iform == 1); i += 1
            wkl_in[m:m + n, lay] = row
            m += n

    # cross-sections (IXSECT=1, record 2.2 path)
    if case.ixsect == 1:
        nxmol0 = fint(lines[i], 1, 5); i += 1
        names = []
        l = lines[i]; i += 1
        for k in range(min(nxmol0, 7)):
            names.append(fstr(l, 1 + 10 * k, 10).strip().upper())
        if nxmol0 > 7:
            l = lines[i]; i += 1
            for k in range(nxmol0 - 7):
                names.append(fstr(l, 1 + 10 * k, 10).strip().upper())
        ixindx = [_XS_ALIASES.get(n, 0) for n in names]
        iformx = fint(lines[i], 2, 1); i += 1
        wx0 = np.zeros((nxmol0, nlayers))
        for lay in range(nlayers):
            i += 1                            # dummy record 2.2.3
            row = read_vals(lines[i], min(nxmol0, 7), iformx == 1); i += 1
            wx0[:len(row), lay] = row
            if nxmol0 > 7:
                row = read_vals(lines[i], nxmol0 - 7, iformx == 1); i += 1
                wx0[7:7 + len(row), lay] = row
    else:
        nxmol0, ixindx, wx0 = 0, [], None

    return _finish_case(case, nlayers, nmol, pavel, tavel, pz, tz, altz,
                        wkl_in, wbrodl, nxmol0, ixindx, wx0, clouds,
                        tauaer16)


def _finish_case(case, nlayers, nmol, pavel, tavel, pz, tz, altz,
                 wkl_in, wbrodl, nxmol0, ixindx, wx0, clouds, tauaer16):
    """Shared post-processing for both IATM paths (rrtmg_lw.1col.f90:
    1011-1135): column conversion, pwvcm, cloud/aerosol transfer."""
    wx = np.zeros((4, nlayers))
    # mixing-ratio detection + column conversion (:1011-1053)
    imix = int(np.all(wkl_in[:nmol, 0] <= 1.0))
    coldry = np.zeros(nlayers)
    wkl = wkl_in[:7].copy()
    summol = wkl_in[1:nmol].sum(axis=0)
    if imix == 1:
        coldry = wbrodl / (1.0 - summol)
        wkl = coldry[None, :] * wkl
    else:
        coldry = wbrodl + summol
    if nxmol0:
        imixx = int(wx0[0, 0] <= 1.0)
        for ix in range(nxmol0):
            tgt = ixindx[ix]
            if tgt != 0:
                if imixx == 1:
                    wx[tgt - 1] = coldry * wx0[ix] * 1.0e-20
                else:
                    wx[tgt - 1] = wx0[ix] * 1.0e-20

    amttl = (coldry + wkl[0]).sum()
    wvttl = wkl[0].sum()
    wvsh = (AMW * wvttl) / (AMD * amttl)
    case.pwvcm = wvsh * (1.0e3 * pz[0]) / (1.0e2 * GRAV)

    if case.tbound < 0:
        case.tbound = tz[0]

    case.pavel, case.tavel, case.pz, case.tz = pavel, tavel, pz, tz
    case.altz = altz
    case.dz = (altz[1:] - altz[:-1]) * 1000.0
    case.coldry, case.wkl, case.wbrodl, case.wx = coldry, wkl, wbrodl, wx

    # cloud property conversion (:1098-1123)
    if clouds is not None:
        L = nlayers
        cld = CloudInput(clouds.inflag, clouds.iceflag, clouds.liqflag)
        cldfrac = np.zeros(L)
        tauc = np.zeros((16, L))
        ciwp = np.zeros(L); clwp = np.zeros(L)
        rei = np.zeros(L); rel = np.zeros(L)
        n = min(L, len(clouds.cldfrac))
        cldfrac[:n] = clouds.cldfrac[:n]
        d1, d2 = clouds.tauc, clouds.ciwp     # raw dat1, dat2 (see reader)
        d3, d4 = clouds.rei, clouds.rel       # raw dat3, dat4
        if clouds.inflag == 0:
            tauc[:, :n] = d1[:n]
        else:
            cwp = d1[:n]
            fice = d2[:n]
            ciwp[:n] = cwp * fice
            clwp[:n] = cwp * (1.0 - fice)
            rei[:n] = d3[:n]
            rel[:n] = d4[:n]
        cld.cldfrac, cld.tauc = cldfrac, tauc
        cld.ciwp, cld.clwp, cld.rei, cld.rel = ciwp, clwp, rei, rel
        case.clouds = cld

    case.tauaer = np.zeros((nlayers, 16))
    if tauaer16 is not None:
        n = min(nlayers, tauaer16.shape[0])
        case.tauaer[:n] = tauaer16[:n]
    return case


def read_in_cld_rrtm(path) -> CloudInput:
    """IN_CLD_RRTM reader (readcld, rrtmg_lw.1col.f90:1152-1209).

    Raw dat1..dat4 are stored in the tauc/ciwp/rei/rel slots; the
    inflag-dependent conversion happens in read_input_rrtm.
    """
    lines = pathlib.Path(path).read_text().splitlines()
    l = lines[0]                              # format (3x,i2,4x,i1,4x,i1)
    out = CloudInput(inflag=fint(l, 4, 2), iceflag=fint(l, 10, 1),
                     liqflag=fint(l, 15, 1))
    L = 603
    cldfrac = np.zeros(L)
    d1 = np.zeros(L); d2 = np.zeros(L); d3 = np.zeros(L); d4 = np.zeros(L)
    for l in lines[1:]:
        if not l or l[0] == "%":
            break
        lay = fint(l, 3, 3)                   # (a1,1x,i3,5e10.5)
        cldfrac[lay - 1] = ffloat(l, 6, 10)
        d1[lay - 1] = ffloat(l, 16, 10)
        d2[lay - 1] = ffloat(l, 26, 10)
        d3[lay - 1] = ffloat(l, 36, 10)
        d4[lay - 1] = ffloat(l, 46, 10)
    out.cldfrac, out.tauc, out.ciwp = cldfrac, d1, d2
    out.rei, out.rel = d3, d4
    return out


def read_in_aer_rrtm(path) -> np.ndarray:
    """IN_AER_RRTM reader (readaer, :1211-1294). Returns (L, 16) AOD."""
    lines = pathlib.Path(path).read_text().splitlines()
    naer = fint(lines[0], 4, 2)               # (3x,i2)
    i = 1
    tauaer = np.zeros((603, 16))
    for _ in range(naer):
        nlay = fint(lines[i], 3, 3)           # (2x,i3,4x,i1)
        i += 1
        for _ in range(nlay):
            l = lines[i]; i += 1
            lay = fint(l, 3, 3)               # (2x,i3,16f7.4)
            aod = [ffloat(l, 6 + 7 * b, 7) for b in range(16)]
            if tauaer[lay - 1].max() >= 1e-10:
                raise ValueError(f"layer {lay} has more than one aerosol")
            tauaer[lay - 1] = aod
    return tauaer
