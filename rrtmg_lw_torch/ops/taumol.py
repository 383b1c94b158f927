"""Gaseous optical depth and Planck fractions for the 16 LW bands.

Port of ``rrtmg_lw_tpu.ops.taumol`` (rrtmg_lw_taumol.f90:299-3164).
``BAND_SPECS`` and its dataclasses are a literal copy of the JAX
package's declarative band descriptions; ``TaumolEngine`` evaluates
them with native torch indexing.  The engine is the plain version of
the taumol CUDA kernel (``ops.taumol_cuda``), which compiles the same
``BAND_SPECS`` into a flat descriptor table.

Numerical semantics replicated exactly:
  * index arithmetic ``ind0 = ((jp-1)*5+(jt-1))*nspa + js``
    (taumol.f90:563-564; upper :749-750),
  * eta interpolation with the ``oneminus`` clamp and the p^4 endpoint
    corrections for specparm < 0.125 / > 0.875 (:569-628),
  * minor-gas over-abundance column adjustments (:547-554 etc.),
  * per-band pressure corrections (:343-345, :374, :429) and the
    empirical per-g rescales (:1027-1034, :1664-1669).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import ONEMINUS
from ..types import Profile, SetcoefOut

NBANDS = 16
NG = (10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2)
NSPA = (1, 1, 9, 9, 9, 1, 9, 1, 9, 1, 1, 9, 9, 1, 9, 9)
NSPB = (1, 1, 5, 5, 5, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0, 0)

# chi_mls gas indices (rrlw_ref.f90): 1 h2o, 2 co2, 3 o3, 4 n2o, 5 co,
# 6 ch4, 7 o2
_GAS_CHI = {"h2o": 1, "co2": 2, "o3": 3, "n2o": 4, "co": 5, "ch4": 6,
            "o2": 7}


@dataclass(frozen=True)
class Adj:
    """Minor-gas over-abundance column adjustment.

    adjcol = adjfac * chi_ref * coldry * 1e-20   if rat > threshold
           = colgas                              otherwise
    where rat = 1e20 * (colgas/coldry) / chi_ref and
    adjfac = base + (rat - base)**expnt; chi_ref is chi_mls(gas, jp+1)
    unless ``chi_const`` is set (band 13: 3.55e-4, taumol.f90:2494-2498).
    """
    gas: str
    threshold: float
    base: float
    expnt: float
    chi_const: Optional[float] = None


@dataclass(frozen=True)
class Minor:
    table: str                     # e.g. 'ka_mn2o'
    kind: str                      # 'flat' | 'eta'
    col: str                       # gas column name or 'scale_*'
    adj: Optional[Adj] = None
    refrat: Optional[tuple] = None  # (gas1, gas2, plev 1-based) for eta


@dataclass(frozen=True)
class RegionSpec:
    key1: Optional[str]            # None -> no key-species term
    key2: Optional[str] = None
    rat: Optional[str] = None      # name pair for SetcoefOut rat arrays
    minors: Sequence[Minor] = field(default_factory=tuple)
    cfcs: Sequence[tuple] = field(default_factory=tuple)  # (wx idx 1-based, vec)
    taufor: bool = True
    tauself: bool = True
    corradj: Optional[str] = None  # 'b1l' | 'b1u' | 'b2'
    frac: str = "fracrefa"         # table name
    frac_eta: Optional[tuple] = None   # (gas1, gas2, plev) -> eta-interp
    postscale: Optional[dict] = None   # {g(1-based): factor}
    zero: bool = False             # taug = fracs = 0 (bands 12, 15 upper)


@dataclass(frozen=True)
class BandSpec:
    band: int
    lower: RegionSpec
    upper: RegionSpec


BAND_SPECS = (
    BandSpec(1,
        RegionSpec("h2o", minors=(Minor("ka_mn2", "flat", "scale_n2"),),
                   corradj="b1l"),
        RegionSpec("h2o", minors=(Minor("kb_mn2", "flat", "scale_n2"),),
                   corradj="b1u", tauself=False, frac="fracrefb")),
    BandSpec(2,
        RegionSpec("h2o", corradj="b2"),
        RegionSpec("h2o", tauself=False, frac="fracrefb")),
    BandSpec(3,
        RegionSpec("h2o", "co2", rat="h2oco2",
                   minors=(Minor("ka_mn2o", "eta", "adj_n2o",
                                 adj=Adj("n2o", 1.5, 0.5, 0.65),
                                 refrat=("h2o", "co2", 3)),),
                   frac_eta=("h2o", "co2", 9)),
        RegionSpec("h2o", "co2", rat="h2oco2",
                   minors=(Minor("kb_mn2o", "eta", "adj_n2o",
                                 adj=Adj("n2o", 1.5, 0.5, 0.65),
                                 refrat=("h2o", "co2", 13)),),
                   tauself=False, frac="fracrefb",
                   frac_eta=("h2o", "co2", 13))),
    BandSpec(4,
        RegionSpec("h2o", "co2", rat="h2oco2", frac_eta=("h2o", "co2", 11)),
        RegionSpec("o3", "co2", rat="o3co2", taufor=False, tauself=False,
                   frac="fracrefb", frac_eta=("o3", "co2", 13),
                   postscale={8: 0.92, 9: 0.88, 10: 1.07, 11: 1.1,
                              12: 0.99, 13: 0.88, 14: 0.943})),
    BandSpec(5,
        RegionSpec("h2o", "co2", rat="h2oco2",
                   minors=(Minor("ka_mo3", "eta", "colo3",
                                 refrat=("h2o", "co2", 7)),),
                   cfcs=((1, "ccl4"),), frac_eta=("h2o", "co2", 5)),
        RegionSpec("o3", "co2", rat="o3co2", cfcs=((1, "ccl4"),),
                   taufor=False, tauself=False, frac="fracrefb",
                   frac_eta=("o3", "co2", 43))),
    BandSpec(6,
        RegionSpec("h2o",
                   minors=(Minor("ka_mco2", "flat", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.77)),),
                   cfcs=((2, "cfc11adj"), (3, "cfc12"))),
        RegionSpec(None, cfcs=((2, "cfc11adj"), (3, "cfc12")),
                   taufor=False, tauself=False, frac="fracrefa")),
    BandSpec(7,
        RegionSpec("h2o", "o3", rat="h2oo3",
                   minors=(Minor("ka_mco2", "eta", "adj_co2",
                                 adj=Adj("co2", 3.0, 3.0, 0.79),
                                 refrat=("h2o", "o3", 3)),),
                   frac_eta=("h2o", "o3", 3)),
        RegionSpec("o3",
                   minors=(Minor("kb_mco2", "flat", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.79)),),
                   taufor=False, tauself=False, frac="fracrefb",
                   postscale={6: 0.92, 7: 0.88, 8: 1.07, 9: 1.1,
                              10: 0.99, 11: 0.855})),
    BandSpec(8,
        RegionSpec("h2o",
                   minors=(Minor("ka_mco2", "flat", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.65)),
                           Minor("ka_mo3", "flat", "colo3"),
                           Minor("ka_mn2o", "flat", "coln2o")),
                   cfcs=((3, "cfc12"), (4, "cfc22adj"))),
        RegionSpec("o3",
                   minors=(Minor("kb_mco2", "flat", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.65)),
                           Minor("kb_mn2o", "flat", "coln2o")),
                   cfcs=((3, "cfc12"), (4, "cfc22adj")),
                   taufor=False, tauself=False, frac="fracrefb")),
    BandSpec(9,
        RegionSpec("h2o", "ch4", rat="h2och4",
                   minors=(Minor("ka_mn2o", "eta", "adj_n2o",
                                 adj=Adj("n2o", 1.5, 0.5, 0.65),
                                 refrat=("h2o", "ch4", 3)),),
                   frac_eta=("h2o", "ch4", 9)),
        RegionSpec("ch4",
                   minors=(Minor("kb_mn2o", "flat", "adj_n2o",
                                 adj=Adj("n2o", 1.5, 0.5, 0.65)),),
                   taufor=False, tauself=False, frac="fracrefb")),
    BandSpec(10,
        RegionSpec("h2o"),
        RegionSpec("h2o", tauself=False, frac="fracrefb")),
    BandSpec(11,
        RegionSpec("h2o", minors=(Minor("ka_mo2", "flat", "scale_o2"),)),
        RegionSpec("h2o", minors=(Minor("kb_mo2", "flat", "scale_o2"),),
                   tauself=False, frac="fracrefb")),
    BandSpec(12,
        RegionSpec("h2o", "co2", rat="h2oco2", frac_eta=("h2o", "co2", 10)),
        RegionSpec(None, zero=True)),
    BandSpec(13,
        RegionSpec("h2o", "n2o", rat="h2on2o",
                   minors=(Minor("ka_mco2", "eta", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.68,
                                         chi_const=3.55e-4),
                                 refrat=("h2o", "n2o", 1)),
                           Minor("ka_mco", "eta", "colco",
                                 refrat=("h2o", "n2o", 3))),
                   frac_eta=("h2o", "n2o", 5)),
        RegionSpec(None,
                   minors=(Minor("kb_mo3", "flat", "colo3"),),
                   taufor=False, tauself=False, frac="fracrefb")),
    BandSpec(14,
        RegionSpec("co2"),
        RegionSpec("co2", taufor=False, tauself=False, frac="fracrefb")),
    BandSpec(15,
        RegionSpec("n2o", "co2", rat="n2oco2",
                   minors=(Minor("ka_mn2", "eta", "scale_brd",
                                 refrat=("n2o", "co2", 1)),),
                   frac_eta=("n2o", "co2", 1)),
        RegionSpec(None, zero=True)),
    BandSpec(16,
        RegionSpec("h2o", "ch4", rat="h2och4", frac_eta=("h2o", "ch4", 6)),
        RegionSpec("ch4", taufor=False, tauself=False, frac="fracrefb")),
)



# bins(): per band and cell, the interpolation bins the engine used
BIN_SLOTS = ("key_jp", "key_jp1", "frac", "minor")


def _trunc_int(x):
    return x.to(torch.int32)


def _spec_weights(specparm, fs):
    """4-tap gather weights at offsets (-1, 0, +1, +2) for the eta
    interpolation, incl. p^4 endpoint corrections (taumol.f90:569-628)."""
    low = specparm < 0.125
    high = specparm > 0.875
    p = torch.where(low, fs - 1.0, -fs)
    p2 = p * p
    p4 = p2 * p2
    fk0 = p4
    fk1 = 1.0 - p - 2.0 * p4
    fk2 = p + p4
    zero = torch.zeros_like(fs)
    w_m1 = torch.where(high, fk2, zero)
    w_0 = torch.where(low, fk0, torch.where(high, fk1, 1.0 - fs))
    w_p1 = torch.where(low, fk1, torch.where(high, fk0, fs))
    w_p2 = torch.where(low, fk2, zero)
    return (w_m1, w_0, w_p1, w_p2)


def _eta_params(colk1, colk2, rat, scale):
    """speccomb / specparm / js0 (0-based) / fs for one eta interpolation."""
    speccomb = colk1 + rat * colk2
    specparm = torch.clamp(colk1 / speccomb, max=ONEMINUS)
    specmult = scale * specparm
    js0 = _trunc_int(specmult)
    fs = specmult - js0.to(specmult.dtype)
    return speccomb, specparm, js0, fs


def refrat(chi, gas1, gas2, plev):
    """chi_mls(gas1, plev) / chi_mls(gas2, plev), plev 1-based."""
    return float(chi[_GAS_CHI[gas1] - 1, plev - 1]
                 / chi[_GAS_CHI[gas2] - 1, plev - 1])


class TaumolEngine(torch.nn.Module):
    """Fused per-band tables as buffers; evaluates taug/fracs for all
    bands over a (B, L) batch with torch gathers."""

    def __init__(self, bands: dict, chi_mls):
        super().__init__()
        self.chi = np.asarray(chi_mls, np.float64)
        self.na = {}
        self.nk = {}
        for b in range(1, NBANDS + 1):
            src = bands[f"b{b:02d}"]
            for name, v in src.items():
                if v.dim() == 3:       # eta minor (19, nk, ng) -> (19*nk, ng)
                    self.nk[b, name] = v.shape[1]
                    v = v.reshape(-1, v.shape[-1])
                self.register_buffer(f"b{b:02d}_{name}", v)
            absa, absb = src["absa"], src.get("absb")
            self.na[b] = absa.shape[0]
            fused = absa if absb is None else torch.cat([absa, absb], dim=0)
            self.register_buffer(f"b{b:02d}__abs", fused)
            ref = absa
        self.register_buffer("chi_t", torch.as_tensor(self.chi).to(
            ref.device, ref.dtype))

    def _tab(self, b, name):
        return getattr(self, f"b{b:02d}_{name}")

    def _adjusted_col(self, sc: SetcoefOut, prof: Profile, adj: Adj):
        colgas = getattr(sc, "col" + adj.gas)
        if adj.chi_const is not None:
            chiref = torch.full_like(colgas, adj.chi_const)
        else:
            chiref = self.chi_t[_GAS_CHI[adj.gas] - 1][sc.jp.long() + 1]
        # 1e20 * (colgas / coldry) / chiref, grouped so that no step of
        # its float32 vjp underflows: d(colgas / coldry) / d coldry forms
        # colgas / coldry**2 (~1e-47) and flushes to zero
        ratio = 1.0e20 * colgas / (prof.coldry * chiref)
        excess = torch.where(ratio > adj.threshold, ratio - adj.base, 1.0)
        adjfac = adj.base + excess ** adj.expnt
        adjcol = adjfac * chiref * prof.coldry * 1.0e-20
        return torch.where(ratio > adj.threshold, adjcol, colgas)

    # ------------------------------------------------------------------
    def _region(self, spec: RegionSpec, b: int, lower_region: bool,
                sc: SetcoefOut, prof: Profile):
        """taug, fracs (B, L, ng) for one band/region at ALL layers, and
        the region's interpolation bins (4 x (B, L) int32, -1 unused)."""
        ng = NG[b - 1]
        B, L = sc.jp.shape
        shape_g = (B, L, ng)
        dtype = sc.fac00.dtype
        unused = torch.full((B, L), -1, dtype=torch.int32,
                            device=sc.jp.device)
        bins = [unused] * 4
        taug = torch.zeros(shape_g, dtype=dtype, device=sc.jp.device)
        if spec.zero:
            return taug, torch.zeros_like(taug), bins

        nsp = NSPA[b - 1] if lower_region else NSPB[b - 1]
        scale = 8.0 if lower_region else 4.0
        jp, jt, jt1 = sc.jp.long(), sc.jt.long(), sc.jt1.long()

        # --- key-species term ------------------------------------------
        if spec.key1 is not None:
            colk1 = getattr(sc, "col" + spec.key1)
            if spec.key2 is not None:
                colk2 = getattr(sc, "col" + spec.key2)
                speccomb, specparm, js0, fs = _eta_params(
                    colk1, colk2, getattr(sc, "rat_" + spec.rat), scale)
                speccomb1, specparm1, js1, fs1 = _eta_params(
                    colk1, colk2, getattr(sc, "rat_" + spec.rat + "_1"),
                    scale)
                bins[0], bins[1] = js0, js1
            else:
                speccomb = speccomb1 = colk1
                js0 = js1 = torch.zeros_like(sc.jp)
                fs = fs1 = torch.zeros_like(colk1)
                specparm = specparm1 = torch.full_like(colk1, 0.5)
            js0, js1 = js0.long(), js1.long()

            if lower_region:
                row0 = (jp * 5 + jt) * nsp + js0
                row1 = ((jp + 1) * 5 + jt1) * nsp + js1
            else:
                row0 = self.na[b] + ((jp - 12) * 5 + jt) * nsp + js0
                row1 = self.na[b] + ((jp - 11) * 5 + jt1) * nsp + js1

            if lower_region and spec.key2 is not None:
                w0 = _spec_weights(specparm, fs)
                w1 = _spec_weights(specparm1, fs1)
                offs = (-1, 0, 1, 2)
            else:
                w0 = (1.0 - fs, fs)
                w1 = (1.0 - fs1, fs1)
                offs = (0, 1)

            toff = max(nsp, 1)  # temperature(+1) row stride
            tbl = self._tab(b, "_abs")
            nrow = tbl.shape[0]

            def key_term(row, facA, facB, weights):
                acc = torch.zeros(shape_g, dtype=dtype, device=tbl.device)
                for o, w in zip(offs, weights):
                    r = torch.clamp(row + o, 0, nrow - 1)
                    gA = tbl[r]
                    gB = tbl[torch.clamp(r + toff, 0, nrow - 1)]
                    acc = acc + w[..., None] * (facA[..., None] * gA
                                                + facB[..., None] * gB)
                return acc

            taug = (speccomb[..., None] * key_term(row0, sc.fac00, sc.fac10,
                                                   w0)
                    + speccomb1[..., None] * key_term(row1, sc.fac01,
                                                      sc.fac11, w1))

        # --- water-vapor continuum --------------------------------------
        if spec.tauself:
            s = self._tab(b, "selfref")
            i = sc.indself.long()
            lo, hi = s[i], s[i + 1]
            taug = taug + sc.selffac[..., None] * (
                lo + sc.selffrac[..., None] * (hi - lo))
        if spec.taufor:
            f = self._tab(b, "forref")
            i = sc.indfor.long()
            lo, hi = f[i], f[torch.clamp(i + 1, 0, 3)]
            taug = taug + sc.forfac[..., None] * (
                lo + sc.forfrac[..., None] * (hi - lo))

        # --- minor gases -------------------------------------------------
        im = sc.indminor.long()
        im1 = torch.clamp(im + 1, 0, 18)
        for m in spec.minors:
            if m.col.startswith("adj_"):
                colm = self._adjusted_col(sc, prof, m.adj)
            elif m.col == "scale_n2":
                colm = sc.colbrd * sc.scaleminorn2
            elif m.col == "scale_o2":
                colm = sc.colo2 * sc.scaleminor
            elif m.col == "scale_brd":
                colm = sc.colbrd * sc.scaleminor
            else:
                colm = getattr(sc, "col" + m.col[3:])  # 'colxxx'
            tab = self._tab(b, m.table)
            if m.kind == "flat":
                lo, hi = tab[im], tab[im1]
                absm = lo + sc.minorfrac[..., None] * (hi - lo)
            else:
                g1, g2, plev = m.refrat
                _, _, jm0, fm = _eta_params(
                    getattr(sc, "col" + g1), getattr(sc, "col" + g2),
                    refrat(self.chi, g1, g2, plev), scale)
                nk = self.nk[b, m.table]
                jm0 = torch.clamp(jm0, 0, nk - 2)
                if bins[3] is unused:
                    bins[3] = jm0
                i00 = im * nk + jm0.long()
                i01 = im1 * nk + jm0.long()
                m00, m10 = tab[i00], tab[i00 + 1]
                m01, m11 = tab[i01], tab[i01 + 1]
                a1 = m00 + fm[..., None] * (m10 - m00)
                a2 = m01 + fm[..., None] * (m11 - m01)
                absm = a1 + sc.minorfrac[..., None] * (a2 - a1)
            taug = taug + colm[..., None] * absm

        # --- CFC / CCl4 cross sections -----------------------------------
        for wx_i, vec in spec.cfcs:
            taug = taug + prof.wx[..., wx_i - 1][..., None] * self._tab(b, vec)

        # --- pressure correction factors ---------------------------------
        pp = prof.pavel
        if spec.corradj == "b1l":
            corr = torch.where(pp < 250.0,
                               1.0 - 0.15 * (250.0 - pp) / 154.4,
                               torch.ones_like(pp))
            taug = corr[..., None] * taug
        elif spec.corradj == "b1u":
            taug = (1.0 - 0.15 * (pp / 95.6))[..., None] * taug
        elif spec.corradj == "b2":
            taug = (1.0 - 0.05 * (pp - 100.0) / 900.0)[..., None] * taug

        # --- empirical per-g rescale (bands 4, 7 upper) -------------------
        if spec.postscale:
            taug = taug * taug.new_tensor(postscale_vector(spec, ng))

        # --- Planck fractions ---------------------------------------------
        ftab = self._tab(b, spec.frac)
        if spec.frac_eta is not None:
            g1, g2, plev = spec.frac_eta
            _, _, jpl0, fpl = _eta_params(
                getattr(sc, "col" + g1), getattr(sc, "col" + g2),
                refrat(self.chi, g1, g2, plev), scale)
            jpl0 = torch.clamp(jpl0, 0, ftab.shape[0] - 2)
            bins[2] = jpl0
            flo, fhi = ftab[jpl0.long()], ftab[jpl0.long() + 1]
            fracs = flo + fpl[..., None] * (fhi - flo)
        else:
            fracs = ftab.expand(shape_g)
        return taug, fracs, bins

    # ------------------------------------------------------------------
    def _evaluate(self, sc: SetcoefOut, prof: Profile):
        mask = sc.laytrop_mask
        taug, fracs, bins = [], [], []
        for bspec in BAND_SPECS:
            tl, fl, bl = self._region(bspec.lower, bspec.band, True, sc, prof)
            tu, fu, bu = self._region(bspec.upper, bspec.band, False, sc,
                                      prof)
            taug.append(torch.where(mask[..., None], tl, tu))
            fracs.append(torch.where(mask[..., None], fl, fu))
            bins.append(torch.stack([torch.where(mask, x, y)
                                     for x, y in zip(bl, bu)]))
        return torch.cat(taug, dim=-1), torch.cat(fracs, dim=-1), bins

    def forward(self, sc: SetcoefOut, prof: Profile):
        """taug, fracs with shape (B, L, 140)."""
        taug, fracs, _ = self._evaluate(sc, prof)
        return taug, fracs

    def blocked(self, sc: SetcoefOut, prof: Profile):
        """taug, fracs in the taumol kernel's (L, 140, B) layout: the
        plain version of ``taumol_cuda.taumol_blocked``."""
        taug, fracs = self(sc, prof)
        return (taug.permute(1, 2, 0).contiguous(),
                fracs.permute(1, 2, 0).contiguous())

    def bins(self, sc: SetcoefOut, prof: Profile):
        """(16, 4, L, B) int32: per band the eta bins the region of each
        cell used, in BIN_SLOTS order (-1 where a slot does not apply)."""
        _, _, bins = self._evaluate(sc, prof)
        return torch.stack(bins).permute(0, 1, 3, 2).contiguous()


def postscale_vector(spec: RegionSpec, ng: int) -> np.ndarray:
    fac = np.ones(ng)
    for g1b, v in (spec.postscale or {}).items():
        fac[g1b - 1] = v
    return fac
