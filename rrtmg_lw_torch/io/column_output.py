"""OUTPUT_RRTM writer, byte-compatible with the reference format.

A numpy-only copy of ``rrtmg_lw_tpu.io.column_output``; the version
footer names this package.

Replicates the flux-table write block of rrtmg_lw.1col.f90:615-704 and
its edit descriptors (:737-750): the pressure field switches precision
with magnitude (formats 9952-9958) and each block ends with a form-feed
line (page = char(12), :401).
"""

from __future__ import annotations

import numpy as np

from .fortran_format import fmt_f, fmt_i

PAGE = "\x0c"

# per-band wavenumber limits (rrlw_wvn; rrtmg_lw_init.f90:215-220)
WAVENUM1 = (10., 350., 500., 630., 700., 820., 980., 1080., 1180.,
            1390., 1480., 1800., 2080., 2250., 2380., 2600.)
WAVENUM2 = (350., 500., 630., 700., 820., 980., 1080., 1180., 1390.,
            1480., 1800., 2080., 2250., 2380., 2600., 3250.)


def _row(i, pz, uf, df, fnet, htr):
    """One table row; format selected on pz (rrtmg_lw.1col.f90:616-636)."""
    if pz < 1.0e-2:
        head = " " + fmt_i(i, 3) + " " * 9 + fmt_f(pz, 7, 6) + " " * 3
    elif pz < 1.0e-1:
        head = " " + fmt_i(i, 3) + " " * 9 + fmt_f(pz, 6, 5) + " " * 4
    elif pz < 1.0:
        head = " " + fmt_i(i, 3) + " " * 8 + fmt_f(pz, 6, 4) + " " * 5
    elif pz < 10.0:
        head = " " + fmt_i(i, 3) + " " * 7 + fmt_f(pz, 6, 3) + " " * 6
    elif pz < 100.0:
        head = " " + fmt_i(i, 3) + " " * 6 + fmt_f(pz, 6, 2) + " " * 7
    else:
        head = " " + fmt_i(i, 3) + " " * 5 + fmt_f(pz, 6, 1) + " " * 8
    return (head + fmt_f(uf, 8, 4) + " " * 6 + fmt_f(df, 8, 4) + " " * 6
            + fmt_f(fnet, 12, 7) + " " * 10 + fmt_f(htr, 9, 5))


def format_flux_table(istart: int, iend: int, iplon: int, pz, uflx, dflx,
                      fnet, htr) -> str:
    """One output block: header + rows TOA->surface + form feed.

    pz/uflx/dflx/fnet: (L+1,) level arrays, level 0 = surface;
    htr: (L,) per-layer heating rates (TOA level prints 0).
    """
    L = len(pz) - 1
    out = [" Wavenumbers: " + fmt_f(WAVENUM1[istart - 1], 6, 1) + " - "
           + fmt_f(WAVENUM2[iend - 1], 6, 1) + " cm-1, ATM " + fmt_i(iplon, 6)]
    out.append(" LEVEL    PRESSURE   UPWARD FLUX   DOWNWARD FLUX    "
               "NET FLUX       HEATING RATE")
    out.append("             mb          W/m2          W/m2           "
               "W/m2          degree/day")
    for i in range(L, -1, -1):
        h = 0.0 if i == L else float(htr[i])
        out.append(_row(i, float(pz[i]), float(uflx[i]), float(dflx[i]),
                        float(fnet[i]), h))
    out.append(PAGE)
    return "\n".join(out) + "\n"


def version_footer() -> str:
    from .. import __version__
    rows = [("rrtmg_lw_torch", __version__)]
    lines = ["  Modules and versions used in this calculation:", ""]
    for name, ver in rows:
        lines.append(f"     {name:<20s}  {ver:<18s}")
    return "\n".join(lines) + "\n"


def write_output_rrtm(path, blocks, footer=True):
    with open(path, "w") as f:
        for b in blocks:
            f.write(b)
        if footer:
            f.write(version_footer())
