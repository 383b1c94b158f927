"""Fortran fixed-format field helpers for the column-mode text files.

A numpy-only copy of ``rrtmg_lw_tpu.io.fortran_format`` (that package
imports JAX), unchanged.

Reading follows Fortran list semantics: a field is a fixed column span;
an all-blank field reads as 0.  Writing reproduces Fortran F-edit
behavior, including the dropped leading zero when the field is too
narrow for "0." (e.g. f6.5 of 0.067 -> ".06700"), which the reference
output files rely on (rrtmg_lw.1col.f90:737-743).
"""

from __future__ import annotations

import decimal as _decimal


def ffloat(line: str, start: int, width: int) -> float:
    """Read a float from 1-based column ``start``, ``width`` chars."""
    s = line[start - 1: start - 1 + width].strip()
    if not s:
        return 0.0
    # Fortran accepts 'D' exponents and missing 'E' (e.g. 1.0-10)
    s = s.replace("d", "e").replace("D", "e")
    try:
        return float(s)
    except ValueError:
        import re
        m = re.fullmatch(r"([+-]?[0-9]*\.?[0-9]+)([+-][0-9]+)", s)
        if m:
            return float(m.group(1) + "e" + m.group(2))
        raise


def fint(line: str, start: int, width: int) -> int:
    s = line[start - 1: start - 1 + width].strip()
    return int(s) if s else 0


def fstr(line: str, start: int, width: int) -> str:
    return line[start - 1: start - 1 + width]


_QUANTA = {}


def fmt_f(value: float, width: int, decimals: int) -> str:
    """Fortran Fw.d edit descriptor.

    Ties round HALF AWAY FROM ZERO (the reference goldens were printed
    that way: pz=775.25 appears as 775.3 in output_rrtm_SAW-clr level
    10), where Python's ``format`` rounds half-to-even (775.2).  The
    exact binary value decides the tie, so convert through Decimal."""
    q = _QUANTA.get(decimals)
    if q is None:
        q = _QUANTA[decimals] = _decimal.Decimal(1).scaleb(-decimals)
    d = _decimal.Decimal(value).quantize(q,
                                         rounding=_decimal.ROUND_HALF_UP)
    s = f"{d:{width}.{decimals}f}"
    if len(s) > width:
        # Fortran drops the leading zero of "0." / "-0." if that makes
        # the value fit
        if s.startswith("0."):
            s = s[1:]
        elif s.startswith("-0."):
            s = "-" + s[2:]
    if len(s) > width:
        return "*" * width
    return s.rjust(width)


def fmt_i(value: int, width: int) -> str:
    s = str(int(value))
    return "*" * width if len(s) > width else s.rjust(width)
