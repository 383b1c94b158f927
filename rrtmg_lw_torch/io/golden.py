"""Parser + comparator for OUTPUT_RRTM-format files.

A numpy-only copy of ``rrtmg_lw_tpu.io.golden`` (that package
imports JAX), unchanged.

The reference's regression contract is its committed golden outputs
(run_examples_std_atm/output_rrtm_*, SURVEY §4); comparisons are done on
the parsed numbers: fluxes within 0.5 W/m2, heating rates within
0.1 K/day (README.md:19).
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import List

import numpy as np

_HDR = re.compile(r"\s*Wavenumbers:\s*([0-9.]+)\s*-\s*([0-9.]+)\s*cm-1")


@dataclasses.dataclass
class FluxBlock:
    wavenum1: float
    wavenum2: float
    level: np.ndarray
    pz: np.ndarray
    uflx: np.ndarray
    dflx: np.ndarray
    fnet: np.ndarray
    htr: np.ndarray


def parse_output_rrtm(path) -> List[FluxBlock]:
    blocks = []
    cur = None
    for line in pathlib.Path(path).read_text().splitlines():
        m = _HDR.match(line)
        if m:
            cur = FluxBlock(float(m.group(1)), float(m.group(2)),
                            [], [], [], [], [], [])
            blocks.append(cur)
            continue
        if cur is None or "PRESSURE" in line or "degree/day" in line:
            continue
        parts = line.split()
        if len(parts) == 6:
            try:
                vals = [float(p) for p in parts]
            except ValueError:
                continue
            cur.level.append(int(parts[0]))
            cur.pz.append(vals[1])
            cur.uflx.append(vals[2])
            cur.dflx.append(vals[3])
            cur.fnet.append(vals[4])
            cur.htr.append(vals[5])
    out = []
    for b in blocks:
        if not b.level:
            continue
        out.append(FluxBlock(
            b.wavenum1, b.wavenum2, np.array(b.level),
            np.array(b.pz), np.array(b.uflx), np.array(b.dflx),
            np.array(b.fnet), np.array(b.htr)))
    return out


def compare_outputs(path_a, path_b):
    """Max abs differences per quantity across matching blocks."""
    A, B = parse_output_rrtm(path_a), parse_output_rrtm(path_b)
    if len(A) != len(B):
        raise ValueError(f"block count differs: {len(A)} vs {len(B)}")
    diffs = dict(uflx=0.0, dflx=0.0, fnet=0.0, htr=0.0, pz=0.0)
    for a, b in zip(A, B):
        if len(a.level) != len(b.level):
            raise ValueError("level count differs")
        for q in diffs:
            diffs[q] = max(diffs[q],
                           float(np.abs(getattr(a, q) - getattr(b, q)).max()))
    return diffs
