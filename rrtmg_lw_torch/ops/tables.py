"""Exponential / tau-transition lookup tables (``use_lut=True``).

A numpy-only copy of ``rrtmg_lw_tpu.ops.tables`` (importing that
package would import JAX).  Mirrors rrtmg_lw_init.f90:125-142:
10001-entry tables over the Pade-transformed optical depth, which the
plain RT sweep reads for the transmittance and the linear-in-tau Planck
transition function, indexed by ``int(TBLINT * od / (BPADE + od) + 0.5)``
(``rtrn._lut_index``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..constants import BPADE, EXPEPS, NTBL

LUT_NAMES = ("tau_tbl", "exp_tbl", "tfn_tbl")


class LookupTables(NamedTuple):
    tau_tbl: np.ndarray   # (NTBL+1,)
    exp_tbl: np.ndarray   # (NTBL+1,)
    tfn_tbl: np.ndarray   # (NTBL+1,)


def build_lookup_tables() -> LookupTables:
    itr = np.arange(1, NTBL, dtype=np.float64)
    tfn = itr / float(NTBL)
    tau = BPADE * tfn / (1.0 - tfn)
    expv = np.maximum(np.exp(-tau), EXPEPS)
    tf = np.where(tau < 0.06, tau / 6.0,
                  1.0 - 2.0 * ((1.0 / tau) - (expv / (1.0 - expv))))
    tau_tbl = np.concatenate([[0.0], tau, [1.0e10]])
    exp_tbl = np.concatenate([[1.0], expv, [EXPEPS]])
    tfn_tbl = np.concatenate([[0.0], tf, [1.0]])
    return LookupTables(tau_tbl, exp_tbl, tfn_tbl)
