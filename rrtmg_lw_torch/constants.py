"""Physical and model constants.

A numpy-only copy of rrtmg_lw_tpu.constants (importing that package
would import JAX).  Values mirror the reference exactly:
  * physical constants  rrtmg_lw_init.f90:247-267 (NIST 2002, cgs)
  * oneminus / fluxfac  rrtmg_lw_rad.f90:451-453
  * diffusivity-angle fit coefficients rrtmg_lw_rtrnmc.f90:251-269
  * lookup-table parameters rrlw_tbl.f90:34-43
"""

import math

import numpy as np

GRAV = 9.8066            # m s-2
PLANCK = 6.62606876e-27  # erg s
BOLTZ = 1.3806503e-16    # erg K-1
CLIGHT = 2.99792458e+10  # cm s-1
AVOGAD = 6.02214199e+23  # mol-1
ALOSMT = 2.6867775e+19   # cm-3
GASCON = 8.31447200e+07  # erg mol-1 K-1
RADCN1 = 1.191042722e-12 # W cm2 sr-1
RADCN2 = 1.4387752       # cm K
SBCNST = 5.670400e-04    # W cm-2 K-4
SECDY = 8.6400e4         # s day-1

ONEMINUS = 1.0 - 1.0e-6
PI = 2.0 * math.asin(1.0)
FLUXFAC = PI * 2.0e4     # radiance -> flux (W/m2)
WTDIFF = 0.5             # diffusivity-angle Gaussian weight
REC_6 = 0.166667

# Specific heat of dry air used by the drivers (J kg-1 K-1):
CPDAIR_COLUMN = 1.004e3  # rrtmg_lw.1col.f90:347
CPDAIR_NC = 1003.5       # rrlw_ncpar.f90:7


def heatfac(cpdair: float = CPDAIR_COLUMN) -> float:
    """K/day per (W m-2 / mb); rrtmg_lw_init.f90:298."""
    return GRAV * SECDY / (cpdair * 1.0e2)


# Exponential / tau-transition lookup tables (rrlw_tbl.f90)
NTBL = 10000
TBLINT = 10000.0
PADE = 0.278
BPADE = 1.0 / PADE
EXPEPS = 1.0e-20

# Diffusivity angle secant: 1.66 except bands 2-3, 5-9 where it varies with
# precipitable water (rtrnmc.f90:258-281).
SECDIFF_A0 = np.array([1.66, 1.55, 1.58, 1.66, 1.54, 1.454, 1.89, 1.33,
                       1.668, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66])
SECDIFF_A1 = np.array([0.00, 0.25, 0.22, 0.00, 0.13, 0.446, -0.10, 0.40,
                       -0.006, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00])
SECDIFF_A2 = np.array([0.00, -12.0, -11.7, 0.00, -0.72, -0.243, 0.19, -0.062,
                       0.414, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00])
SECDIFF_FIXED = np.array([b == 0 or b == 3 or b >= 9 for b in range(16)])

# Molecular weights for inatm (rrtmg_lw_rad.f90:728-729)
AMD = 28.9660   # dry air g/mol
AMW = 18.0160   # water vapor g/mol

# ipat band -> cloud-band mapping for ncbands in {1, 5, 16}
# (rrtmg_lw_rtrn.f90:252-254 / cldprmc icb at rrtmg_lw_cldprmc.f90:164)
IPAT = np.array([
    [1] * 16,
    [1, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5],
    list(range(1, 17)),
], dtype=np.int32)
