"""rrtmg_lw_torch — the PyTorch/CUDA port of rrtmg_lw_tpu.

Longwave radiative transfer with RRTMG_LW's capabilities (correlated
k-distribution, 16 bands / 140 g-points, McICA and deterministic
clouds), batched over columns.
The hot path runs hand-written CUDA kernels for Hopper (``csrc/``); each
has a plain PyTorch version beside it, which the CPU runs.  This package
never imports JAX; ``rrtmg_lw_tpu`` is the reference it is tested against.
"""

from .config import LWConfig
from .models.radiation import RRTMGLW, make_model
from .types import (Atmosphere, BandClouds, Fluxes, McicaClouds,
                    McicaCloudsBlocked, McicaCloudsCompact, Profile,
                    SetcoefOut)

__version__ = "0.1.0"

__all__ = [
    "LWConfig", "Atmosphere", "BandClouds", "Fluxes", "McicaClouds",
    "McicaCloudsBlocked", "McicaCloudsCompact", "Profile", "SetcoefOut",
    "RRTMGLW", "make_model", "__version__",
]
