"""GCM input adapter: vmr -> molecular column amounts.

Port of ``rrtmg_lw_tpu.ops.inatm.inatm`` (rrtmg_lw_rad.f90:598-924):
hydrostatic dry-air column, broadening-gas column, precipitable water
and the 1e-20 scaling of the cross-section (CFC/CCl4) amounts.
"""

from __future__ import annotations

import torch

from ..constants import AMD, AMW, AVOGAD, GRAV
from ..types import Atmosphere, Profile


def inatm(atm: Atmosphere, dtype=torch.float64) -> Profile:
    def f(x):
        return x.to(dtype)

    play, plev, tlay, tlev = f(atm.play), f(atm.plev), f(atm.tlay), f(atm.tlev)
    h2o = f(atm.h2ovmr)
    # molecular weight of moist air, per layer (rrtmg_lw_rad.f90:807)
    amm = (1.0 - h2o) * AMD + h2o * AMW
    dp = plev[:, :-1] - plev[:, 1:]                    # (B, L), positive
    coldry = dp * 1.0e3 * AVOGAD / (1.0e2 * GRAV * amm * (1.0 + h2o))

    vmr = torch.stack([h2o, f(atm.co2vmr), f(atm.o3vmr), f(atm.n2ovmr),
                       f(atm.covmr), f(atm.ch4vmr), f(atm.o2vmr)], dim=-1)
    summol = vmr[..., 1:].sum(dim=-1)
    wbrodl = coldry * (1.0 - summol)
    wkl = coldry[..., None] * vmr

    wx_vmr = torch.stack([f(atm.ccl4vmr), f(atm.cfc11vmr), f(atm.cfc12vmr),
                          f(atm.cfc22vmr)], dim=-1)
    wx = coldry[..., None] * wx_vmr * 1.0e-20

    amttl = (coldry + wkl[..., 0]).sum(dim=-1)         # (B,)
    wvttl = wkl[..., 0].sum(dim=-1)
    wvsh = (AMW * wvttl) / (AMD * amttl)
    pwvcm = wvsh * (1.0e3 * plev[:, 0]) / (1.0e2 * GRAV)

    return Profile(pavel=play, tavel=tlay, pz=plev, tz=tlev,
                   tbound=f(atm.tsfc), semiss=f(atm.emis), coldry=coldry,
                   wkl=wkl, wbrodl=wbrodl, wx=wx, pwvcm=pwvcm,
                   taua=f(atm.tauaer))
