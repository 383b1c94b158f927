"""The main-path model: batched longwave radiative transfer.

PyTorch port of ``rrtmg_lw_tpu.models.radiation.RRTMGLW`` for the
forward clear-sky and McICA-cloudy step (the JAX model's blocked
branch, models/radiation.py:161-183, 256-269).  One step runs

  inatm -> setcoef -> taumol (K2) -> taut = taug + taua[..., ngb]
  -> Planck at layer and level temperatures (K3)
  -> ice/liquid coefficients (K4, cloudy only) -> RT sweep (K1)
  -> heating rates from the fluxes.

With ``impl="cuda"`` the four stages marked K run the hand-written CUDA
kernels, each inside a ``torch.autograd.Function`` whose backward is a
kernel too (K5 taumol, K3b Planck, K6 RT; K4's inputs are not
differentiated); with ``impl="eager"`` their plain PyTorch versions, on
the same layouts, under plain autograd.  Configurations outside this
slice raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import LWConfig
from ..constants import heatfac
from ..data.ktables import STATIC_TENSORS, Tables, load_tables
from ..ops import cldprop, rtrn
from ..ops.cldcoef_cuda import ice_liq_coeffs_blocked
from ..ops.inatm import inatm
from ..ops.planck_cuda import planck_interp_blocked
from ..ops.rtrn_cuda import rt_fluxes_blocked
from ..ops.setcoef import interp_planck_blocked, setcoef
from ..ops.taumol import TaumolEngine
from ..ops.taumol_cuda import taumol_blocked
from ..types import Atmosphere, Fluxes, McicaCloudsCompact, Profile


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to rrtmg_lw_torch yet; see ROADMAP.md "
        f"{item}")


def check_supported(cfg: LWConfig) -> None:
    """Raise NotImplementedError for configurations outside the slice."""
    if cfg.icld != 0 and cfg.imca != 1:
        raise _unported(f"icld={cfg.icld} without McICA (imca=0)",
                        "Queue 1 item 10")
    if cfg.icld not in range(6):
        raise ValueError(f"icld must be 0..5, got {cfg.icld}")
    if cfg.idrv != 0:
        raise _unported("idrv=1 (dF/dT surface)", "Queue 1 item 10")
    if cfg.use_lut:
        raise _unported("use_lut=True (exp/tfn lookup tables)",
                        "Queue 1 item 10")
    if (cfg.istart, cfg.iend) != (1, 16):
        raise _unported("a band subset (istart/iend)", "Queue 1 item 10")
    if cfg.icld != 0 and cfg.inflag != 2:
        raise _unported(f"inflag={cfg.inflag}", "Queue 1 item 10")


class RRTMGLW(torch.nn.Module):
    """Holds the k-tables and static tables as buffers on one device;
    ``model(atm, clouds)`` returns Fluxes."""

    def __init__(self, config: LWConfig = LWConfig(), device="cpu",
                 tables: Optional[Tables] = None):
        super().__init__()
        check_supported(config)
        self.config = config
        device = torch.device(device)
        self.impl = config.resolve_impl(device)
        dtype = config.torch_dtype
        if self.impl == "cuda" and dtype != torch.float32:
            raise ValueError("the CUDA kernels run in float32; use "
                             "dtype='float32' or impl='eager'")
        if tables is None:
            tables = load_tables(device, dtype)
        self.static_np = tables.static
        self.ktables = tables.ktables
        self.is_real_kdata = tables.is_real
        for name, t in tables.static_t.items():
            self.register_buffer(name, t.to(device, dtype))
        self.engine = TaumolEngine(
            {bk: {k: v.to(device, dtype) for k, v in tabs.items()}
             for bk, tabs in tables.bands.items()},
            tables.static["chi_mls"])
        self.register_buffer("kernel_tabs", tables.kernel_tabs.to(device))
        self.register_buffer("kernel_desc", tables.kernel_desc.to(device))
        ngb0, wg = rtrn.g_tables(tables.static, device, dtype)
        self.register_buffer("ngb0", ngb0)
        self.register_buffer("wg", wg)
        self.heatfac = heatfac(config.cpdair)

    def static_tensors(self) -> dict:
        """The static-table buffers by name (setcoef, cloud optics)."""
        return {k: getattr(self, k) for k in STATIC_TENSORS}

    def forward(self, atm: Atmosphere,
                clouds: Optional[McicaCloudsCompact] = None) -> Fluxes:
        return self.from_profile(inatm(atm, dtype=self.config.torch_dtype),
                                 clouds)

    def from_profile(self, prof: Profile,
                     clouds: Optional[McicaCloudsCompact] = None) -> Fluxes:
        """The step from an already-processed Profile (after inatm)."""
        cfg = self.config
        cuda = self.impl == "cuda"
        static = self.static_tensors()
        sc = setcoef(prof, static, planck=False)

        if cuda:
            taug_t, fracs_t = taumol_blocked(sc, prof, self.engine,
                                             self.kernel_tabs,
                                             self.kernel_desc)
        else:
            taug_t, fracs_t = self.engine.blocked(sc, prof)
        # (L, 140, B) += aerosol optical depth of each g-point's band.  The
        # band -> g gather runs on a contiguous (L, 16, B) copy: gathering
        # from the permuted view leaves a strided operand that made this
        # add alone ~4.8 ms of a 13.8 ms step on the H100.
        taua_t = prof.taua.permute(1, 2, 0).contiguous()
        taut_t = taug_t.add_(taua_t.index_select(1, self.ngb0.long()))

        planck = planck_interp_blocked if cuda else interp_planck_blocked
        planklay_t = planck(prof.tavel.t().contiguous(), self.totplnk)
        planklev_t = planck(prof.tz.t().contiguous(), self.totplnk)

        cloud_fields = bounds_ok = None
        if cfg.icld != 0 and clouds is not None:
            if not isinstance(clouds, McicaCloudsCompact):
                raise _unported(f"{type(clouds).__name__} clouds (only "
                                "McicaCloudsCompact)", "Queue 1 item 10")
            abi_t, abl_t, bounds_ok = cldprop.cloud_optics_bands_blocked(
                clouds, static, iceflag=cfg.iceflag, liqflag=cfg.liqflag,
                coeffs=(ice_liq_coeffs_blocked if cuda
                        else cldprop.ice_liq_coeffs_blocked))
            cw_t = torch.stack([clouds.ciwp.t(), clouds.clwp.t()],
                               dim=1).to(taut_t.dtype).contiguous()
            cloud_fields = (clouds.cldfmc, cw_t, abi_t, abl_t)

        rt = rt_fluxes_blocked if cuda else rtrn.rt_fluxes_blocked
        fl = rt(taut_t, fracs_t, planklay_t, planklev_t, sc.plankbnd,
                prof.semiss, prof.pwvcm, self.ngb0, self.wg, cloud_fields)
        uflx, dflx, uflxc, dflxc = (f.t() for f in fl)
        return Fluxes(uflx, dflx, rtrn.heating(uflx - dflx, prof.pz,
                                               self.heatfac),
                      uflxc, dflxc, rtrn.heating(uflxc - dflxc, prof.pz,
                                                 self.heatfac),
                      cld_bounds_ok=bounds_ok)


def make_model(config: LWConfig = LWConfig(), device="cpu",
               tables: Optional[Tables] = None) -> RRTMGLW:
    """``tables``: a ``data.ktables.Tables`` (e.g. from
    ``tables_from_numpy(jax_model.ktables, jax_model.static_np)``) in
    place of loading the assets."""
    return RRTMGLW(config, device=device, tables=tables)
