"""The main-path model: batched longwave radiative transfer.

PyTorch port of ``rrtmg_lw_tpu.models.radiation.RRTMGLW`` for the
forward clear-sky, McICA-cloudy and deterministic-cloud step (the JAX
model's blocked branch, models/radiation.py:161-183, 256-269,
297-358).  One step runs

  inatm -> setcoef -> taumol (K2) -> taut = taug + taua[..., ngb]
  -> Planck at layer and level temperatures (K3)
  -> cloud optics: ice/liquid coefficients (K4; McICA, and per-band
     clouds with inflag=2)
  -> RT sweep (K1: clear, compact McICA, banded icld=1, or maxrand
     icld 2/3 after the overlap rows of the cloud fraction)
  -> heating rates from the fluxes.

With ``impl="cuda"`` the stages marked K (and the overlap rows) run the
hand-written CUDA kernels, each inside a ``torch.autograd.Function``
whose backward is a kernel too for clear sky and McICA (K5 taumol, K3b
Planck, K6 RT; K4's inputs are not differentiated; the banded and
maxrand backward raise on the card); with ``impl="eager"`` their plain
PyTorch versions, on the same layouts, under plain autograd.
Configurations outside the port raise ``NotImplementedError`` naming
the ROADMAP item that ports them.

The model runs on the CUDA device unless ``device`` names another.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import LWConfig, resolve_device
from ..constants import heatfac
from ..data.ktables import STATIC_TENSORS, Tables, load_tables
from ..ops import cldprop, rtrn, rtrnmr
from ..ops.cldcoef_cuda import ice_liq_coeffs_blocked
from ..ops.inatm import inatm
from ..ops.planck_cuda import planck_interp_blocked
from ..ops.rtrn_cuda import (rt_fluxes_banded, rt_fluxes_blocked,
                             rt_fluxes_maxrand)
from ..ops.rtrnmr_cuda import overlap_rows
from ..ops.setcoef import interp_planck_blocked, setcoef
from ..ops.taumol import TaumolEngine
from ..ops.taumol_cuda import taumol_blocked
from ..types import (Atmosphere, BandClouds, Fluxes, McicaCloudsCompact,
                     Profile)


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to rrtmg_lw_torch yet; see ROADMAP.md "
        f"{item}")


def check_supported(cfg: LWConfig) -> None:
    """Raise NotImplementedError for configurations outside the port."""
    if cfg.icld not in range(6):
        raise ValueError(f"icld must be 0..5, got {cfg.icld}")
    if cfg.icld != 0 and cfg.imca != 1:
        if cfg.icld > 3:
            raise _unported(f"icld={cfg.icld} without McICA (imca=0)",
                            "Queue 1 item 10")
        if not cldprop.cloud_bands_static(cfg.inflag, cfg.iceflag,
                                          cfg.liqflag):
            raise _unported(
                f"per-band clouds with inflag={cfg.inflag}, iceflag="
                f"{cfg.iceflag}, liqflag={cfg.liqflag} (cldprop_ncbands)",
                "Queue 1 item 10")
    if cfg.idrv != 0:
        raise _unported("idrv=1 (dF/dT surface)", "Queue 1 item 10")
    if cfg.use_lut:
        raise _unported("use_lut=True (exp/tfn lookup tables)",
                        "Queue 1 item 10")
    if (cfg.istart, cfg.iend) != (1, 16):
        raise _unported("a band subset (istart/iend)", "Queue 1 item 10")
    if cfg.icld != 0 and cfg.imca == 1 and cfg.inflag != 2:
        raise _unported(f"McICA with inflag={cfg.inflag}", "Queue 1 item 10")


class RRTMGLW(torch.nn.Module):
    """Holds the k-tables and static tables as buffers on one device;
    ``model(atm, clouds)`` returns Fluxes."""

    def __init__(self, config: LWConfig = LWConfig(), device=None,
                 tables: Optional[Tables] = None):
        super().__init__()
        check_supported(config)
        self.config = config
        device = resolve_device(device)
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

    def forward(self, atm: Atmosphere, clouds=None) -> Fluxes:
        """``clouds``: None (clear sky), ``McicaCloudsCompact`` (imca=1)
        or ``BandClouds`` (imca=0)."""
        return self.from_profile(inatm(atm, dtype=self.config.torch_dtype),
                                 clouds)

    def from_profile(self, prof: Profile, clouds=None) -> Fluxes:
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

        rt_args = (taut_t, fracs_t, planklay_t, planklev_t, sc.plankbnd,
                   prof.semiss, prof.pwvcm, self.ngb0, self.wg)
        coeffs = (ice_liq_coeffs_blocked if cuda
                  else cldprop.ice_liq_coeffs_blocked)
        bounds_ok = None
        if cfg.icld == 0 or clouds is None:
            fl = (rt_fluxes_blocked if cuda
                  else rtrn.rt_fluxes_blocked)(*rt_args)
        elif cfg.imca == 1:
            if isinstance(clouds, BandClouds):
                raise TypeError("BandClouds need imca=0; McICA (imca=1) "
                                "takes McicaCloudsCompact")
            if not isinstance(clouds, McicaCloudsCompact):
                raise _unported(f"{type(clouds).__name__} clouds (only "
                                "McicaCloudsCompact)", "Queue 1 item 10")
            abi_t, abl_t, bounds_ok = cldprop.cloud_optics_bands_blocked(
                clouds, static, iceflag=cfg.iceflag, liqflag=cfg.liqflag,
                coeffs=coeffs)
            cw_t = torch.stack([clouds.ciwp.t(), clouds.clwp.t()],
                               dim=1).to(taut_t.dtype).contiguous()
            fl = (rt_fluxes_blocked if cuda else rtrn.rt_fluxes_blocked)(
                *rt_args, (clouds.cldfmc, cw_t, abi_t, abl_t))
        else:
            if not isinstance(clouds, BandClouds):
                raise TypeError(f"imca=0 takes BandClouds, got "
                                f"{type(clouds).__name__}")
            # per-band cloud od stays at band resolution into the kernel,
            # which expands it to g by ngb
            taucb_t, bounds_ok = cldprop.cldprop_banded_blocked(
                clouds, static, inflag=cfg.inflag,
                iceflag=cfg.iceflag, liqflag=cfg.liqflag, coeffs=coeffs)
            cldfrac = clouds.cldfrac.to(taut_t.dtype)
            if cfg.icld == 1:
                fl = (rt_fluxes_banded if cuda else rtrn.rt_fluxes_banded)(
                    *rt_args, cldfrac.t().contiguous(), taucb_t)
            else:
                rows = (overlap_rows if cuda
                        else rtrnmr.overlap_rows)(cldfrac.contiguous())
                fl = (rt_fluxes_maxrand if cuda
                      else rtrn.rt_fluxes_maxrand)(*rt_args, rows, taucb_t)
        uflx, dflx, uflxc, dflxc = (f.t() for f in fl)
        return Fluxes(uflx, dflx, rtrn.heating(uflx - dflx, prof.pz,
                                               self.heatfac),
                      uflxc, dflxc, rtrn.heating(uflxc - dflxc, prof.pz,
                                                 self.heatfac),
                      cld_bounds_ok=bounds_ok)


def make_model(config: LWConfig = LWConfig(), device=None,
               tables: Optional[Tables] = None) -> RRTMGLW:
    """The model on ``device`` (the CUDA device when None; raises where
    there is none).  ``tables``: a ``data.ktables.Tables`` (e.g. from
    ``tables_from_numpy(jax_model.ktables, jax_model.static_np)``) in
    place of loading the assets."""
    return RRTMGLW(config, device=device, tables=tables)
