"""The main-path model: batched longwave radiative transfer.

PyTorch port of ``rrtmg_lw_tpu.models.radiation.RRTMGLW`` for the
forward clear-sky, McICA-cloudy and deterministic-cloud step (the JAX
model's blocked branch, models/radiation.py:161-183, 246-358, 385-401).
One step runs

  inatm -> setcoef -> taumol (K2) -> taut = taug + taua[..., ngb]
  -> Planck at layer and level temperatures (K3)
  -> cloud optics: ice/liquid coefficients (K4; McICA with inflag=2,
     and per-band clouds with inflag=2), or cldprmc (McICA inflag=0)
  -> RT sweep (K1: clear; McICA compact (generator-form int8 mask),
     fused (per-g arrays, cldprmc inside the kernel) or cldf-odcld
     (per-g cloud fraction and cloud od); banded icld=1, or maxrand
     icld 2/3 after the overlap rows of the cloud fraction)
  -> heating rates from the fluxes.

With idrv=1 the sweep also gives the upward fluxes' derivatives with
respect to the surface temperature (``Fluxes.duflx_dt``,
``duflxc_dt``), and a ``Profile.dtbound`` moves the upward fluxes and
heating rates by that derivative times dtbound (the column-mode
adjustment, rrtmg_lw.1col.f90:587-610).

With ``impl="cuda"`` the stages marked K (and the overlap rows) run the
hand-written CUDA kernels, each inside a ``torch.autograd.Function``
whose backward is a kernel too (K5 taumol, K3b Planck, K4b the effective
radii, K6 RT in every sweep mode, with a cotangent of the d/dT outputs
its instantiation that also runs their adjoint, and for maxrand the
overlap rows' adjoint); with
``impl="eager"`` their plain PyTorch versions, on the same layouts, under
plain autograd.  Configurations outside the port raise
``NotImplementedError`` naming the ROADMAP item that ports them.

Reduced spectral storage: ``RRTMG_SPEC_DTYPE`` (read once, at
construction, as the JAX package's ``PallasTaumol`` reads it; values
``''``/``f32``/``bf16``/``f16``/``logu16``, ``spec_codec``) sets
``model.spec_dtype``.  In float32, on both impls, taumol then stores
taug and fracs in that dtype (K2 encodes at its store), the aerosol od
stays apart at band resolution, and the sweep decodes them and adds it
(K1 inside the kernel, the eager twin by ``spec_codec.spec_inputs``).
A backward through such a step raises NotImplementedError.  A float64
model ignores the variable, as the JAX package's XLA engine does.

The model runs on the CUDA device unless ``device`` names another.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import LWConfig, resolve_device
from ..constants import heatfac
from ..data.ktables import STATIC_TENSORS, Tables, load_tables
from ..ops import cldprop, rtrn, rtrnmr, spec_codec
from ..ops.cldcoef_cuda import ice_liq_coeffs_blocked
from ..ops.inatm import inatm
from ..ops.planck_cuda import planck_interp_blocked
from ..ops.rtrn_cuda import WRAPPERS, KeptCount
from ..ops.rtrnmr_cuda import overlap_rows
from ..ops.setcoef import interp_planck_blocked, setcoef
from ..ops.taumol import TaumolEngine
from ..ops.taumol_cuda import taumol_blocked
from ..types import (Atmosphere, BandClouds, Fluxes, McicaClouds,
                     McicaCloudsBlocked, McicaCloudsCompact, Profile, pad_g)

MCICA = (McicaCloudsCompact, McicaCloudsBlocked, McicaClouds)
# the ROADMAP.md items that port what is still missing, by title
CLOUD_OPTICS = "Queue 1, the remaining cloud-optics configurations"
LUT_BANDS = "Queue 1, use_lut=True, the default config, and band subsets"


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
                            CLOUD_OPTICS)
        if not cldprop.cloud_bands_static(cfg.inflag, cfg.iceflag,
                                          cfg.liqflag):
            raise _unported(
                f"per-band clouds with inflag={cfg.inflag}, iceflag="
                f"{cfg.iceflag}, liqflag={cfg.liqflag} (cldprop_ncbands)",
                CLOUD_OPTICS)
    if cfg.idrv not in (0, 1):
        raise ValueError(f"idrv must be 0 or 1, got {cfg.idrv}")
    if cfg.use_lut:
        raise _unported("use_lut=True (exp/tfn lookup tables)",
                        LUT_BANDS)
    if (cfg.istart, cfg.iend) != (1, 16):
        raise _unported("a band subset (istart/iend)", LUT_BANDS)
    if cfg.icld != 0 and cfg.imca == 1 and cfg.inflag not in (0, 2):
        # as the JAX package's cldprmc (rrtmg_lw_cldprmc.f90:191)
        raise ValueError(f"INFLAG={cfg.inflag} not available with McICA "
                         "(inflag 0 or 2)")


def cloud_kind(cfg: LWConfig, clouds) -> str:
    """The sweep a step of ``cfg`` takes with ``clouds``: "clear",
    "mcica" (imca=1), "banded" (icld=1) or "maxrand" (icld 2 or 3);
    raises TypeError where the clouds' type does not fit it."""
    if cfg.icld == 0 or clouds is None:
        return "clear"
    if cfg.imca == 1:
        if not isinstance(clouds, MCICA):
            raise TypeError(f"McICA (imca=1) takes McicaCloudsCompact, "
                            f"McicaCloudsBlocked or McicaClouds, got "
                            f"{type(clouds).__name__}")
        return "mcica"
    if not isinstance(clouds, BandClouds):
        raise TypeError(f"imca=0 takes BandClouds, got "
                        f"{type(clouds).__name__}")
    return "banded" if cfg.icld == 1 else "maxrand"


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
        self.spec_dtype = spec_codec.spec_dtype_from_env()
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

    @property
    def reduced_storage(self) -> bool:
        """True where taug / fracs are stored in 16 bits: a float32
        model with a reduced ``spec_dtype``."""
        return (self.config.torch_dtype == torch.float32
                and self.spec_dtype != torch.float32)

    def static_tensors(self) -> dict:
        """The static-table buffers by name (setcoef, cloud optics)."""
        return {k: getattr(self, k) for k in STATIC_TENSORS}

    def forward(self, atm: Atmosphere, clouds=None) -> Fluxes:
        """``clouds``: None (clear sky), ``McicaCloudsCompact``,
        ``McicaCloudsBlocked`` or ``McicaClouds`` (imca=1), or
        ``BandClouds`` (imca=0)."""
        return self.from_profile(inatm(atm, dtype=self.config.torch_dtype),
                                 clouds)

    def from_profile(self, prof: Profile, clouds=None) -> Fluxes:
        """The step from an already-processed Profile (after inatm)."""
        cfg = self.config
        cuda = self.impl == "cuda"
        static = self.static_tensors()
        sc = setcoef(prof, static, planck=False)
        reduced = self.reduced_storage
        sdt = self.spec_dtype if reduced else torch.float32
        kind = cloud_kind(cfg, clouds)
        # maximum-random overlap in a step that records a gradient on the
        # card: the overlap rows first, and with them the count of the
        # state's slots the sweep reads on the host where it allocates the
        # state it keeps, which has long reached the host by then
        rows = kept = None
        if (cuda and kind == "maxrand" and torch.is_grad_enabled()
                and any(isinstance(t, torch.Tensor) and t.requires_grad
                        for t in (*prof, *clouds))):
            rows = overlap_rows(
                clouds.cldfrac.to(cfg.torch_dtype).contiguous())
            kept = KeptCount(rows)

        if cuda:
            taug_t, fracs_t = taumol_blocked(sc, prof, self.engine,
                                             self.kernel_tabs,
                                             self.kernel_desc,
                                             spec_dtype=sdt)
        else:
            taug_t, fracs_t = self.engine.blocked(sc, prof)
            if reduced:
                taug_t = spec_codec.spec_store(taug_t, sdt, "tg")
                fracs_t = spec_codec.spec_store(fracs_t, sdt, "fr")
        taua_t = prof.taua.permute(1, 2, 0).contiguous()
        if reduced:
            # taug / fracs stay in storage; the sweep decodes them and
            # adds the aerosol od (L, 16, B) of each g's band
            taut_t = taug_t
            sweep_kw = dict(taua_t=taua_t)
        else:
            # (L, 140, B) += aerosol optical depth of each g-point's band.
            # The band -> g gather runs on a contiguous (L, 16, B) copy:
            # gathering from the permuted view leaves a strided operand
            # that made this add alone ~4.8 ms of a 13.8 ms step on the
            # H100.
            taut_t = taug_t.add_(taua_t.index_select(1, self.ngb0.long()))
            sweep_kw = {}

        planck = planck_interp_blocked if cuda else interp_planck_blocked
        planklay_t = planck(prof.tavel.t().contiguous(), self.totplnk)
        planklev_t = planck(prof.tz.t().contiguous(), self.totplnk)

        rt_args = (taut_t, fracs_t, planklay_t, planklev_t, sc.plankbnd,
                   prof.semiss, prof.pwvcm, self.ngb0, self.wg)
        sweep_kw["dplankbnd_dt"] = sc.dplankbnd_dt if cfg.idrv else None
        sweeps = WRAPPERS if cuda else rtrn.FLUXES
        coeffs = (ice_liq_coeffs_blocked if cuda
                  else cldprop.ice_liq_coeffs_blocked)
        bounds_ok = None
        if kind == "clear":
            fl = sweeps["blocked"](*rt_args, **sweep_kw)
        elif kind == "mcica":
            fl, bounds_ok = self._mcica(clouds, rt_args, sweeps, coeffs,
                                        sweep_kw)
        else:
            # per-band cloud od stays at band resolution into the kernel,
            # which expands it to g by ngb
            taucb_t, bounds_ok = cldprop.cldprop_banded_blocked(
                clouds, static, inflag=cfg.inflag,
                iceflag=cfg.iceflag, liqflag=cfg.liqflag, coeffs=coeffs)
            cldfrac = clouds.cldfrac.to(cfg.torch_dtype)
            if kind == "banded":
                fl = sweeps["banded"](*rt_args, cldfrac.t().contiguous(),
                                      taucb_t, **sweep_kw)
            elif kept is not None:
                fl = sweeps["maxrand"](*rt_args, rows, taucb_t, kept=kept,
                                       **sweep_kw)
            else:
                rows = (overlap_rows if cuda
                        else rtrnmr.overlap_rows)(cldfrac.contiguous())
                fl = sweeps["maxrand"](*rt_args, rows, taucb_t, **sweep_kw)
        if reduced:
            # no cotangent through the stored taug / fracs (nor through
            # taumol's inputs, which the codes cut from the graph)
            anchors = [t for t in (*sc, prof.coldry, prof.pavel, prof.wx)
                       if isinstance(t, torch.Tensor)
                       and t.is_floating_point()]
            fl = (tuple(spec_codec.forbid_grad(x, anchors) for x in fl)
                  if isinstance(fl, tuple)
                  else spec_codec.forbid_grad(fl, anchors))
        duflx_dt = duflxc_dt = None
        if cfg.idrv:
            fl, ddt = fl
            duflx_dt, duflxc_dt = ddt[0].t(), ddt[1].t()
        uflx, dflx, uflxc, dflxc = (f.t() for f in fl)
        if duflx_dt is not None and prof.dtbound is not None:
            # column-mode dtbound flux adjustment (rrtmg_lw.1col.f90:
            # 587-610; the JAX model's radiation.py:388-399)
            dtb = prof.dtbound.to(uflx.dtype)[:, None]
            uflx = uflx + duflx_dt * dtb
            uflxc = uflxc + duflxc_dt * dtb
        return Fluxes(uflx, dflx, rtrn.heating(uflx - dflx, prof.pz,
                                               self.heatfac),
                      uflxc, dflxc, rtrn.heating(uflxc - dflxc, prof.pz,
                                                 self.heatfac),
                      duflx_dt, duflxc_dt, bounds_ok)

    def _mcica(self, clouds, rt_args, sweeps, coeffs, sweep_kw):
        """The McICA sweep, dispatched as the JAX blocked branch
        (radiation.py:246-296): compact int8-mask clouds with inflag=2
        stream into K1's compact mode; per-g arrays with inflag=2 into
        its fused mode (a float-mask compact form too: its per-g products
        are exact for any mask value); with inflag=0 cldprmc_blocked
        forms the per-g cloud od for its cldf-odcld mode.  -> (the
        sweep's output, bounds_ok)."""
        cfg = self.config
        static = self.static_tensors()
        if isinstance(clouds, McicaCloudsCompact) and (
                cfg.inflag != 2 or clouds.cldfmc.dtype != torch.int8):
            clouds = clouds.to_blocked()
        if isinstance(clouds, McicaClouds) and cfg.inflag == 2:
            clouds = clouds.to_blocked()
        if cfg.inflag == 0:
            odcld_t, cldf_t, ok = cldprop.cldprmc_blocked(
                clouds, static, inflag=0, iceflag=cfg.iceflag,
                liqflag=cfg.liqflag, coeffs=coeffs)
            return sweeps["cldf_od"](*rt_args, (cldf_t, odcld_t),
                                     **sweep_kw), ok
        abi_t, abl_t, ok = cldprop.cloud_optics_bands_blocked(
            clouds, static, iceflag=cfg.iceflag, liqflag=cfg.liqflag,
            coeffs=coeffs)
        if isinstance(clouds, McicaCloudsCompact):
            cw_t = torch.stack([clouds.ciwp.t(), clouds.clwp.t()],
                               dim=1).to(cfg.torch_dtype).contiguous()
            return sweeps["blocked"](*rt_args, (clouds.cldfmc, cw_t, abi_t,
                                                abl_t), **sweep_kw), ok
        return sweeps["fused"](*rt_args, (*(pad_g(x) for x in clouds[:4]),
                                          abi_t, abl_t), **sweep_kw), ok


def make_model(config: LWConfig = LWConfig(), device=None,
               tables: Optional[Tables] = None) -> RRTMGLW:
    """The model on ``device`` (the CUDA device when None; raises where
    there is none).  ``tables``: a ``data.ktables.Tables`` (e.g. from
    ``tables_from_numpy(jax_model.ktables, jax_model.static_np)``) in
    place of loading the assets."""
    return RRTMGLW(config, device=device, tables=tables)
