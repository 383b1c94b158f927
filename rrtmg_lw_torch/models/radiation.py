"""The main-path model: batched longwave radiative transfer.

PyTorch port of ``rrtmg_lw_tpu.models.radiation.RRTMGLW``: every
``LWConfig`` the JAX model runs, clear sky, McICA-cloudy and
deterministic-cloud (the JAX model's blocked and XLA branches,
models/radiation.py:104-401).  One step runs

  inatm -> setcoef -> taumol (K2) -> taut = taug + taua[..., ngb]
  -> Planck at layer and level temperatures (K3; band 16 from totplk16
     at istart=16)
  -> cloud optics: ice/liquid coefficients (K4 for the tabulated flags;
     McICA with inflag=2, and per-band clouds with inflag=2), or cldprmc
     (McICA inflag=0); per-band clouds with the running ncbands
     (inflag=2 with iceflag 0/1 or liqflag 0) through cldprop_ncbands and
     expand_cloud_bands
  -> RT sweep (K1: clear; McICA compact (generator-form int8 mask),
     fused (per-g arrays, cldprmc inside the kernel) or cldf-odcld
     (per-g cloud fraction and cloud od); banded icld=1, or maxrand
     icld 2-5 after the overlap rows of the cloud fraction)
  -> heating rates from the fluxes.

The routing rule, as the JAX package's (its ``rt_pallas`` / ``blocked``
condition, models/radiation.py:56-69, 145-148):

  * the hand-written RT kernels (K1, and the overlap rows and K1 SAVE /
    K6 of its gradient) run only for ``use_lut=False``, float32 and all
    16 bands (``rt_kernels``);
  * ``use_lut=True`` or a band subset (istart/iend) takes the plain
    sweep (``rtrn.FLUXES``) on the model's device, whatever the impl:
    the lookup tables (``ops.tables``, buffers ``tau_tbl``, ``exp_tbl``,
    ``tfn_tbl`` in the model's dtype) and the selected g-points
    (``gsel``) are its own;
  * taumol (K2), Planck (K3) and the tabulated cloud coefficients (K4)
    run their kernels wherever ``impl`` resolves to "cuda";
  * the closed-form ice and liquid optics (iceflag 0/1, liqflag 0) are
    plain PyTorch on both impls, as the JAX package runs them on XLA.

This follows from the config: nothing catches a kernel's failure and
carries on.  The running-ncbands cloud od goes to the LUT sweep exactly
weighted (``expand_cloud_bands(..., weighted=True)``: a ratio prefold
moves the LUT quantizer by an ulp) and to K1 and the closed-form sweeps
as the ratio prefold, which they weight by the spectral band's secant.

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
plain autograd; the plain sweep of a LUT or band-subset step is plain
autograd on both.

Reduced spectral storage: ``RRTMG_SPEC_DTYPE`` (read once, at
construction, as the JAX package's ``PallasTaumol`` reads it; values
``''``/``f32``/``bf16``/``f16``/``logu16``, ``spec_codec``) sets
``model.spec_dtype``.  In float32, on both impls, taumol then stores
taug and fracs in that dtype (K2 encodes at its store), the aerosol od
stays apart at band resolution, and the sweep decodes them and adds it
(K1 inside the kernel, the plain sweeps by ``spec_codec.spec_inputs``).
A backward through such a step raises NotImplementedError.  A float64
model ignores the variable, as the JAX package's XLA engine does.

The model runs on the CUDA device unless ``device`` names another.
"""

from __future__ import annotations

import functools
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
from ..ops.setcoef import band16_sources, interp_planck_blocked, setcoef
from ..ops.tables import LUT_NAMES, build_lookup_tables
from ..ops.taumol import TaumolEngine
from ..ops.taumol_cuda import taumol_blocked
from ..types import (NGPT, Atmosphere, BandClouds, Fluxes, McicaClouds,
                     McicaCloudsBlocked, McicaCloudsCompact, Profile, pad_g)

MCICA = (McicaCloudsCompact, McicaCloudsBlocked, McicaClouds)


def check_supported(cfg: LWConfig) -> None:
    """Raise ValueError for configurations the JAX model cannot run
    either."""
    if cfg.icld not in range(6):
        raise ValueError(f"icld must be 0..5, got {cfg.icld}")
    if cfg.idrv not in (0, 1):
        raise ValueError(f"idrv must be 0 or 1, got {cfg.idrv}")
    if not 1 <= cfg.istart <= cfg.iend <= 16:
        raise ValueError(f"bands istart={cfg.istart}..iend={cfg.iend} "
                         "outside 1..16")
    if cfg.icld != 0 and cfg.imca == 1 and cfg.inflag not in (0, 2):
        # as the JAX package's cldprmc (rrtmg_lw_cldprmc.f90:191)
        raise ValueError(f"INFLAG={cfg.inflag} not available with McICA "
                         "(inflag 0 or 2)")


def cloud_kind(cfg: LWConfig, clouds) -> str:
    """The sweep a step of ``cfg`` takes with ``clouds``: "clear",
    "mcica" (imca=1), "banded" (icld=1) or "maxrand" (icld 2-5, the JAX
    model's ``uses_rtmr``);
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
        self.register_buffer("gsel", torch.as_tensor(rtrn.g_select(
            tables.static, config.istart, config.iend), device=device))
        luts = build_lookup_tables()
        for name in LUT_NAMES:
            self.register_buffer(name, torch.as_tensor(
                getattr(luts, name)).to(device, dtype))
        self.heatfac = heatfac(config.cpdair)

    @property
    def subset(self) -> bool:
        """True where the config selects fewer than the 16 bands."""
        return len(self.gsel) != NGPT

    @property
    def rt_kernels(self) -> bool:
        """True where the RT sweep runs the kernels: impl "cuda" (hence
        float32), ``use_lut=False`` and all 16 bands."""
        return (self.impl == "cuda" and not self.config.use_lut
                and not self.subset)

    @property
    def luts(self) -> Optional[dict]:
        """The lookup tables by name where ``use_lut``, else None."""
        if not self.config.use_lut:
            return None
        return {k: getattr(self, k) for k in LUT_NAMES}

    def _g(self, x):
        """Per-g rows (L, G, B) of the selected g-points."""
        return x.index_select(1, self.gsel) if self.subset else x

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
        rt_kernels = self.rt_kernels
        static = self.static_tensors()
        sc = setcoef(prof, static, istart=cfg.istart, planck=False)
        reduced = self.reduced_storage
        sdt = self.spec_dtype if reduced else torch.float32
        kind = cloud_kind(cfg, clouds)
        # maximum-random overlap in a step that records a gradient on the
        # card: the overlap rows first, and with them the count of the
        # state's slots the sweep reads on the host where it allocates the
        # state it keeps, which has long reached the host by then
        rows = kept = None
        if (rt_kernels and kind == "maxrand" and torch.is_grad_enabled()
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
        if cfg.istart == 16:
            # band-16-only mode: band 16 from totplk16 (setcoef.f90:233-251)
            p16lay, p16lev = band16_sources(prof.tavel, prof.tz, static)
            planklay_t = torch.cat([planklay_t[:, :15], p16lay.t()[:, None]],
                                   dim=1)
            planklev_t = torch.cat([planklev_t[:, :15], p16lev.t()[:, None]],
                                   dim=1)

        ngb0, wg = self.ngb0, self.wg
        if self.subset:
            # the selected g-points' rows (the JAX model's taut[..., gsel])
            taut_t, fracs_t = self._g(taut_t), self._g(fracs_t)
            ngb0, wg = ngb0[self.gsel], wg[self.gsel]
        rt_args = (taut_t, fracs_t, planklay_t, planklev_t, sc.plankbnd,
                   prof.semiss, prof.pwvcm, ngb0, wg)
        sweep_kw["dplankbnd_dt"] = sc.dplankbnd_dt if cfg.idrv else None
        sweeps = (WRAPPERS if rt_kernels else
                  {k: functools.partial(f, luts=self.luts)
                   for k, f in rtrn.FLUXES.items()})
        coeffs = (ice_liq_coeffs_blocked if cuda
                  else cldprop.ice_liq_coeffs_blocked)
        bounds_ok = None
        if kind == "clear":
            fl = sweeps["blocked"](*rt_args, **sweep_kw)
        elif kind == "mcica":
            fl, bounds_ok = self._mcica(clouds, rt_args, sweeps, coeffs,
                                        sweep_kw)
        else:
            # per-band cloud od stays at band resolution into the sweep,
            # which expands it to g by ngb
            taucb_t, bounds_ok, band_kw = self._band_od(clouds, prof, coeffs)
            cldfrac = clouds.cldfrac.to(cfg.torch_dtype)
            if kind == "banded":
                fl = sweeps["banded"](*rt_args, cldfrac.t().contiguous(),
                                      taucb_t, **band_kw, **sweep_kw)
            elif kept is not None:
                fl = sweeps["maxrand"](*rt_args, rows, taucb_t, kept=kept,
                                       **sweep_kw)
            else:
                rows = (overlap_rows if rt_kernels
                        else rtrnmr.overlap_rows)(cldfrac.contiguous())
                fl = sweeps["maxrand"](*rt_args, rows, taucb_t, **band_kw,
                                       **sweep_kw)
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

    def _band_od(self, clouds, prof, coeffs):
        """The per-band cloud od of ``BandClouds`` (L, 16, B), bounds_ok
        and the sweep's keywords: ``cldprop_banded_blocked`` where the
        cloud bands are static, else the running ncbands
        (``cldprop_ncbands``) mapped to the spectral bands, weighted for
        the LUT sweep (``weighted=True``) and as the ratio prefold for
        the others (the JAX model's models/radiation.py:297-318)."""
        cfg = self.config
        flags = dict(inflag=cfg.inflag, iceflag=cfg.iceflag,
                     liqflag=cfg.liqflag)
        if cldprop.cloud_bands_static(**flags):
            taucb_t, ok = cldprop.cldprop_banded_blocked(
                clouds, self.static_tensors(), coeffs=coeffs, **flags)
            return taucb_t, ok, {}
        tau_cb, ncb, ok = cldprop.cldprop_ncbands(
            clouds, self.static_tensors(), **flags)
        weighted = cfg.use_lut
        od = cldprop.expand_cloud_bands(
            tau_cb, ncb, rtrn.secdiff(prof.pwvcm, cfg.torch_dtype),
            weighted=weighted)
        return (od.permute(1, 2, 0).contiguous(), ok,
                dict(weighted=True) if weighted else {})

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
            return sweeps["cldf_od"](*rt_args, (self._g(cldf_t),
                                                self._g(odcld_t)),
                                     **sweep_kw), ok
        abi_t, abl_t, ok = cldprop.cloud_optics_bands_blocked(
            clouds, static, iceflag=cfg.iceflag, liqflag=cfg.liqflag,
            coeffs=coeffs)
        if isinstance(clouds, McicaCloudsCompact):
            cw_t = torch.stack([clouds.ciwp.t(), clouds.clwp.t()],
                               dim=1).to(cfg.torch_dtype).contiguous()
            return sweeps["blocked"](*rt_args, (self._g(clouds.cldfmc), cw_t,
                                                abi_t, abl_t), **sweep_kw), ok
        return sweeps["fused"](*rt_args, (*(self._g(pad_g(x))
                                            for x in clouds[:4]),
                                          abi_t, abl_t), **sweep_kw), ok


def make_model(config: LWConfig = LWConfig(), device=None,
               tables: Optional[Tables] = None) -> RRTMGLW:
    """The model on ``device`` (the CUDA device when None; raises where
    there is none).  ``tables``: a ``data.ktables.Tables`` (e.g. from
    ``tables_from_numpy(jax_model.ktables, jax_model.static_np)``) in
    place of loading the assets."""
    return RRTMGLW(config, device=device, tables=tables)
