"""NamedTuples of tensors for the PyTorch port.

Same fields and layouts as ``rrtmg_lw_tpu.types`` so the two packages
can be compared array by array:
  * leading axis = columns, then layers (bottom -> top), g-points or
    bands last: (B, L), (B, L+1), (B, L, G);
  * the McICA per-g arrays of ``McicaCloudsBlocked`` and the compact
    mask keep the generator's g-major (L, 144, B) layout (the
    reference's cldfmcl(ngptlw, ncol, nlay)), g zero-padded 140 -> 144;
    ``McicaClouds`` holds them (B, L, 140).

``from_numpy`` converts host numpy arrays (e.g. from
``rrtmg_lw_torch.utils.synthetic``) to tensors on ``device`` (the CUDA
device when None; ``config.resolve_device``): floating arrays take
``dtype``, integer and boolean arrays keep their own type.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import resolve_device

NBANDS = 16
NGPT = 140
NGPT_PAD = 144
NMOL = 7


def _tensor(x, device, dtype):
    if x is None:
        return None
    t = torch.as_tensor(x)
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _from_numpy(cls, src, device=None, dtype=torch.float64):
    """Build ``cls`` from a NamedTuple or mapping of arrays."""
    device = resolve_device(device)
    fields = src._asdict() if hasattr(src, "_asdict") else dict(src)
    return cls(**{k: _tensor(v, device, dtype) for k, v in fields.items()
                  if k in cls._fields})


class Atmosphere(NamedTuple):
    """GCM-style input state (vmr; hPa; K) — rrtmg_lw_rad.f90:99-125."""
    play: torch.Tensor         # (B, L)
    plev: torch.Tensor         # (B, L+1)  bottom -> top
    tlay: torch.Tensor         # (B, L)
    tlev: torch.Tensor         # (B, L+1)
    tsfc: torch.Tensor         # (B,)
    h2ovmr: torch.Tensor       # (B, L)
    co2vmr: torch.Tensor
    o3vmr: torch.Tensor
    n2ovmr: torch.Tensor
    covmr: torch.Tensor
    ch4vmr: torch.Tensor
    o2vmr: torch.Tensor
    cfc11vmr: torch.Tensor
    cfc12vmr: torch.Tensor
    cfc22vmr: torch.Tensor
    ccl4vmr: torch.Tensor
    emis: torch.Tensor         # (B, NBANDS)
    tauaer: torch.Tensor       # (B, L, NBANDS)

    from_numpy = classmethod(_from_numpy)


class Profile(NamedTuple):
    """Processed per-column profile (output of inatm; molec/cm2)."""
    pavel: torch.Tensor        # (B, L) layer pressure (mb)
    tavel: torch.Tensor        # (B, L)
    pz: torch.Tensor           # (B, L+1) level pressure, pz[:, 0] = surface
    tz: torch.Tensor           # (B, L+1)
    tbound: torch.Tensor       # (B,)
    semiss: torch.Tensor       # (B, NBANDS)
    coldry: torch.Tensor       # (B, L)
    wkl: torch.Tensor          # (B, L, NMOL)
    wbrodl: torch.Tensor       # (B, L)
    wx: torch.Tensor           # (B, L, 4) cross-section amounts * 1e-20
    pwvcm: torch.Tensor        # (B,)
    taua: torch.Tensor         # (B, L, NBANDS)
    dtbound: Optional[torch.Tensor] = None  # (B,) surface dT, idrv adjust

    from_numpy = classmethod(_from_numpy)


def pad_g(x):
    """(L, G, B) per-g array -> contiguous (L, NGPT_PAD, B), zero rows
    appended where G < NGPT_PAD."""
    if x.shape[1] != NGPT_PAD:
        x = torch.nn.functional.pad(x, (0, 0, 0, NGPT_PAD - x.shape[1]))
    return x.contiguous()


def _to_blocked(x):
    """(B, L, G) -> (L, NGPT_PAD, B), g zero-padded."""
    return pad_g(x.permute(1, 2, 0))


class McicaClouds(NamedTuple):
    """Per-g-point stochastic cloud state (McICA), batch layout."""
    cldfmc: torch.Tensor       # (B, L, NGPT) 0/1 cloud fraction
    ciwpmc: torch.Tensor       # (B, L, NGPT) in-cloud ice water path
    clwpmc: torch.Tensor       # (B, L, NGPT)
    taucmc: torch.Tensor       # (B, L, NGPT) in-cloud optical depth
    reicmc: torch.Tensor       # (B, L)
    relqmc: torch.Tensor       # (B, L)

    from_numpy = classmethod(_from_numpy)

    def to_blocked(self) -> "McicaCloudsBlocked":
        """The per-g arrays relaid once to (L, NGPT_PAD, B), as
        ``cldprop.cldprmc_blocked`` relays batch input."""
        return McicaCloudsBlocked(*(_to_blocked(x) for x in self[:4]),
                                  self.reicmc, self.relqmc)


class McicaCloudsBlocked(NamedTuple):
    """McicaClouds with the per-g arrays in the RT kernel's padded
    (L, NGPT_PAD, B) layout (pad rows zero), as a host pipeline that
    stores sub-columns g-major like the reference's
    cldfmcl(ngptlw, ncol, nlay) (rrtmg_lw_rad.f90:117) produces them."""
    cldfmc: torch.Tensor       # (L, NGPT_PAD, B) 0/1 cloud fraction
    ciwpmc: torch.Tensor       # (L, NGPT_PAD, B) in-cloud ice water path
    clwpmc: torch.Tensor       # (L, NGPT_PAD, B)
    taucmc: torch.Tensor       # (L, NGPT_PAD, B) in-cloud optical depth
    reicmc: torch.Tensor       # (B, L)
    relqmc: torch.Tensor       # (B, L)

    from_numpy = classmethod(_from_numpy)

    def to_batch(self) -> McicaClouds:
        """Relayout back to (B, L, NGPT)."""
        return McicaClouds(*(x[:, :NGPT, :].permute(2, 0, 1)
                             for x in self[:4]), self.reicmc, self.relqmc)


class McicaCloudsCompact(NamedTuple):
    """Generator-form McICA clouds: binary sub-column mask at g
    resolution plus per-layer water paths (mcica_subcol_gen_lw.f90:
    655-668 forms ciwpmc/clwpmc as per-layer value x mask).  Valid for
    the inflag=2 parameterized optics, where per-g taucmc is zero."""
    cldfmc: torch.Tensor       # (L, NGPT_PAD, B) 0/1 mask (int8 or float)
    ciwp: torch.Tensor         # (B, L) in-cloud ice water path
    clwp: torch.Tensor         # (B, L) in-cloud liquid water path
    reicmc: torch.Tensor       # (B, L)
    relqmc: torch.Tensor       # (B, L)

    from_numpy = classmethod(_from_numpy)

    def to_blocked(self) -> McicaCloudsBlocked:
        """Materialize the per-g products (mask x per-layer path, taucmc
        zero) in the working dtype of the water paths."""
        m = self.cldfmc.to(self.ciwp.dtype)
        ci = self.ciwp.t()[:, None, :] * m
        cl = self.clwp.t()[:, None, :] * m
        return McicaCloudsBlocked(m, ci, cl, torch.zeros_like(m),
                                  self.reicmc, self.relqmc)


class BandClouds(NamedTuple):
    """Per-band deterministic cloud state (non-McICA, imca=0)."""
    cldfrac: torch.Tensor      # (B, L)
    tauc: torch.Tensor         # (B, L, NBANDS) input cloud od (inflag 0)
    ciwp: torch.Tensor         # (B, L)
    clwp: torch.Tensor         # (B, L)
    reic: torch.Tensor         # (B, L)
    relq: torch.Tensor         # (B, L)

    from_numpy = classmethod(_from_numpy)


class SetcoefOut(NamedTuple):
    """Interpolation indices/fractions + Planck sources
    (setcoef.f90:50-434).  Index arrays are 0-based int32."""
    laytrop_mask: torch.Tensor  # (B, L) True below the ~100 mb switch
    jp: torch.Tensor            # (B, L) 0..57
    jt: torch.Tensor            # (B, L) 0..3
    jt1: torch.Tensor
    planklay: Optional[torch.Tensor]  # (B, L, NBANDS); None if not asked
    planklev: Optional[torch.Tensor]  # (B, L+1, NBANDS)
    plankbnd: torch.Tensor      # (B, NBANDS)
    dplankbnd_dt: torch.Tensor  # (B, NBANDS)
    colh2o: torch.Tensor        # (B, L) (1e20 molec/cm2)
    colco2: torch.Tensor
    colo3: torch.Tensor
    coln2o: torch.Tensor
    colco: torch.Tensor
    colch4: torch.Tensor
    colo2: torch.Tensor
    colbrd: torch.Tensor
    fac00: torch.Tensor
    fac01: torch.Tensor
    fac10: torch.Tensor
    fac11: torch.Tensor
    rat_h2oco2: torch.Tensor
    rat_h2oco2_1: torch.Tensor
    rat_h2oo3: torch.Tensor
    rat_h2oo3_1: torch.Tensor
    rat_h2on2o: torch.Tensor
    rat_h2on2o_1: torch.Tensor
    rat_h2och4: torch.Tensor
    rat_h2och4_1: torch.Tensor
    rat_n2oco2: torch.Tensor
    rat_n2oco2_1: torch.Tensor
    rat_o3co2: torch.Tensor
    rat_o3co2_1: torch.Tensor
    selffac: torch.Tensor
    selffrac: torch.Tensor
    indself: torch.Tensor
    forfac: torch.Tensor
    forfrac: torch.Tensor
    indfor: torch.Tensor
    minorfrac: torch.Tensor
    scaleminor: torch.Tensor
    scaleminorn2: torch.Tensor
    indminor: torch.Tensor


class Fluxes(NamedTuple):
    """Outputs (W/m2, K/day); level axis bottom -> top, size L+1."""
    uflx: torch.Tensor         # (B, L+1) total-sky upward flux
    dflx: torch.Tensor
    hr: torch.Tensor           # (B, L)
    uflxc: torch.Tensor        # (B, L+1) clear-sky
    dflxc: torch.Tensor
    hrc: torch.Tensor
    duflx_dt: Optional[torch.Tensor] = None   # (B, L+1), idrv=1
    duflxc_dt: Optional[torch.Tensor] = None  # (B, L+1), idrv=1
    # per-(column, layer) False where cloud particle sizes were outside
    # the parameterization range and were clamped (the reference stops
    # instead, rrtmg_lw_cldprmc.f90:204-253); None for clear sky
    cld_bounds_ok: Optional[torch.Tensor] = None
    # per-column (B,) bool: False where the streaming wire decode
    # (parallel/wire.py, sanitize=True) replaced corrupted inputs with
    # finite fallbacks; the ingest step threads the decoder's ok here
    wire_ok: Optional[torch.Tensor] = None
