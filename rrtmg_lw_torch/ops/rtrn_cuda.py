"""Radiative-transfer sweep kernel (K1), csrc/rtrn.cu, and its adjoint
(K6), csrc/rtrn_bwd.cu.

K1 replaces ``rrtmg_lw_tpu/ops/rtrn_pallas.py::_build_kernel.kernel``
in all its modes: clear, compact-cloud, banded (icld=1), maxrand (icld
2/3), fused (McICA per-g arrays, cldprmc inline) and cldf-odcld (McICA
per-g cloud fraction and cloud od), each at idrv=0 or 1; K6 replaces
the JAX package's unrolled XLA backward of it (``ops/rtrn_bwd.py:259``
``rt_bwd_fluxes``) in the clear and compact modes, and its XLA vjp of
the sweep (``rtrn_pallas.py:1208`` maxrand, ``:1040`` the random-overlap
modes) in the maxrand mode (csrc/rtrn_bwd_mr.cu) and in the banded,
fused and cldf-odcld modes (csrc/rtrn_bwd_g.cu).  ``RTFn`` pairs them
for autograd: in a forward that autograd records, K1 (float32) also
keeps its per-g radiances (``rt_sweep_radiances``), and K6 reads them
back in the backward instead of sweeping forward again.  ``RTSweepFn``
holds the other four modes and does the same (maxrand:
``rt_sweep_maxrand_radiances``, the sub-streams kept too, packed, and
``rt_sweep_maxrand_vjp``; banded, fused, cldf-odcld:
``rt_sweep_g_radiances``, in fused and cldf-odcld with the cloudy-layer
words K6 reads there, ``rt_sweep_banded_vjp`` and
``rt_sweep_g_vjp``); compact at idrv=1 also keeps the cloudy-layer
words its d/dT adjoint reads, which runs on K6-g's tile
(csrc/rtrn_bwd_g.cu).  K1's gradient-step launch writes the radiances
by bulk tensor stores where B is a multiple of 4 (its rows 16-byte
aligned), by scalar stores otherwise (``k1_save_path``).  With idrv=1 (a
fourth surface row, ``dplankbnd_dt``) each returns the fluxes and their
derivatives with respect to the surface temperature (2, L+1, B); a
cotangent of the latter reaches K6's instantiation in the mode that also
runs the d/dT sweep's adjoint (``ct_ddt`` of each vjp wrapper;
``rtrn.ddt_adjoint`` is its plain twin), counted in ``DDT_LAUNCHES``; in
every mode but clear (``KEEPS_DDT``) K1's gradient-step launch at idrv=1
also keeps the d/dT derivatives entering each layer (rads (6, L, 140,
B)), which that K6 reads in place of a scratch of its own (clear's keeps
a scratch).
On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version (``rtrn.rt_sweep_blocked``,
``rtrn.rt_sweep_vjp``, ``rtrn.SWEEPS``) and, backward, its plain vjp.

Reduced spectral storage (``spec_codec``): taut_t and fracs_t may hold
taug and fracs in bfloat16, float16 or logu16 codes (uint16), with the
aerosol od ``taua_t`` (L, 16, B) given apart; K1 decodes them and adds
taua_t itself (the plain route: ``spec_codec.spec_inputs``, then the
plain sweep).  In float32 taut_t already holds taug + taua and taua_t is
None.  A backward through reduced storage raises NotImplementedError.

Each wrapper counts its launches in ``.launches``, those at idrv=1 in
``.idrv.launches`` and those in reduced storage in ``.spec.launches``;
``.save.launches`` of each ``rt_fluxes_*`` counts K1's launches in its
mode that keep the radiances.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..types import NGPT, NGPT_PAD
from . import rtrn
from ._autograd import plain_vjp
from .spec_codec import GRAD_MESSAGE, REDUCED, SPEC_CODES, spec_inputs

# the kernel's mode argument (csrc/rtrn.cuh enum Mode)
MODES = {"clear": 0, "compact": 1, "banded": 2, "maxrand": 3, "fused": 4,
         "cldf_od": 5}
# the (L, *, B) cloud inputs of each mode after the sweep's own inputs:
# name and g/band/row count (None: (L, B))
CLOUD_INPUTS = {
    "banded": (("cldf_t", None), ("taucb_t", 16)),
    "maxrand": (("rows_t", rtrn.NROWS), ("taucb_t", 16)),
    "fused": (("cldf_t", NGPT_PAD), ("ciwp_t", NGPT_PAD),
              ("clwp_t", NGPT_PAD), ("tauc_t", NGPT_PAD), ("abi_t", 16),
              ("abl_t", 16)),
    "cldf_od": (("cldf_t", NGPT_PAD), ("odcld_t", NGPT_PAD)),
}
# launches of K6's instantiations with the d/dT sweep's adjoint, per mode
DDT_LAUNCHES = {mode: _build.Launches() for mode in MODES}
# the modes whose K1 SAVE at idrv=1 keeps the d/dT derivatives P, PC
# (planes 4-5 of its radiances; csrc/rtrn.cuh keeps_ddt): their d/dT K6
# reads them and takes no scratch (all but clear, whose d/dT K6 keeps one)
KEEPS_DDT = ("compact", "banded", "maxrand", "fused", "cldf_od")


def rads_planes(mode, idrv):
    """The planes of the radiances K1 keeps in ``mode`` (a ``MODES`` key;
    maxrand's beside its packed sub-streams, ``rt_sweep_maxrand_radiances``)
    at ``idrv``: D and U (clear), their clear twins (cloudy modes), and at
    idrv=1 in ``KEEPS_DDT`` the d/dT derivatives P and PC."""
    if mode == "clear":
        return 2
    return 6 if idrv and mode in KEEPS_DDT else 4


def _check(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t, abl_t,
           mask, ngb0, wg, surf_rows=(3, 4), taua_t=None):
    L, _, B = taut_t.shape
    dev = taut_t.device
    f32 = torch.float32
    sdt = taut_t.dtype
    if sdt not in SPEC_CODES:
        raise TypeError(f"taut_t: dtype {sdt}, K1 reads "
                        f"{tuple(SPEC_CODES)}")
    _build.check(taut_t, "taut_t", sdt, (L, NGPT, B), dev)
    _build.check(fracs_t, "fracs_t", sdt, (L, NGPT, B), dev)
    if sdt == f32:
        if taua_t is not None:
            raise ValueError("taua_t is for reduced storage: in float32 "
                             "taut_t holds taug + taua")
    else:
        if taua_t is None:
            raise ValueError(f"taut_t in {sdt} needs taua_t (L, 16, B)")
        _build.check(taua_t, "taua_t", f32, (L, 16, B), dev)
    _build.check(planklay_t, "planklay_t", f32, (L, 16, B), dev)
    _build.check(planklev_t, "planklev_t", f32, (L + 1, 16, B), dev)
    nsurf = surf.shape[0] if surf.shape[0] in surf_rows else surf_rows[0]
    _build.check(surf, "surf", f32, (nsurf, 16, B), dev)
    _build.check(ngb0, "ngb0", torch.int32, (NGPT,), dev)
    _build.check(wg, "wg", f32, (NGPT,), dev)
    if mask is not None:
        _build.check(mask, "mask", torch.int8, (L, NGPT_PAD, B), dev)
        _build.check(cw_t, "cw_t", f32, (L, 2, B), dev)
        _build.check(abi_t, "abi_t", f32, (L, 16, B), dev)
        _build.check(abl_t, "abl_t", f32, (L, 16, B), dev)
    return L, B


def _launch(mode, wrapper, taut_t, fracs_t, planklay_t, planklev_t, surf,
            ngb0, wg, mask=None, cw=None, abi=None, abl=None, cld=None,
            taucb=None, cldf=None, ciwp=None, clwp=None, tauc=None,
            taua=None, rads=None, subs=None, words=None):
    """K1 in ``mode``, in the storage of taut_t; counted on ``wrapper``
    (and on ``wrapper.save`` when it writes the radiances to ``rads``;
    maxrand: the packed sub-streams to ``subs``; fused, cldf-odcld: the
    cloudy-layer words to ``words``).  -> (4|6, L+1, B)."""
    L, _, B = taut_t.shape
    idrv = surf.shape[0] == 4
    out = torch.empty((6 if idrv else 4, L + 1, B), dtype=torch.float32,
                      device=taut_t.device)
    spec = SPEC_CODES[taut_t.dtype]
    _build.launch("rrtm_rt", taut_t, fracs_t, planklay_t, planklev_t, surf,
                  ngb0, wg, mask, cw, abi, abl, cld, taucb, cldf, ciwp, clwp,
                  tauc, taua, out, L, B, MODES[mode], int(idrv), spec, rads,
                  subs, 0 if subs is None else subs.shape[2], words)
    wrapper.launches += 1
    if idrv:
        wrapper.idrv.launches += 1
    if spec:
        wrapper.spec.launches += 1
    if rads is not None:
        wrapper.save.launches += 1
    return out


def rt_sweep_radiances(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t,
                       abi_t, abl_t, mask, ngb0, wg):
    """K1 clear (mask None) or compact in float32, keeping its per-g
    radiances: -> (fluxes (4|6, L+1, B), rads (2|4|6, L, 140, B), words),
    rads the down radiance at level l, the up radiance entering layer l
    (l = 0: after the surface reflection) and, compact, their clear
    twins, for l = 0..L-1, and compact at idrv=1 the d/dT derivative
    entering layer l and its clear twin (``rads_planes``): what K6
    (``rt_sweep_vjp``) reads; words the
    cloudy-layer words of the mask, int32 ((B + 31) // 32, L)
    (``rtrn.cloudy_words``), which compact's d/dT adjoint reads: on the
    card compact at idrv=1 (surf (4, 16, B)) alone, on a CPU tensor every
    compact call; None elsewhere.  The fluxes are bitwise those of the
    launch without them.  Arguments as ``RTFn``; on a CPU tensor the
    plain version, ``rtrn.rt_sweep_blocked(..., radiances=True)``.
    Counted on ``rt_fluxes_blocked`` and its ``.save``."""
    if taut_t.device.type == "cpu":
        cf = None if mask is None else (mask, cw_t, abi_t, abl_t)
        return (*rtrn.rt_sweep_blocked(taut_t, fracs_t, planklay_t,
                                       planklev_t, surf, ngb0, wg, cf,
                                       radiances=True),
                None if mask is None else rtrn.cloudy_words(mask))
    if taut_t.dtype != torch.float32:
        raise TypeError(f"taut_t: dtype {taut_t.dtype}, K1 keeps the "
                        "radiances in float32 storage only")
    L, B = _check(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t,
                  abi_t, abl_t, mask, ngb0, wg)
    idrv = surf.shape[0] == 4
    rads = torch.empty((rads_planes("clear" if mask is None else "compact",
                                    idrv), L, NGPT, B),
                       dtype=torch.float32, device=taut_t.device)
    words = None if mask is None or not idrv else torch.empty(
        ((B + 31) // 32, L), dtype=torch.int32, device=taut_t.device)
    out = _launch("clear" if mask is None else "compact", rt_fluxes_blocked,
                  taut_t, fracs_t, planklay_t, planklev_t, surf, ngb0, wg,
                  mask, cw_t, abi_t, abl_t, rads=rads, words=words)
    return out, rads, words


class KeptCount:
    """K of the packed maxrand state (``rtrn.kept_depth``) for the
    overlap rows ``rows_t``: on the card counted there and copied to
    pinned host memory without a wait; ``value()`` waits on the copy's
    event.  The model starts one where it forms the rows of a step that
    records a gradient, before taumol, and hands it to the sweep
    (``rt_fluxes_maxrand(..., kept=)``), which allocates the state long
    after: the wait then finds the copy done.  On CPU rows, counted
    directly."""

    def __init__(self, rows_t):
        counts = rtrn.substreams_kept(rows_t).sum(dim=1).amax()
        self.event = None
        if rows_t.device.type == "cpu":
            self.host = counts
            return
        self.host = torch.empty((), dtype=counts.dtype, pin_memory=True)
        self.host.copy_(counts, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def value(self):
        if self.event is not None:
            self.event.synchronize()
        return max(1, int(self.host))


def rt_sweep_maxrand_radiances(taut_t, fracs_t, planklay_t, planklev_t,
                               surf, rows_t, taucb_t, ngb0, wg, kept=None):
    """K1 maxrand in float32 keeping the state K6 reads: -> (fluxes (4|6,
    L+1, B), rads (4|6, L, 140, B), subs (2, 3, K, 140, B)), rads the down
    radiance at level l, the up radiance entering layer l and their clear
    twins, for l = 0..L-1, at idrv=1 then the d/dT derivative entering
    layer l and its clear twin (``rads_planes``); subs the sub-streams
    (cr, kr, rr) entering a layer in the down sweep and in the up sweep
    where K6 reads them (``rtrn.substreams_kept``), a column's k-th such
    layer of a sweep at slot k (``rtrn.substream_slots``), K the most of
    any column (``rtrn.kept_depth``): ``kept.value()``, a ``KeptCount`` of
    ``rows_t``, else counted here, a wait on the card; the slots past a
    column's count are left unwritten (``rtrn.unpack_state`` makes two
    states comparable).  The
    fluxes are bitwise those of the launch without them.  Arguments as
    ``RTSweepFn``'s maxrand inputs; on a CPU tensor the plain version,
    ``rtrn.rt_sweep_maxrand(..., radiances=True)``.  Counted on
    ``rt_fluxes_maxrand`` and its ``.save``."""
    x = (taut_t, fracs_t, planklay_t, planklev_t, surf)
    if taut_t.device.type == "cpu":
        return rtrn.rt_sweep_maxrand(*x, rows_t, taucb_t, ngb0, wg,
                                     radiances=True)
    if taut_t.dtype != torch.float32:
        raise TypeError(f"taut_t: dtype {taut_t.dtype}, K1 keeps the "
                        "radiances in float32 storage only")
    L, B = _check(*x, None, None, None, None, ngb0, wg)
    _check_clouds("maxrand", (rows_t, taucb_t), L, B, taut_t.device)
    K = (KeptCount(rows_t) if kept is None else kept).value()
    rads = torch.empty((rads_planes("maxrand", surf.shape[0] == 4), L, NGPT,
                        B), dtype=torch.float32, device=taut_t.device)
    subs = torch.empty((2, 3, K, NGPT, B), dtype=torch.float32,
                       device=taut_t.device)
    out = _launch("maxrand", rt_fluxes_maxrand, *x, ngb0, wg, cld=rows_t,
                  taucb=taucb_t, rads=rads, subs=subs)
    return out, rads, subs


def rt_sweep_g_radiances(mode, taut_t, fracs_t, planklay_t, planklev_t,
                         surf, clouds, ngb0, wg):
    """K1 in the banded, fused or cldf-odcld ``mode`` in float32, keeping
    its per-g radiances: -> (fluxes (4|6, L+1, B), rads (4|6, L, 140, B),
    words), rads as ``rt_sweep_radiances``' compact ones (D, U and their
    clear twins, at idrv=1 the d/dT derivatives P and PC too), words
    (fused, cldf-odcld) the cloudy-layer words of
    the per-g cloud fraction, int32 ((B + 31) // 32, L)
    (``rtrn.cloudy_words``; None in banded): what K6 in that mode
    (``rt_sweep_banded_vjp``, ``rt_sweep_g_vjp``) reads.  The fluxes are
    bitwise those of the launch without them.  ``clouds`` as
    ``CLOUD_INPUTS[mode]``; on a CPU tensor the plain version
    (``rtrn.rt_sweep_banded`` or ``rtrn.rt_sweep_blocked`` with
    ``radiances=True``).  Counted on ``WRAPPERS[mode]`` and its
    ``.save``."""
    x = (taut_t, fracs_t, planklay_t, planklev_t, surf)
    if taut_t.device.type == "cpu":
        if mode == "banded":
            return (*rtrn.rt_sweep_banded(*x, *clouds, ngb0, wg,
                                          radiances=True), None)
        return rtrn.rt_sweep_blocked(*x, ngb0, wg, tuple(clouds),
                                     radiances=True)
    if taut_t.dtype != torch.float32:
        raise TypeError(f"taut_t: dtype {taut_t.dtype}, K1 keeps the "
                        "radiances in float32 storage only")
    L, B = _check(*x, None, None, None, None, ngb0, wg)
    _check_clouds(mode, clouds, L, B, taut_t.device)
    rads = torch.empty((rads_planes(mode, surf.shape[0] == 4), L, NGPT, B),
                       dtype=torch.float32, device=taut_t.device)
    words = None if mode == "banded" else torch.empty(
        ((B + 31) // 32, L), dtype=torch.int32, device=taut_t.device)
    out = _launch(mode, WRAPPERS[mode], *x, ngb0, wg, rads=rads,
                  words=words, **_cloud_kw(mode, clouds))
    return out, rads, words


def _cloud_kw(mode, clouds):
    """``_launch``'s keywords of the cloud inputs of ``mode``."""
    if mode in ("banded", "maxrand"):
        return dict(cld=clouds[0], taucb=clouds[1])
    if mode == "cldf_od":
        return dict(cldf=clouds[0], tauc=clouds[1])
    return dict(zip(("cldf", "ciwp", "clwp", "tauc", "abi", "abl"), clouds))


def _check_clouds(mode, clouds, L, B, device):
    for t, (name, n) in zip(clouds, CLOUD_INPUTS[mode], strict=True):
        _build.check(t, name, torch.float32, (L, B) if n is None
                     else (L, n, B), device)


def _full_ct(ct, ct_ddt):
    """The (6, L+1, B) cotangent of an idrv=1 sweep, zeros where None (the
    plain vjps' form)."""
    like = ct if ct is not None else ct_ddt
    shape = tuple(like.shape[1:])

    def z(n):
        return torch.zeros((n,) + shape, dtype=like.dtype, device=like.device)
    return torch.cat([z(4) if ct is None else ct,
                      z(2) if ct_ddt is None else ct_ddt])


def _ddt_operands(ct, ct_ddt, L, B, device, nlam=0):
    """The flux cotangents K6 at idrv=1 stages (zeros where the loss reads
    no flux, ``ct`` None), the checked d/dT cotangents and, clear, K6's
    scratch of ``nlam`` (L, 140, B) planes (``rtrn.cuh`` Ddt; None where
    nlam is 0: the ``KEEPS_DDT`` modes read K1's derivatives instead)."""
    _build.check(ct_ddt, "ct_ddt", torch.float32, (2, L + 1, B), device)
    if ct is None:
        ct = torch.zeros((4, L + 1, B), dtype=torch.float32, device=device)
    lam = None if nlam == 0 else torch.empty(
        (nlam, L, NGPT, B), dtype=torch.float32, device=device)
    return ct, ct_ddt, lam


class RTFn(torch.autograd.Function):
    """(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t,
    abl_t, mask, ngb0, wg, taua_t, grad_enabled) -> fluxes (4, L+1, B);
    the four cloud inputs are None for clear sky, taua_t None in float32
    storage.  With a (4, 16, B) surf (idrv=1): (fluxes, d/dT (2, L+1,
    B)).  Backward K6 on the fluxes' cotangent (the d/dT row of surf gets
    zero), and with a cotangent of d/dT its instantiation that runs the
    d/dT sweep's adjoint too; mask, ngb0 and wg get None.  On the card,
    where an input needs a gradient and ``grad_enabled``
    (``torch.is_grad_enabled()`` at the call: forward runs with grad mode
    off) holds, K1 keeps its radiances for K6 (``rt_sweep_radiances``;
    compact at idrv=1 also the cloudy-layer words its d/dT adjoint reads).
    In reduced storage any backward raises."""

    @staticmethod
    def forward(ctx, taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t,
                abi_t, abl_t, mask, ngb0, wg, taua_t=None,
                grad_enabled=True):
        args = (taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t,
                abl_t, mask, ngb0, wg)
        ctx.set_materialize_grads(False)
        ctx.device_type = taut_t.device.type
        ctx.reduced = taut_t.dtype in REDUCED
        keep = any(ctx.needs_input_grad[:8]) and not ctx.reduced
        if taut_t.device.type == "cpu":
            if keep:
                ctx.save_for_backward(*args)
            cf = None if mask is None else (mask, cw_t, abi_t, abl_t)
            out = rtrn.rt_sweep_blocked(
                *spec_inputs(taut_t, fracs_t, taua_t, ngb0), planklay_t,
                planklev_t, surf, ngb0, wg, cf)
        elif keep and grad_enabled:
            out, rads, words = rt_sweep_radiances(*args)
            ctx.save_for_backward(*args, rads, words)
        else:
            _check(*args, taua_t=taua_t)
            out = _launch("clear" if mask is None else "compact",
                          rt_fluxes_blocked, taut_t, fracs_t, planklay_t,
                          planklev_t, surf, ngb0, wg, mask, cw_t, abi_t,
                          abl_t, taua=taua_t)
        return rtrn.split_ddt(out)

    @staticmethod
    def backward(ctx, ct, ct_ddt=None):
        if ctx.reduced:
            raise NotImplementedError(GRAD_MESSAGE)
        if ct is None and ct_ddt is None:
            return (None,) * 13
        x = list(ctx.saved_tensors)
        rads = words = None
        if ctx.device_type != "cpu":
            rads, words = x[-2:]
            del x[-2:]
        nsurf = x[4].shape[0]
        if ct_ddt is None:
            x[4] = x[4][:3]             # the fluxes do not read row 3
        grads = list(rt_sweep_vjp(*x, ct, needs=ctx.needs_input_grad[:8],
                                  rads=rads, ct_ddt=ct_ddt, words=words))
        return (*_pad_surf(grads, nsurf), None, None, None, None, None)


def rt_fluxes_blocked(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                      semiss, pwvcm, ngb0, wg, cloud_fields=None,
                      dplankbnd_dt=None, taua_t=None):
    """K1 clear or compact: band-integrated fluxes (4, L+1, B) = [up,
    down, clear up, clear down], and with ``dplankbnd_dt`` (B, 16)
    (idrv=1) a pair (fluxes, d/dT (2, L+1, B)); arguments as
    ``rtrn.rt_fluxes_blocked`` (cloud_fields None or the compact McICA
    4-tuple; the compact mask must be int8 here; taua_t with reduced
    storage).  The surface rows are formed outside ``RTFn``, so autograd
    differentiates the diffusivity secant."""
    surf = rtrn.surf_rows(plankbnd, semiss, pwvcm, planklay_t.dtype,
                          dplankbnd_dt)
    cw_t = abi_t = abl_t = mask = None
    if cloud_fields is not None:
        if len(cloud_fields) != 4:
            raise ValueError("rt_fluxes_blocked takes the compact McICA "
                             "fields; per-g arrays go to rt_fluxes_fused "
                             "or rt_fluxes_cldf_od")
        mask, cw_t, abi_t, abl_t = cloud_fields
    return RTFn.apply(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t,
                      abi_t, abl_t, mask, ngb0, wg, taua_t,
                      torch.is_grad_enabled())


class RTSweepFn(torch.autograd.Function):
    """(mode, ngb0, wg, taua_t, grad_enabled, kept, taut_t, fracs_t,
    planklay_t, planklev_t, surf, *clouds) -> fluxes (4, L+1, B), or with
    a (4, 16, B) surf (fluxes, d/dT (2, L+1, B)): K1 in the banded,
    maxrand, fused or cldf-odcld mode, ``clouds`` as
    ``CLOUD_INPUTS[mode]``, taua_t None in float32 storage.  Backward:
    the plain vjp on the CPU; on the card K6 in the mode, fed
    the radiances (maxrand: the state; fused, cldf-odcld: and the
    cloudy-layer words) K1 kept where an input needs a
    gradient and ``grad_enabled``, ``torch.is_grad_enabled()`` at the
    call, holds (maxrand: K from ``kept``, a ``KeptCount`` or None, as
    ``rt_sweep_maxrand_radiances``), and with a cotangent of d/dT K6's
    instantiation in the mode that runs the d/dT sweep's adjoint too; in
    reduced storage it raises."""

    @staticmethod
    def forward(ctx, mode, ngb0, wg, taua_t, grad_enabled, kept, *x):
        ctx.mode, ctx.device_type = mode, x[0].device.type
        ctx.reduced = x[0].dtype in REDUCED
        ctx.set_materialize_grads(False)
        keep = any(ctx.needs_input_grad[6:]) and not ctx.reduced
        if x[0].device.type == "cpu":
            if keep:
                ctx.save_for_backward(ngb0, wg, *x)
            return rtrn.split_ddt(rtrn.SWEEPS[mode](
                *spec_inputs(x[0], x[1], taua_t, ngb0), *x[2:], ngb0, wg))
        if keep and grad_enabled:
            if mode == "maxrand":
                out, *state = rt_sweep_maxrand_radiances(*x, ngb0, wg,
                                                         kept)
            else:
                out, *state = rt_sweep_g_radiances(mode, *x[:5], x[5:],
                                                   ngb0, wg)
                if state[1] is None:        # banded: no words
                    state = state[:1]
            ctx.nstate = len(state)
            ctx.save_for_backward(ngb0, wg, *x, *state)
            return rtrn.split_ddt(out)
        L, B = _check(*x[:5], None, None, None, None, ngb0, wg,
                      taua_t=taua_t)
        clouds = x[5:]
        _check_clouds(mode, clouds, L, B, x[0].device)
        return rtrn.split_ddt(_launch(mode, WRAPPERS[mode], *x[:5], ngb0, wg,
                                      taua=taua_t,
                                      **_cloud_kw(mode, clouds)))

    @staticmethod
    def backward(ctx, ct, ct_ddt=None):
        if ctx.reduced:
            raise NotImplementedError(GRAD_MESSAGE)
        needs = ctx.needs_input_grad[6:]
        if ct is None and ct_ddt is None:
            return (None,) * (6 + len(needs))
        ngb0, wg, *x = ctx.saved_tensors
        if ctx.device_type == "cpu":
            if x[4].shape[0] == 4:
                ct = _full_ct(ct, ct_ddt)
            grads = plain_vjp(lambda *a: rtrn.SWEEPS[ctx.mode](*a, ngb0, wg),
                              x, needs, (ct,))
            return (None,) * 6 + tuple(grads)
        x, state = x[:-ctx.nstate], x[-ctx.nstate:]
        nsurf = x[4].shape[0]
        if ct_ddt is None:
            x[4] = x[4][:3]             # the fluxes do not read row 3
        if ctx.mode == "maxrand":
            grads = rt_sweep_maxrand_vjp(*x, ngb0, wg, ct, needs, state,
                                         ct_ddt=ct_ddt)
        elif ctx.mode == "banded":
            grads = rt_sweep_banded_vjp(*x, ngb0, wg, ct, needs, *state,
                                        ct_ddt=ct_ddt)
        else:
            grads = rt_sweep_g_vjp(*x[:5], x[5:], ngb0, wg, ct, needs,
                                   *state, ct_ddt=ct_ddt)
        return (None,) * 6 + tuple(_pad_surf(list(grads), nsurf))


def _pad_surf(grads, nsurf):
    """The vjps' cotangents with surf's padded to its ``nsurf`` rows (the
    d/dT row's zero where the loss reads no d/dT)."""
    if grads[4] is not None and grads[4].shape[0] < nsurf:
        grads[4] = torch.nn.functional.pad(grads[4], (0, 0, 0, 0, 0, 1))
    return grads


def _sweep(mode, taut_t, fracs_t, planklay_t, planklev_t, plankbnd, semiss,
           pwvcm, ngb0, wg, clouds, dplankbnd_dt, taua_t, kept=None):
    surf = rtrn.surf_rows(plankbnd, semiss, pwvcm, planklay_t.dtype,
                          dplankbnd_dt)
    return RTSweepFn.apply(mode, ngb0, wg, taua_t, torch.is_grad_enabled(),
                           kept, taut_t, fracs_t, planklay_t, planklev_t,
                           surf, *clouds)


def rt_fluxes_banded(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                     semiss, pwvcm, ngb0, wg, cldf_t, taucb_t,
                     dplankbnd_dt=None, taua_t=None):
    """K1 banded mode: fluxes (4, L+1, B) under random overlap of
    per-band clouds (and d/dT with ``dplankbnd_dt``); arguments as
    ``rtrn.rt_fluxes_banded``."""
    return _sweep("banded", taut_t, fracs_t, planklay_t, planklev_t,
                  plankbnd, semiss, pwvcm, ngb0, wg, (cldf_t, taucb_t),
                  dplankbnd_dt, taua_t)


def rt_fluxes_maxrand(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                      semiss, pwvcm, ngb0, wg, rows_t, taucb_t,
                      dplankbnd_dt=None, taua_t=None, kept=None):
    """K1 maxrand mode: fluxes (4, L+1, B) under maximum-random overlap
    (and d/dT with ``dplankbnd_dt``); arguments as
    ``rtrn.rt_fluxes_maxrand``.  ``kept``: a ``KeptCount`` of ``rows_t``
    started earlier, where the sweep keeps the state for a gradient
    (else the count waits on the card there)."""
    return _sweep("maxrand", taut_t, fracs_t, planklay_t, planklev_t,
                  plankbnd, semiss, pwvcm, ngb0, wg, (rows_t, taucb_t),
                  dplankbnd_dt, taua_t, kept)


def rt_fluxes_fused(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                    semiss, pwvcm, ngb0, wg, cloud_fields,
                    dplankbnd_dt=None, taua_t=None):
    """K1 fused mode: fluxes (4, L+1, B) of McICA per-g arrays with
    cldprmc (inflag=2) inside the kernel (and d/dT with
    ``dplankbnd_dt``).  cloud_fields = (cldf_t, ciwp_t, clwp_t, tauc_t)
    (L, 144, B) and (abi_t, abl_t) (L, 16, B), as
    ``rtrn.rt_sweep_blocked``."""
    return _sweep("fused", taut_t, fracs_t, planklay_t, planklev_t,
                  plankbnd, semiss, pwvcm, ngb0, wg, cloud_fields,
                  dplankbnd_dt, taua_t)


def rt_fluxes_cldf_od(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                      semiss, pwvcm, ngb0, wg, cloud_fields,
                      dplankbnd_dt=None, taua_t=None):
    """K1 cldf-odcld mode: fluxes (4, L+1, B) of McICA per-g cloud
    fraction and cloud od, cloud_fields = (cldf_t, odcld_t) (L, 144, B)
    from ``cldprop.cldprmc_blocked`` (and d/dT with ``dplankbnd_dt``)."""
    return _sweep("cldf_od", taut_t, fracs_t, planklay_t, planklev_t,
                  plankbnd, semiss, pwvcm, ngb0, wg, cloud_fields,
                  dplankbnd_dt, taua_t)


# the model's RT step per K1 mode (``rtrn.FLUXES`` holds the plain ones)
WRAPPERS = {"blocked": rt_fluxes_blocked, "fused": rt_fluxes_fused,
            "cldf_od": rt_fluxes_cldf_od, "banded": rt_fluxes_banded,
            "maxrand": rt_fluxes_maxrand}


def rt_sweep_vjp(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t,
                 abl_t, mask, ngb0, wg, ct, needs=(True,) * 8, rads=None,
                 ct_ddt=None, words=None):
    """K6: flux cotangents ct (4, L+1, B) -> cotangents of (taut_t,
    fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t, abl_t), None
    where ``needs`` is False or the input is None (clear sky).  With
    ``ct_ddt`` (2, L+1, B), the cotangents of duflx_dt and duflxc_dt
    (idrv=1: surf (4, 16, B), ``ct`` may be None), its instantiation that
    also runs the d/dT sweep's adjoint (counted in
    ``DDT_LAUNCHES["clear" | "compact"]``, not in ``.launches``): clear's
    in csrc/rtrn_bwd.cu, compact's on K6-g's tile (csrc/rtrn_bwd_g.cu,
    ``rt_bwd_g_ddt_kernel`` in the compact mode), which also reads
    ``words``, the cloudy-layer words K1 kept (``rt_sweep_radiances`` at
    idrv=1), and the d/dT derivatives in rads' planes 4-5, and takes no
    scratch.  On the card K6 reads ``rads``, the radiances K1 kept on the
    same inputs (``rt_sweep_radiances``; compact: at idrv=1 if ct_ddt is
    given), and raises without them (or without the words there); the
    plain vjp (CPU tensors) reads neither."""
    if taut_t.device.type == "cpu":
        return rtrn.rt_sweep_vjp(taut_t, fracs_t, planklay_t, planklev_t,
                                 surf, cw_t, abi_t, abl_t, mask, ngb0, wg,
                                 ct if ct_ddt is None
                                 else _full_ct(ct, ct_ddt), needs)
    ddt = ct_ddt is not None
    L, B = _check(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t,
                  abl_t, mask, ngb0, wg, surf_rows=(4,) if ddt else (3,))
    dev = taut_t.device
    cloudy = mask is not None
    if ddt:
        ct, ct_ddt, lam = _ddt_operands(ct, ct_ddt.contiguous(), L, B, dev,
                                        0 if cloudy else 1)
    ct = ct.contiguous()
    _build.check(ct, "ct", torch.float32, (4, L + 1, B), dev)
    if rads is None:
        raise ValueError("rt_sweep_vjp on the card reads the radiances K1 "
                         "kept on the same inputs (rads, from "
                         "rt_sweep_radiances): K6 runs no forward sweep")
    _check_rads(rads, "clear" if mask is None else "compact", ddt, L, B,
                dev)
    grads = [torch.empty_like(x) for x in (taut_t, fracs_t, planklay_t,
                                           planklev_t, surf)]
    grads += [torch.empty_like(x) if cloudy else None
              for x in (cw_t, abi_t, abl_t)]
    x = (taut_t, fracs_t, planklay_t, planklev_t, surf, ngb0, wg, mask, cw_t,
         abi_t, abl_t, ct, rads, *grads)
    if ddt and cloudy:
        if words is None:
            raise ValueError("rt_sweep_vjp on the card reads the cloudy-"
                             "layer words K1 kept with the radiances at "
                             "idrv=1 (words, from rt_sweep_radiances) for "
                             "compact's d/dT adjoint")
        _build.check(words, "words", torch.int32, ((B + 31) // 32, L), dev)
        # K6-g's clouds and cotangents of compact (rrtm_rt_bwd_g_ddt):
        # the mask, cw, -, -, abi, abl
        gcw, gabi, gabl = grads[5:]
        _build.launch("rrtm_rt_bwd_g_ddt", taut_t, fracs_t, planklay_t,
                      planklev_t, surf, ngb0, wg, mask, cw_t, None, None,
                      abi_t, abl_t, ct, rads, *grads[:5], None, gcw, None,
                      None, gabi, gabl, words,
                      *k6_g_scratch("compact", L, B, dev), ct_ddt, L, B,
                      MODES["compact"])
        DDT_LAUNCHES["compact"].launches += 1
    elif ddt:
        _build.launch("rrtm_rt_bwd_ddt", *x, ct_ddt, lam, L, B, 0)
        DDT_LAUNCHES["clear"].launches += 1
    else:
        _build.launch("rrtm_rt_bwd", *x, L, B, int(cloudy))
        rt_sweep_vjp.launches += 1
    return tuple(g if n else None for g, n in zip(grads, needs))


def rt_sweep_maxrand_vjp(taut_t, fracs_t, planklay_t, planklev_t, surf,
                         rows_t, taucb_t, ngb0, wg, ct, needs=(True,) * 7,
                         state=None, ct_ddt=None):
    """K6 in the maxrand mode (csrc/rtrn_bwd_mr.cu): flux cotangents ct
    (4, L+1, B) -> cotangents of (taut_t, fracs_t, planklay_t,
    planklev_t, surf (3, 16, B), rows_t (the overlap rows: R_CLDF and the
    12 factor rows; zeros in the four flag rows), taucb_t), None where
    ``needs`` is False.  ``ct_ddt``: as ``rt_sweep_vjp``'s (surf (4, 16,
    B); counted in ``DDT_LAUNCHES["maxrand"]``; it reads the d/dT
    derivatives K1 kept at idrv=1, rads' planes 4-5, and takes no
    scratch).  On the card it reads
    ``state``, the pair (rads, subs) K1 kept on the same inputs
    (``rt_sweep_maxrand_radiances``), and raises without it; the plain
    vjp (CPU tensors, ``rtrn.rt_sweep_maxrand_vjp``) does not read it,
    but raises where a given state has fewer slots than a column of
    ``rows_t`` keeps (K6 stops the launch there, as an index out of range
    does)."""
    x = (taut_t, fracs_t, planklay_t, planklev_t, surf, rows_t, taucb_t)
    if taut_t.device.type == "cpu":
        if state is not None:
            K = rtrn.kept_depth(rtrn.substream_slots(rows_t)[1])
            if state[1].shape[2] < K:
                raise ValueError(f"subs: {state[1].shape[2]} slots a sweep, "
                                 f"the rows keep {K}: a state kept on "
                                 "other rows")
        return rtrn.rt_sweep_maxrand_vjp(
            *x, ngb0, wg, ct if ct_ddt is None else _full_ct(ct, ct_ddt),
            needs)
    ddt = ct_ddt is not None
    L, B = _check(*x[:5], None, None, None, None, ngb0, wg,
                  surf_rows=(4,) if ddt else (3,))
    dev = taut_t.device
    _check_clouds("maxrand", (rows_t, taucb_t), L, B, dev)
    if ddt:
        ct, ct_ddt, _ = _ddt_operands(ct, ct_ddt.contiguous(), L, B, dev)
    ct = ct.contiguous()
    _build.check(ct, "ct", torch.float32, (4, L + 1, B), dev)
    if state is None:
        raise ValueError("rt_sweep_maxrand_vjp on the card reads the state "
                         "K1 kept on the same inputs (rads, subs, from "
                         "rt_sweep_maxrand_radiances): K6 runs no forward "
                         "sweep")
    rads, subs = state
    _check_rads(rads, "maxrand", ddt, L, B, dev)
    K = subs.shape[2]
    _build.check(subs, "subs", torch.float32, (2, 3, K, NGPT, B), dev)
    grads = [torch.empty_like(t) for t in x]
    a = (*x, ngb0, wg, ct, rads, subs, *grads, *k6_mr_scratch(L, B, dev))
    if ddt:
        _build.launch("rrtm_rt_bwd_mr_ddt", *a, ct_ddt, L, K, B)
        DDT_LAUNCHES["maxrand"].launches += 1
    else:
        _build.launch("rrtm_rt_bwd_mr", *a, L, K, B)
        rt_sweep_maxrand_vjp.launches += 1
    return tuple(g if n else None for g, n in zip(grads, needs))


def _check_rads(rads, mode, ddt, L, B, device):
    """Checks the radiances K1 kept in ``mode`` for K6: at idrv=1 with a
    d/dT cotangent (``ddt``) the planes ``rads_planes(mode, 1)``, else
    those of either idrv (K6 at idrv=0 reads the first four of six where
    the step ran K1 at idrv=1 but its loss reads no d/dT; maxrand's beside
    its sub-streams)."""
    planes = [rads_planes(mode, i) for i in ((1,) if ddt else (0, 1))]
    n = rads.shape[0] if rads.shape[0] in planes else planes[0]
    _build.check(rads, "rads", torch.float32, (n, L, NGPT, B), device)


def k6_mr_scratch(L, B, device, lib=None):
    """The scratch of K6 maxrand at L layers and B columns, as
    ``rrtm_rt_bwd_mr_scratch`` of ``lib`` (default the package's library)
    sizes it: (zeroed int32 counters, the tickets' then one per column
    tile; the band groups' shares of the overlap rows' cotangents,
    float32)."""
    n = (ctypes.c_int * 2)()
    lib = lib or _build.library()
    lib.rrtm_rt_bwd_mr_scratch(int(L), int(B),
                               ctypes.cast(n, ctypes.c_void_p))
    return (torch.zeros(n[0], dtype=torch.int32, device=device),
            torch.empty(n[1], dtype=torch.float32, device=device))


def _launch_bwd_g(mode, counters, x, clouds, ngb0, wg, ct, needs, rads,
                  words=None, ct_ddt=None):
    """K6 in the banded, fused or cldf-odcld ``mode`` on the card
    (csrc/rtrn_bwd_g.cu), fed K1's radiances and (fused, cldf-odcld)
    cloudy-layer words, counted on each of ``counters`` (with ``ct_ddt``:
    its instantiation that runs the d/dT sweep's adjoint too, counted in
    ``DDT_LAUNCHES[mode]``): -> the cotangents of (*x, *clouds), None
    where ``needs`` is False."""
    ddt = ct_ddt is not None
    L, B = _check(*x, None, None, None, None, ngb0, wg,
                  surf_rows=(4,) if ddt else (3,))
    dev = x[0].device
    _check_clouds(mode, clouds, L, B, dev)
    if ddt:
        ct, ct_ddt, _ = _ddt_operands(ct, ct_ddt.contiguous(), L, B, dev)
    ct = ct.contiguous()
    _build.check(ct, "ct", torch.float32, (4, L + 1, B), dev)
    if rads is None:
        raise ValueError(f"K6 ({mode}) on the card reads the radiances K1 "
                         "kept on the same inputs (rads, from "
                         "rt_sweep_g_radiances): K6 runs no forward sweep")
    _check_rads(rads, mode, ddt, L, B, dev)
    if mode != "banded":
        if words is None:
            raise ValueError(f"K6 ({mode}) on the card reads the cloudy-layer "
                             "words K1 kept with the radiances (words, from "
                             "rt_sweep_g_radiances)")
        _build.check(words, "words", torch.int32, ((B + 31) // 32, L), dev)
    grads = [torch.empty_like(t) for t in (*x, *clouds)]
    pad = (None,) * (6 - len(clouds))
    a = (*x, ngb0, wg, *clouds, *pad, ct, rads, *grads, *pad, words,
         *k6_g_scratch(mode, L, B, dev))
    if ddt:
        _build.launch("rrtm_rt_bwd_g_ddt", *a, ct_ddt, L, B, MODES[mode])
        DDT_LAUNCHES[mode].launches += 1
    else:
        _build.launch("rrtm_rt_bwd_g", *a, L, B, MODES[mode])
        for c in counters:
            c.launches += 1
    return tuple(g if n else None for g, n in zip(grads, needs))


def k6_g_scratch(mode, L, B, device, lib=None):
    """The scratch of K6 in the banded, fused, cldf-odcld or (its d/dT
    instantiation) compact ``mode`` at L layers and B columns, as
    ``rrtm_rt_bwd_g_scratch`` of ``lib`` (default the package's library)
    sizes it: (zeroed int32 counters, the tickets' then, banded and
    compact, one per column tile; banded's cloud-fraction (compact's cw)
    shares (float32) where they do not fit shared memory, or None)."""
    n = (ctypes.c_int * 3)()
    lib = lib or _build.library()
    lib.rrtm_rt_bwd_g_scratch(MODES[mode], int(L), int(B),
                              ctypes.cast(n, ctypes.c_void_p))
    part = n[1] * n[2]
    return (torch.zeros(n[0], dtype=torch.int32, device=device),
            torch.empty(part, dtype=torch.float32, device=device)
            if part else None)


def rt_sweep_banded_vjp(taut_t, fracs_t, planklay_t, planklev_t, surf,
                        cldf_t, taucb_t, ngb0, wg, ct, needs=(True,) * 7,
                        rads=None, ct_ddt=None):
    """K6 in the banded mode (csrc/rtrn_bwd_g.cu): flux cotangents ct
    (4, L+1, B) -> cotangents of (taut_t, fracs_t, planklay_t,
    planklev_t, surf (3, 16, B), cldf_t (L, B), taucb_t (L, 16, B)),
    None where ``needs`` is False.  ``ct_ddt``: as ``rt_sweep_vjp``'s
    (counted in ``DDT_LAUNCHES["banded"]``).  On the card it reads
    ``rads``, the radiances K1 kept on the same inputs
    (``rt_sweep_g_radiances``), and raises without them; the plain vjp
    (CPU tensors, ``rtrn.rt_sweep_banded_vjp``) does not read them."""
    x = (taut_t, fracs_t, planklay_t, planklev_t, surf)
    if taut_t.device.type == "cpu":
        return rtrn.rt_sweep_banded_vjp(
            *x, cldf_t, taucb_t, ngb0, wg,
            ct if ct_ddt is None else _full_ct(ct, ct_ddt), needs)
    return _launch_bwd_g("banded", (rt_sweep_banded_vjp,), x,
                         (cldf_t, taucb_t), ngb0, wg, ct, needs, rads,
                         ct_ddt=ct_ddt)


def rt_sweep_g_vjp(taut_t, fracs_t, planklay_t, planklev_t, surf, fields,
                   ngb0, wg, ct, needs=None, rads=None, words=None,
                   ct_ddt=None):
    """K6 in the fused or cldf-odcld mode (csrc/rtrn_bwd_g.cu; the mode
    by the number of per-g ``fields``, as ``rtrn.rt_sweep_blocked``'s):
    flux cotangents ct (4, L+1, B) -> cotangents of (taut_t, fracs_t,
    planklay_t, planklev_t, surf (3, 16, B), *fields), the pad rows
    140-143 of the (L, 144, B) ones zero, None where ``needs`` (default
    all) is False.  On the card it reads ``rads`` and ``words``, the
    radiances and cloudy-layer words K1 kept on the same inputs
    (``rt_sweep_g_radiances``), and raises without them; the plain vjp
    (CPU tensors, ``rtrn.rt_sweep_g_vjp``) does not read them.  Counted in
    ``.launches`` and in ``.fused.launches`` or ``.cldf_od.launches``;
    with ``ct_ddt`` (as ``rt_sweep_vjp``'s) in ``DDT_LAUNCHES[mode]``."""
    x = (taut_t, fracs_t, planklay_t, planklev_t, surf)
    fields = tuple(fields)
    if needs is None:
        needs = (True,) * (5 + len(fields))
    if taut_t.device.type == "cpu":
        return rtrn.rt_sweep_g_vjp(
            *x, fields, ngb0, wg,
            ct if ct_ddt is None else _full_ct(ct, ct_ddt), needs)
    mode = {6: "fused", 2: "cldf_od"}[len(fields)]
    return _launch_bwd_g(mode, (rt_sweep_g_vjp, getattr(rt_sweep_g_vjp,
                                                        mode)),
                         x, fields, ngb0, wg, ct, needs, rads, words,
                         ct_ddt)


K1_INFO = ("registers", "local_bytes", "static_smem", "dynamic_smem",
           "blocks_per_sm", "ring_levels", "threads", "columns")


def _launch_info(entry, *args):
    """``K1_INFO`` -> int of the instantiation that entry point ``entry``
    selects by ``args``, from the CUDA runtime."""
    buf = (ctypes.c_int * len(K1_INFO))()
    lib = _build.library()
    err = getattr(lib, entry)(*args, ctypes.cast(buf, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{entry}: " + lib.rrtm_error_string(err).decode())
    return dict(zip(K1_INFO, buf))


# the store paths of K1's gradient-step launch (csrc/rtrn_kernel.cuh enum
# Save): bulk tensor stores from shared memory, scalar stores
SAVE_PATHS = {"scalar": 1, "bulk": 2}


def k1_info(mode, idrv, spec_dtype=torch.float32, save=None):
    """K1's launch configuration in ``mode`` (a ``MODES`` key) at idrv
    0/1 with taut in ``spec_dtype`` (``save``: a ``SAVE_PATHS`` key, the
    instantiation that keeps the radiances by that store path, float32
    only): ``K1_INFO`` -> int, from the CUDA runtime
    (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the card."""
    return _launch_info("rrtm_rt_info", MODES[mode], int(idrv),
                        SPEC_CODES[spec_dtype],
                        SAVE_PATHS[save] if save else 0)


def k1_save_path(mode):
    """The store path (a ``SAVE_PATHS`` key) of the last launch of K1
    keeping the radiances in ``mode`` in this process, or None; needs the
    card."""
    code = _build.library().rrtm_rt_save_path(MODES[mode])
    return {v: k for k, v in SAVE_PATHS.items()}.get(code)


def k6_info(cloudy, ddt=False):
    """K6's launch configuration, clear or compact (``cloudy``; ``ddt``:
    its instantiation with the d/dT sweep's adjoint, clear's alone:
    compact's is ``k6_g_info("compact", nlay, ddt=True)``): ``K1_INFO``
    -> int, as ``k1_info``; needs the card."""
    return _launch_info("rrtm_rt_bwd_ddt_info" if ddt else "rrtm_rt_bwd_info",
                        int(cloudy))


def _layout(entry, *args):
    """The tile and band groups an adjoint of them reports
    (``rrtm_rt_bwd_g_layout``, ``rrtm_rt_bwd_mr_layout``): -> the raw
    ints and the number of groups."""
    buf = (ctypes.c_int * 16)()
    lib = _build.library()
    err = getattr(lib, entry)(*args, ctypes.cast(buf, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{entry}: " + lib.rrtm_error_string(err).decode())
    return list(buf), buf[2]


def k6_mr_info(nlay=60, ddt=False):
    """K6's launch configuration in the maxrand mode at ``nlay`` layers
    (its shared memory grows with them; ``ddt``: its instantiation with
    the d/dT sweep's adjoint): ``K1_INFO`` -> int
    (``ring_levels``: the slots of its ring), as ``k1_info``, and from
    ``rrtm_rt_bwd_mr_layout``: ``box_rows``, ``groups``, ``staging`` as
    ``k6_g_info``'s and ``share_floats`` (of a band group's share of a
    (layer, column) of the overlap rows' cotangents, in the launch's
    scratch, ``k6_mr_scratch``); needs the card."""
    info = _launch_info("rrtm_rt_bwd_mr_ddt_info" if ddt
                        else "rrtm_rt_bwd_mr_info", int(nlay))
    buf, ngrp = _layout("rrtm_rt_bwd_mr_layout")
    info.update(box_rows=buf[1], groups=tuple(buf[3:4 + ngrp]),
                staging={1: "tma", 0: "elements"}.get(buf[4 + ngrp]),
                share_floats=buf[5 + ngrp])
    return info


def k6_g_info(mode, nlay=60, ddt=False):
    """K6's launch configuration in the banded, fused or cldf-odcld
    ``mode`` at ``nlay`` layers (its shared memory grows with them;
    ``ddt``: its instantiation with the d/dT sweep's adjoint, also in the
    compact mode, which has no other on this tile):
    ``K1_INFO`` -> int (``ring_levels``: the slots of its ring), as
    ``k1_info``, and from ``rrtm_rt_bwd_g_layout``: ``box_rows`` (of a
    bulk copy's box), ``groups`` (the first band of each band group, then
    16), ``staging`` (of the mode's last launch in this process: "tma",
    "elements" or None) and ``shares_in_smem`` (banded: its cloud-fraction
    shares in shared memory at ``nlay``, else in a scratch; compact: cw's;
    None in the other modes); needs the card."""
    info = _launch_info("rrtm_rt_bwd_g_ddt_info" if ddt
                        else "rrtm_rt_bwd_g_info", MODES[mode], int(nlay))
    buf, ngrp = _layout("rrtm_rt_bwd_g_layout", MODES[mode], int(nlay))
    staged, shares = buf[4 + ngrp], buf[5 + ngrp]
    info.update(box_rows=buf[1], groups=tuple(buf[3:4 + ngrp]),
                staging={1: "tma", 0: "elements"}.get(staged),
                shares_in_smem=None if shares < 0 else bool(shares))
    return info


for _w in WRAPPERS.values():
    _w.launches = 0
    _w.idrv = _build.Launches()
    _w.spec = _build.Launches()
    _w.save = _build.Launches()
rt_sweep_vjp.launches = 0
rt_sweep_maxrand_vjp.launches = 0
rt_sweep_banded_vjp.launches = 0
rt_sweep_g_vjp.launches = 0
rt_sweep_g_vjp.fused = _build.Launches()
rt_sweep_g_vjp.cldf_od = _build.Launches()
