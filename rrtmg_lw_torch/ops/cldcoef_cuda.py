"""Cloud particle-size coefficient kernel (K4) and its backward (K4b),
csrc/cldcoef.cu.

K4 replaces ``rrtmg_lw_tpu/ops/cldcoef_pallas.py::_build.kernel``; K4b
the XLA autodiff of the JAX package's ``_ice_liq_coeffs``
(rrtmg_lw_tpu/ops/cldprop.py:43), through which the JAX model
differentiates the effective radii (cldcoef_pallas.py has no vjp).
``CldCoefFn`` pairs them for autograd; the tables get no gradient.  On a
CUDA tensor each wrapper launches its kernel (or raises); on a CPU tensor
it runs the plain versions, ``cldprop.ice_liq_coeffs_blocked`` and
``cldprop.ice_liq_coeffs_vjp``.
"""

from __future__ import annotations

import torch

from .. import _build
from . import cldprop


def _check(reic, relq, iceflag, liqflag, tables):
    """-> (L, B, nmax, ice table, liquid table) of a kernel call."""
    if not cldprop.tabulated(iceflag, liqflag):
        raise NotImplementedError(
            f"K4 interpolates the tables of iceflag 2/3 with liqflag 1, "
            f"not iceflag={iceflag}, liqflag={liqflag}: the closed forms "
            "run in plain PyTorch on every device "
            "(cldprop.ice_liq_coeffs_blocked)")
    name, _, nmax = cldprop._ice_params(iceflag)
    B, L = reic.shape
    dev = reic.device
    _build.check(reic, "reic", torch.float32, (B, L), dev)
    _build.check(relq, "relq", torch.float32, (B, L), dev)
    ice, liq = tables[name], tables["absliq1"]
    _build.check(ice, name, torch.float32, (nmax, 16), dev)
    _build.check(liq, "absliq1", torch.float32, (58, 16), dev)
    return L, B, nmax, ice, liq


class CldCoefFn(torch.autograd.Function):
    """(reic, relq (B, L), iceflag, liqflag, tables) -> abi, abl
    (L, 16, B); backward K4b to reic and relq."""

    @staticmethod
    def forward(ctx, reic, relq, iceflag, liqflag, tables):
        ctx.args = (iceflag, liqflag, tables)
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(reic, relq)
        if reic.device.type == "cpu":
            return cldprop.ice_liq_coeffs_blocked(reic, relq, iceflag,
                                                  liqflag, tables)
        L, B, nmax, ice, liq = _check(reic, relq, iceflag, liqflag, tables)
        abi = torch.empty((L, 16, B), dtype=torch.float32,
                          device=reic.device)
        abl = torch.empty_like(abi)
        _build.launch("rrtm_cldcoef", reic.t().contiguous(),
                      relq.t().contiguous(), ice, liq, abi, abl, nmax, L, B)
        ice_liq_coeffs_blocked.launches += 1
        return abi, abl

    @staticmethod
    def backward(ctx, ct_abi, ct_abl):
        reic, relq = ctx.saved_tensors
        zero = torch.zeros((reic.shape[1], 16, reic.shape[0]),
                           dtype=reic.dtype, device=reic.device)
        g = ice_liq_coeffs_vjp(reic, relq, *ctx.args,
                               zero if ct_abi is None else ct_abi.contiguous(),
                               zero if ct_abl is None else ct_abl.contiguous())
        return (*(x if n else None for x, n in zip(g, ctx.needs_input_grad)),
                None, None, None)


def ice_liq_coeffs_blocked(reic, relq, iceflag, liqflag, tables):
    """(B, L) effective radii -> per-band ice and liquid absorption
    coefficients abi, abl (L, 16, B); tables hold absice2/absice3 and
    absliq1 tensors.  iceflag 2/3 with liqflag 1 only (``cldprop.
    tabulated``; the model takes the closed forms to the plain
    version)."""
    return CldCoefFn.apply(reic, relq, iceflag, liqflag, tables)


def ice_liq_coeffs_vjp(reic, relq, iceflag, liqflag, tables, ct_abi,
                       ct_abl):
    """K4b: ct_abi, ct_abl (L, 16, B) -> the cotangents of reic and relq
    (B, L); on a CPU tensor the plain version,
    ``cldprop.ice_liq_coeffs_vjp``."""
    if reic.device.type == "cpu":
        return cldprop.ice_liq_coeffs_vjp(reic, relq, iceflag, liqflag,
                                          tables, ct_abi, ct_abl)
    L, B, nmax, ice, liq = _check(reic, relq, iceflag, liqflag, tables)
    for t, name in ((ct_abi, "ct_abi"), (ct_abl, "ct_abl")):
        _build.check(t, name, torch.float32, (L, 16, B), reic.device)
    ct_r = torch.empty((2, L, B), dtype=torch.float32, device=reic.device)
    _build.launch("rrtm_cldcoef_bwd", reic.t().contiguous(),
                  relq.t().contiguous(), ice, liq, ct_abi, ct_abl, ct_r[0],
                  ct_r[1], nmax, L, B)
    ice_liq_coeffs_vjp.launches += 1
    return ct_r[0].t(), ct_r[1].t()


ice_liq_coeffs_blocked.launches = 0
ice_liq_coeffs_vjp.launches = 0
