"""Cloud particle-size coefficient kernel (K4), csrc/cldcoef.cu.

Replaces ``rrtmg_lw_tpu/ops/cldcoef_pallas.py::_build.kernel``.  On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``cldprop.ice_liq_coeffs_blocked``.

The kernel has no backward: the effective radii are not differentiated
on the port's gradient path (the JAX package differentiates only the
Atmosphere, and cldcoef_pallas.py has no custom_vjp), so a CUDA call
whose radii require grad raises instead of handing back a constant.
"""

from __future__ import annotations

import torch

from .. import _build
from . import cldprop


def ice_liq_coeffs_blocked(reic, relq, iceflag, liqflag, tables):
    """(B, L) effective radii -> per-band ice and liquid absorption
    coefficients abi, abl (L, 16, B); tables hold absice2/absice3 and
    absliq1 tensors.  iceflag 2/3 with liqflag 1 only."""
    if reic.device.type == "cpu":
        return cldprop.ice_liq_coeffs_blocked(reic, relq, iceflag, liqflag,
                                              tables)
    if torch.is_grad_enabled() and (reic.requires_grad
                                    or relq.requires_grad):
        raise NotImplementedError(
            "gradients with respect to the effective radii (reic, relq) "
            "through the cloud-coefficient kernel are not ported yet; see "
            "ROADMAP.md Queue 1, gradients through the other forward "
            "paths on the card")
    name, _, nmax = cldprop._ice_params(iceflag)
    cldprop._check_liqflag(liqflag)
    B, L = reic.shape
    dev = reic.device
    _build.check(reic, "reic", torch.float32, (B, L), dev)
    _build.check(relq, "relq", torch.float32, (B, L), dev)
    ice, liq = tables[name], tables["absliq1"]
    _build.check(ice, name, torch.float32, (nmax, 16), dev)
    _build.check(liq, "absliq1", torch.float32, (58, 16), dev)
    abi = torch.empty((L, 16, B), dtype=torch.float32, device=dev)
    abl = torch.empty_like(abi)
    _build.launch("rrtm_cldcoef", reic.t().contiguous(),
                  relq.t().contiguous(), ice, liq, abi, abl, nmax, L, B)
    ice_liq_coeffs_blocked.launches += 1
    return abi, abl


ice_liq_coeffs_blocked.launches = 0
