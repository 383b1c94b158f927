"""Mesh-global validation / monitoring reductions.

Port of ``rrtmg_lw_tpu.parallel.metrics`` (``:23-72``).  The forward
physics needs no communication between columns; what crosses ranks is
metric reduction.  Each rank reduces its column shard of ``Fluxes`` to
sums, counts, minima and maxima, and three ``all_reduce`` calls over the
columns group (SUM, MIN, MAX) combine them: means are global sums over
the global count (never the mean of the ranks' means: shards may differ
in size), ``uflx_rms`` the square root of the global mean square.  The
scalars are 0-d tensors on the fluxes' device, identical on every rank.

The accuracy norms mirror the reference's regression contract: max-abs
flux difference in W/m2 and max-abs heating-rate difference in K/day
against a reference solution (flux <= 0.5 W/m2, heating rate <= 0.1
K/day).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _reduce(mesh, sums, mins, maxs):
    """All-reduce the stacked local sums (SUM), minima (MIN) and maxima
    (MAX) over ``mesh``'s columns group (None or no group: local)."""
    out = [torch.stack(v) for v in (sums, mins, maxs)]
    if mesh is not None and mesh.group is not None:
        for t, op in zip(out, (dist.ReduceOp.SUM, dist.ReduceOp.MIN,
                               dist.ReduceOp.MAX)):
            dist.all_reduce(t, op=op, group=mesh.group)
    return out


def _amin(x):
    return x.min() if x.numel() else x.new_tensor(float("inf"))


def _amax(x):
    return x.max() if x.numel() else x.new_tensor(-float("inf"))


def _stats(fl, ref=None, mesh=None):
    olr = fl.uflx[:, -1]
    net_toa = fl.uflx[:, -1] - fl.dflx[:, -1]
    net_sfc = fl.uflx[:, 0] - fl.dflx[:, 0]
    n = olr.new_tensor(float(olr.shape[0]))
    sums = [n, olr.sum(), fl.dflx[:, 0].sum(), (net_toa - net_sfc).sum()]
    mins = [_amin(olr), _amin(fl.hr)]
    maxs = [_amax(olr), _amax(fl.hr)]
    if ref is not None:
        du = fl.uflx - ref.uflx
        sums.append((du ** 2).sum())
        maxs += [_amax(du.abs()), _amax((fl.dflx - ref.dflx).abs()),
                 _amax((fl.hr - ref.hr).abs())]
    s, lo, hi = _reduce(mesh, sums, mins, maxs)
    out = {
        "ncol": s[0],
        "olr_mean": s[1] / s[0], "olr_min": lo[0], "olr_max": hi[0],
        "sfc_dflx_mean": s[2] / s[0],
        "col_divergence_mean": s[3] / s[0],
        "hr_min": lo[1], "hr_max": hi[1],
    }
    if ref is not None:
        out.update(uflx_maxabs=hi[2], dflx_maxabs=hi[3], hr_maxabs=hi[4],
                   uflx_rms=torch.sqrt(s[4] / (s[0] * fl.uflx.shape[1])))
    return out


def flux_stats(fl, mesh=None):
    """Global summary scalars of the Fluxes shards of ``mesh``'s ranks
    (of ``fl`` alone without a mesh): column count, OLR (TOA upward flux)
    mean/min/max, surface downward flux mean, mean column radiative
    divergence (net TOA minus net surface, W/m2), and the extreme heating
    rates — the quantities a production monitor watches."""
    return _stats(fl, mesh=mesh)


def flux_error_norms(fl, ref, mesh=None):
    """Validation norms of ``fl`` against a reference ``Fluxes`` (max-abs
    over all columns and levels, and the uflx RMS)."""
    out = _stats(fl, ref, mesh)
    return {k: out[k] for k in ("uflx_maxabs", "dflx_maxabs", "hr_maxabs",
                                "uflx_rms")}


def make_metrics_fn(mesh, with_reference: bool = False):
    """Mesh-global metrics: this rank's Fluxes shard (and the reference's
    same columns) in, the global scalars out on every rank."""
    if with_reference:
        return lambda fl, ref: _stats(fl, ref, mesh)
    return lambda fl: _stats(fl, mesh=mesh)
