#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (``rrtmg_lw_torch``).

Run from the repository root on a machine with one CUDA GPU (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels from csrc/ (one nvcc per source, in
     parallel), timed, with the registers and spills ptxas reports; for
     each of K1's 52 instantiations (48, and the 4 of the gradient step
     that keep the radiances for K6, which must not spill) its registers
     and spill stores, its shared memory per block, blocks per SM (the
     CUDA occupancy API) and levels in its ring, the same (but the ring)
     for K2's 4, K6's registers and spill stores, and K5's registers,
     spill stores, local memory, shared memory and blocks per SM (it must
     not spill and must fit its MIN_BLOCKS launch bound);
  3. each kernel against its plain PyTorch version on the card at the
     main-path shapes (B=16384 columns, L=60 layers, float32), with the
     max error and CUDA-event times of both and the bound of each (the
     larger of its bytes over the HBM rate and its operations over the
     f32 rate); K2 also in all four storages on its edge cases
     (utils/snapshot.py k2_edge_args: one column, widths off its block,
     one layer, columns all lower, all upper or switching at laytrop,
     rows clipped at the table's last row, minor gases on both sides of
     their over-abundance threshold), float32 within TOL_TAUMOL of plain,
     bins equal, the 16-bit storages equal to the encode of its float32
     output (logu16 codes +-1); the RT sweep in all six modes (clear/compact, banded,
     maxrand, fused on McicaCloudsBlocked, cldf-odcld on the same clouds
     with an input cloud od) and each at idrv=1, and the overlap rows,
     each also bitwise equal over two runs, the idrv=1 flux rows bitwise
     equal to idrv=0's; the deterministic-cloud modes on make_band_clouds
     and on a cloud field whose fractions vary inside cloudy blocks; K1's
     48 instantiations (6 modes x idrv x 4 storages) on its edge cases
     (utils/snapshot.py k1_edge_args: clear, overcast and
     top-and-bottom-cloudy columns in runs across the 16-column tiles,
     per-g cloud fractions in (0, 0.5), the g-point od exactly 0.06 and
     0), each within TOL_FLUX of plain, bitwise over two runs, the idrv=1
     flux rows bitwise equal to idrv=0's; then
     reduced spectral storage (K7, RRTMG_SPEC_DTYPE): K2 in bf16, f16 and
     logu16 against the plain encode of K2's own float32 output (bf16 /
     f16 bitwise, logu16 codes equal or one apart, the share printed) and
     of the plain K2's (at most one step apart), and K1 in all 6 modes x
     idrv 0/1 x those 3 storages against the plain decode + aerosol add +
     sweep on the same codes, within TOL_FLUX and bitwise over two runs,
     on a seeded aerosol od that a dropped add, or one read at other
     bands, layers or columns, would fail (each fault must leave
     TOL_FLUX);
  4. end to end, cell by cell: clear sky and McICA (compact int8-mask
     clouds), deterministic clouds (BandClouds, imca=0) band_cloudy
     (icld=1) and maxrand_cloudy (icld=2), McICA per-g clouds
     (mcica_blocked, inflag=2: K1 fused; mcica_tauc, inflag=0: K1
     cldf-odcld), and clear, McICA and maxrand at idrv=1, 3 steps each
     through the kernels; one step each of icld=3 and of the banded,
     fused and cldf-odcld paths at idrv=1; for each cell the launch
     counters are set to 0 just before and read just after, and every
     kernel must have launched exactly as often as that cell's path does
     (0 for the others); fluxes (and duflx_dt / duflxc_dt at idrv=1) held
     against the same model run with impl="eager" on the card; then one
     from_profile step with Profile.dtbound set and one float-mask
     McicaCloudsCompact step (K1 fused), each against eager; then the
     reduced-storage cells, counted the same way: clear and McICA in
     logu16 (3 steps each), one step of McICA in bf16 and in f16 and of
     the banded, maxrand, fused and cldf-odcld paths in logu16, on an
     atmosphere with aerosol, each sweep receiving taug in storage and
     the nonzero aerosol od apart, each step
     held to the eager model with the same storage and to the float32
     step (logu16 within TOL_TAUMOL of max |flux|; bf16 / f16 printed);
     peak memory of a clear and a McICA step, float32 against logu16;
  5. deep: one McICA step at L=140 with the same checks;
  6. grad: each backward kernel (K3b Planck slope, K5 taumol, K6 RT
     adjoint) against the plain vjp of its forward's plain version on the
     phase-3 tensors (B=16384, L=60), errors, bitwise repeat and times;
     K6 clear and compact, there and on K1's edge cases, fed the
     radiances of K1's gradient-step launch on the same tensors, whose
     fluxes must be bitwise those of K1's launch without them and whose
     radiances within TOL_RADS of the plain sweep's; K6 without them
     must raise;
     then the gradient step (make_grad_step, the default loss, w.r.t.
     every Atmosphere field) at B=16384, L=60 through the kernels: McICA,
     3 timed steps with the launch counters reset just before and read
     just after (K1 keeping the radiances once a step, and never in a
     forward cell), peak memory; its gradients of a column-sum loss, linear
     in the four flux arrays with seeded cotangents, held on all 16384
     columns against the eager step's (run in column chunks); clear sky,
     1 step, the same check; the McICA step at idrv=1 bitwise equal to
     idrv=0's, and a cotangent of duflx_dt or a backward through the
     fused mode raising NotImplementedError; a logu16 grad step raising
     NotImplementedError on both impls;
  7. probes (utils/probes.py, the archived Pallas probes' counterparts):
     the one-hot selection product (bf16 and exact, dout 128 and 1656)
     and the row gather bitwise equal to tbl[idx], their rates, the
     launch latency and the 4096^3 matmul rates.
The last two lines of stdout are the kernels' JSON summary and
{"ok": true, "device": {...}}.  Each entry of the summary carries
bytes_once (the bytes behind bound_ms); K1's and K2's entries
(K1_LINES, K2_LINES) also device_ms (the profiler's kernel time; ms,
CUDA events around the wrapper, holds its host gaps too), their
instantiation's registers, spill bytes, shared memory, blocks per SM
(K1: and ring levels) and achieved GB/s (bytes_once over device_ms),
"rt_sweep" the table of all 52 K1 instantiations; K6's entry
(rt_adjoint) its registers, spill bytes, device_ms and GB/s, and K5's
(taumol_bwd) the same with its shared memory and blocks per SM; K5's
bound counts its operations and cotangent bytes per (band, region)
(``taumol_bwd_work``).
K5's, K6's and K1 SAVE's device_ms come from ``utils/snapshot.py
--k5-times --k6-times`` in a process of its own, started after phase
3.  Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

# the width and depths of utils/profiling.py's cells, whose inputs these are
B_MAIN, L_MAIN, L_DEEP, STEPS = 16384, 60, 140, 3
B_CHUNK = 4096             # columns per eager grad step in the step check
# tolerances of the TPU port's on-chip gates (tools/tpu_verify.py:97,
# ROADMAP.md:17), kept
TOL_TABLE = 1e-6        # K3, K4: max |kernel - plain| / max |plain|
TOL_TAUMOL = 3.05e-5    # K2: taug relative (|ref| floored at 1e-2), fracs abs
TOL_FLUX = 2e-5         # K1 / model: per column, / max(max |flux|, 1)
# backward kernels against their plain vjps: the same f32 math summed in
# another order, / max |plain| per output (K6: a recurrence over levels)
TOL_BWD, TOL_BWD_RT = 1e-4, 1e-3
# K1's kept radiances against the plain sweep's, / max |plain| (the
# recurrence that TOL_FLUX holds summed over g, per g-point)
TOL_RADS = 1e-5
# the grad step against the eager one, per Atmosphere field / max |eager|,
# for a loss linear in the fluxes: f32 against f64 on the CPU reads
# <= 1.1e-5 (tests/test_torch_grad.py::test_f32_gradient_conditioning)
TOL_STEP = 1e-4
# overlap rows against their plain version: the discrete rows (0-3) equal,
# the factor rows within this share of max |plain| (the same elementwise
# f32 arithmetic; expected bitwise)
TOL_ROWS = 1e-6

# the bound of a kernel: the larger of its bytes (each input read once,
# each output written once) over the H100 SXM's HBM rate and its
# operations over its f32 rate outside the tensor cores (NVIDIA's data
# sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12      # dense bf16 on the tensor cores
# operations per element of the main loop, estimated from the kernel
# sources (add, multiply, compare, select, expf and division one each),
# rounded up: per (layer, g, column) for taumol and the RT sweeps
# (down + up sweep; the cloud terms only in a cloudy layer), per output
# element for Planck and the cloud coefficients, per (layer, column) for
# the overlap rows; spec_codec per logu16 encode or decode (log or exp,
# clip, round)
OPS = dict(taumol=60, planck=8, cldcoef=10, rt_clear=60, rt_cloud=40,
           rt_maxrand=60, overlap=100, planck_bwd=8, rt_adjoint=270,
           rt_ddt=10, spec_codec=10)
# K5's operations, counted from csrc/taumol_bwd.cu per term of each
# (band, region)'s structure (add, subtract, multiply one each; a product
# two sums share once).  Per g-point: the cotangent's rescale and its
# correction; per key tap, both pressure rows; tau and the speccomb sums
# of a key species; a continuum (self or foreign); an eta / plain minor
# gas; a CFC; the correction's sum; the fraction's eta row.  Per (cell,
# band), outside the g-loop: the rest of setup and chain-back; an eta
# interpolation and its backward; the 4-tap weights and their
# derivatives; one key tap's clamped rows; an over-abundance adjustment
# (its three powf ~10 each).
K5_G_OPS = dict(post=1, corr=3, tap=24, key=7, cont=9, minor_eta=22,
                minor=10, cfc=4, frac=3)
K5_BAND_OPS = dict(base=30, eta=20, weights=48, tap=12, adj=45)

K1_SRC = "rrtmg_lw_torch/csrc/rtrn_kernel.cuh"
KERNELS = (  # name, source, replaced TPU kernel
    ("taumol", "rrtmg_lw_torch/csrc/taumol.cu",
     "rrtmg_lw_tpu/ops/taumol_pallas.py:1068"),
    ("planck", "rrtmg_lw_torch/csrc/planck.cu",
     "rrtmg_lw_tpu/ops/planck_pallas.py:47"),
    ("cldcoef", "rrtmg_lw_torch/csrc/cldcoef.cu",
     "rrtmg_lw_tpu/ops/cldcoef_pallas.py:43"),
    ("rt_sweep", K1_SRC, "rrtmg_lw_tpu/ops/rtrn_pallas.py:140"),
    ("rt_sweep_clear", K1_SRC, "rrtmg_lw_tpu/ops/rtrn_pallas.py:140"),
    ("taumol_bwd", "rrtmg_lw_torch/csrc/taumol_bwd.cu",
     "rrtmg_lw_tpu/ops/taumol_pallas.py:1116"),
    ("planck_bwd", "rrtmg_lw_torch/csrc/planck.cu",
     "rrtmg_lw_tpu/ops/planck_pallas.py:137"),
    ("rt_adjoint", "rrtmg_lw_torch/csrc/rtrn_bwd.cu",
     "rrtmg_lw_tpu/ops/rtrn_bwd.py:259"),
    # K1's gradient-step launch, which keeps the radiances K6 reads
    ("rt_sweep_save", K1_SRC, "rrtmg_lw_tpu/ops/rtrn_pallas.py:140"),
    ("rt_sweep_banded", K1_SRC, "rrtmg_lw_tpu/ops/rtrn_pallas.py:140"),
    ("rt_sweep_maxrand", K1_SRC, "rrtmg_lw_tpu/ops/rtrn_pallas.py:140"),
    ("overlap_rows", "rrtmg_lw_torch/csrc/overlap.cu",
     "rrtmg_lw_tpu/ops/rtrn_pallas.py:1155"),
) + tuple((name, K1_SRC, "rrtmg_lw_tpu/ops/rtrn_pallas.py:140") for name in (
    "rt_sweep_fused", "rt_sweep_cldf_od", "rt_sweep_idrv",
    "rt_sweep_banded_idrv", "rt_sweep_maxrand_idrv", "rt_sweep_fused_idrv",
    "rt_sweep_cldf_od_idrv")) + (
    # K7, the spectral codec: K2's store and K1's reads in logu16 storage
    ("taumol_spec", "rrtmg_lw_torch/csrc/taumol.cu",
     "rrtmg_lw_tpu/ops/taumol_pallas.py:867"),
    ("rt_sweep_spec", K1_SRC, "rrtmg_lw_tpu/ops/rtrn_pallas.py:260"),
    # the archived probes
    ("probe_onehot", "rrtmg_lw_torch/csrc/probes.cu",
     "tools/archive/calib.py:31"),
    ("probe_gather", "rrtmg_lw_torch/csrc/probes.cu",
     "tools/archive/test_pallas_gather.py:17"))


def need(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    need(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps=5, symbol="rt_kernel"):
    """Mean device ms of one launch of the kernel whose symbol holds
    ``symbol`` (torch.profiler, kernel time alone; default K1) over
    ``reps`` calls after one warm-up (``utils.snapshot.kernel_ms``): the
    wrapper's CUDA events also hold the host gaps between its launches."""
    from rrtmg_lw_torch.utils.snapshot import kernel_ms
    return kernel_ms(fn, symbol, reps)


def bound(inputs, outputs, ops, nbytes=0, ops_rate=F32_OPS_PER_S,
          library_ms=None):
    """bound_ms, bound_by and library_ms (None: no one PyTorch call
    computes the kernel's function) of a kernel that reads ``inputs`` and
    writes ``outputs`` (tensors, None skipped), moves ``nbytes`` more and
    does ``ops`` operations at ``ops_rate``."""
    nbytes += sum(t.numel() * t.element_size()
                  for t in (*inputs, *outputs) if t is not None)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms, bytes_once=nbytes)


def taumol_bwd_work(desc, ifld):
    """K5's operations (``K5_G_OPS``, ``K5_BAND_OPS``) and the bytes of
    the float32 cotangents it needs, on packed int fields ``ifld`` (NI,
    L, B) with descriptors ``desc`` (16, 2, NDESC): each (band, region)'s
    count times the cells in that region.  A region's ct_taug rows are
    needed unless its taug is zero, its ct_fracs rows only where its
    fractions depend on the cell (FRAC_ETA): -> (ops, bytes)."""
    from rrtmg_lw_torch.ops.taumol_cuda import _D
    desc = desc.cpu().numpy()
    n_lower = int(ifld[0].sum())
    cells = (n_lower, ifld[0].numel() - n_lower)
    g, s = K5_G_OPS, K5_BAND_OPS
    total = nbytes = 0
    for band in desc:
        for d, n in zip(band, cells):
            w = {k: int(d[i]) for k, i in _D.items()}
            if w["ZERO"]:
                continue
            nbytes += 4 * n * w["NGB"] * (1 + w["FRAC_ETA"])
            key = w["KEY1"] >= 0
            ntap = 4 if w["ETA4"] else 2
            kinds = [w[f"M{i}_KIND"] for i in range(w["NMINOR"])]
            per_g = (g["post"] * (w["POST_OFF"] >= 0)
                     + g["corr"] * (w["CORR"] != 0)
                     + key * (ntap * g["tap"] + g["key"])
                     + g["cont"] * ((w["SELF_OFF"] >= 0)
                                    + (w["FOR_OFF"] >= 0))
                     + sum(g["minor_eta"] if k else g["minor"]
                           for k in kinds)
                     + g["cfc"] * w["NCFC"] + g["frac"] * w["FRAC_ETA"])
            etas = 2 * (w["KEY2"] >= 0) + sum(kinds) + w["FRAC_ETA"]
            adj = sum(w[f"M{i}_ADJ_GAS"] >= 0 for i in range(len(kinds)))
            setup = (s["base"] + s["eta"] * etas + s["weights"] * w["ETA4"]
                     + s["tap"] * key * ntap + s["adj"] * adj)
            total += n * (w["NGB"] * per_g + setup)
    return total, nbytes


def flux_err(a, b):
    """max over columns of max |a - b| / max(max |a|, 1), for (.., B)
    arrays with columns last."""
    a, b = a.double(), b.double()
    diff = (a - b).abs().flatten(0, -2).amax(0)
    scale = a.abs().flatten(0, -2).amax(0).clamp(min=1.0)
    return float((diff / scale).max())


def inputs(cell, device, aod=None):
    """The synthetic inputs of ``cell`` (utils/profiling.py's
    ``cell_inputs``), with the aerosol od ``aod`` (default the cell's)."""
    from rrtmg_lw_torch.utils.profiling import cell_inputs
    return cell_inputs(cell, device, aod)


def mixed_clouds(bc, device):
    """``bc`` with random fractions in half the (column, layer) cells, so
    they rise and fall inside cloudy blocks; every third column clear,
    every fifth overcast; liquid where cloudy, ice above fraction 0.5."""
    gen = torch.Generator(device=device).manual_seed(3)
    shape = bc.cldfrac.shape
    cf = (torch.rand(shape, generator=gen, device=device)
          * (torch.rand(shape, generator=gen, device=device) < 0.5))
    cf[::3] = 0.0
    cf[1::5] = 1.0
    zero = torch.zeros_like(cf)
    return bc._replace(cldfrac=cf, clwp=torch.where(cf > 0, 20.0, zero),
                       ciwp=torch.where(cf > 0.5, 5.0, zero))


def phase_kernels(device):
    """Each kernel vs its plain version at the main-path shapes."""
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops import cldprop, rtrn, rtrnmr
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.planck_cuda import planck_interp_blocked
    from rrtmg_lw_torch.ops.rtrn_cuda import (rt_fluxes_banded,
                                              rt_fluxes_blocked,
                                              rt_fluxes_maxrand)
    from rrtmg_lw_torch.ops.rtrnmr_cuda import overlap_rows
    from rrtmg_lw_torch.ops.setcoef import interp_planck_blocked, setcoef
    from rrtmg_lw_torch.ops.taumol_cuda import (NBIN, _pack_inputs,
                                                taumol_blocked)

    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False, impl="cuda"), device=device)
    atm, clouds = inputs("mcica_cloudy", device)
    prof = inatm(atm, dtype=torch.float32)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    res = {}

    # K2 taumol, with the eta bins both versions used
    bins_k = torch.empty((16, NBIN, L_MAIN, B_MAIN), dtype=torch.int32,
                         device=device)
    tg_k, fr_k = taumol_blocked(sc, prof, model.engine, model.kernel_tabs,
                                model.kernel_desc, bins=bins_k)
    tg_p, fr_p = model.engine.blocked(sc, prof)
    bins_p = model.engine.bins(sc, prof)
    nbad = int((bins_k != bins_p).sum())
    need(nbad == 0, f"taumol: {nbad} interpolation bins differ")
    e_t = float(((tg_k.double() - tg_p.double()).abs()
                 / tg_p.double().abs().clamp(min=1e-2)).max())
    e_f = float((fr_k - fr_p).abs().max())
    need(torch.isfinite(tg_k).all() and torch.isfinite(fr_k).all(),
         "taumol: non-finite output")
    need(e_t <= TOL_TAUMOL and e_f <= TOL_TAUMOL,
         f"taumol: taug rel {e_t:.3g}, fracs abs {e_f:.3g} > {TOL_TAUMOL}")
    def k2():
        return taumol_blocked(sc, prof, model.engine, model.kernel_tabs,
                              model.kernel_desc)

    res["taumol"] = dict(
        max_abs_err=max(float((tg_k - tg_p).abs().max()), e_f),
        max_rel_err=e_t, ms=cuda_ms(k2, 5),
        device_ms=device_ms(k2, symbol="taumol_kernel"),
        plain_ms=cuda_ms(lambda: model.engine.blocked(sc, prof), 2),
        **bound((*_pack_inputs(sc, prof), model.kernel_tabs,
                 model.kernel_desc), (tg_k, fr_k),
                OPS["taumol"] * tg_k.numel()))
    print(f"taumol: taug rel {e_t:.3g}, fracs abs {e_f:.3g}, bins equal "
          f"({bins_k.numel()} cells x bands x slots)")
    k2_edge_cases(device, model)

    # K3 Planck, at layer and level temperatures
    tlay, tlev = prof.tavel.t().contiguous(), prof.tz.t().contiguous()
    tot = model.totplnk
    outs = [(planck_interp_blocked(t, tot), interp_planck_blocked(t, tot))
            for t in (tlay, tlev)]
    e = max(float((k - p).abs().max() / p.abs().max()) for k, p in outs)
    need(e <= TOL_TABLE, f"planck: rel err {e:.3g} > {TOL_TABLE}")
    res["planck"] = dict(
        max_abs_err=max(float((k - p).abs().max()) for k, p in outs),
        max_rel_err=e,
        ms=cuda_ms(lambda: (planck_interp_blocked(tlay, tot),
                            planck_interp_blocked(tlev, tot)), 20),
        plain_ms=cuda_ms(lambda: (interp_planck_blocked(tlay, tot),
                                  interp_planck_blocked(tlev, tot)), 20),
        **bound((tlay, tot, tlev, tot), [k for k, _ in outs],
                OPS["planck"] * sum(k.numel() for k, _ in outs)))
    planklay_t, planklev_t = outs[0][0], outs[1][0]

    # K4 cloud coefficients
    reic, relq = clouds.reicmc, clouds.relqmc
    kk = ice_liq_coeffs_blocked(reic, relq, 3, 1, static)
    pp = cldprop.ice_liq_coeffs_blocked(reic, relq, 3, 1, static)
    e = max(float((k - p).abs().max() / p.abs().max())
            for k, p in zip(kk, pp))
    need(e <= TOL_TABLE, f"cldcoef: rel err {e:.3g} > {TOL_TABLE}")
    res["cldcoef"] = dict(
        max_abs_err=max(float((k - p).abs().max()) for k, p in zip(kk, pp)),
        max_rel_err=e,
        ms=cuda_ms(lambda: ice_liq_coeffs_blocked(reic, relq, 3, 1,
                                                  static), 20),
        plain_ms=cuda_ms(lambda: cldprop.ice_liq_coeffs_blocked(
            reic, relq, 3, 1, static), 20),
        **bound((reic, relq, static["absice3"], static["absliq1"]), kk,
                OPS["cldcoef"] * sum(k.numel() for k in kk)))

    # K1 RT sweep, clear and compact McICA, on the kernels' outputs
    taut = tg_k + prof.taua.permute(1, 2, 0)[:, model.ngb0.long(), :]
    cw_t = torch.stack([clouds.ciwp.t(), clouds.clwp.t()], 1).contiguous()
    fields = (clouds.cldfmc, cw_t, kk[0], kk[1])
    args = (taut, fr_k, planklay_t, planklev_t, sc.plankbnd, prof.semiss,
            prof.pwvcm, model.ngb0, model.wg)
    errs, absd = [], []
    for cf in (None, fields):
        fk = rt_fluxes_blocked(*args, cloud_fields=cf)
        fp = rtrn.rt_fluxes_blocked(*args, cloud_fields=cf)
        need(torch.isfinite(fk).all(), "rt_sweep: non-finite fluxes")
        errs.append(flux_err(fp, fk))
        absd.append(float((fk - fp).abs().max()))
    need(max(errs) <= TOL_FLUX,
         f"rt_sweep: flux err clear {errs[0]:.3g} cloudy {errs[1]:.3g}")
    res["rt_sweep_clear"] = dict(
        max_abs_err=absd[0], max_rel_err=errs[0],
        ms=cuda_ms(lambda: rt_fluxes_blocked(*args), 5),
        device_ms=device_ms(lambda: rt_fluxes_blocked(*args)),
        plain_ms=cuda_ms(lambda: rtrn.rt_fluxes_blocked(*args), 2),
        **bound(args, (fk,), 140 * OPS["rt_clear"] * L_MAIN * B_MAIN))
    mask = clouds.cldfmc
    ncld = int((mask[:, :140] != 0).any(1).sum())     # cloudy (layer, col)
    res["rt_sweep"] = dict(
        max_abs_err=max(absd), max_rel_err=max(errs),
        ms=cuda_ms(lambda: rt_fluxes_blocked(*args, cloud_fields=fields),
                   5),
        device_ms=device_ms(lambda: rt_fluxes_blocked(
            *args, cloud_fields=fields)),
        plain_ms=cuda_ms(lambda: rtrn.rt_fluxes_blocked(
            *args, cloud_fields=fields), 2),
        **bound((*args, *fields), (fk,),
                140 * (OPS["rt_clear"] * L_MAIN * B_MAIN
                       + OPS["rt_cloud"] * ncld)))
    print(f"rt_sweep: flux err clear {errs[0]:.3g}, cloudy {errs[1]:.3g}")

    # the deterministic-cloud modes, on make_band_clouds (the main path's
    # clouds: one fraction per deck) and on a field whose fractions rise
    # and fall inside cloudy blocks, the regimes the maxrand factors carry:
    # the overlap rows first (bitwise expected), then K1 banded and
    # maxrand on them; times on the main path's clouds
    _, bc = inputs("band_cloudy", device)
    errs = {k: [] for k in ("overlap_rows", "rt_sweep_banded",
                            "rt_sweep_maxrand")}
    for tag, b in (("decks", bc), ("mixed", mixed_clouds(bc, device))):
        cldf = b.cldfrac
        rows_k, rows_p = overlap_rows(cldf), rtrnmr.overlap_rows(cldf)
        nbad = int((rows_k[:, :4] != rows_p[:, :4]).sum())
        e = rel_err(rows_k[:, 4:], rows_p[:, 4:])
        need(nbad == 0 and e <= TOL_ROWS, f"overlap_rows ({tag}): {nbad} "
             f"discrete rows differ, factor err {e:.3g}")
        need(torch.equal(rows_k, overlap_rows(cldf)),
             f"overlap_rows ({tag}): two runs differ")
        errs["overlap_rows"].append(
            (float((rows_k - rows_p).abs().max()), e))
        print(f"overlap_rows ({tag}): discrete rows equal, factor err "
              f"{e:.3g}, nonzero factors "
              f"{float((rows_p[:, 4:] != 0).double().mean()):.1%}")
        if tag == "decks":
            res["overlap_rows"] = dict(
                ms=cuda_ms(lambda: overlap_rows(cldf), 20),
                plain_ms=cuda_ms(lambda: rtrnmr.overlap_rows(cldf), 2),
                **bound((cldf,), (rows_k,), OPS["overlap"] * cldf.numel()))
        taucb, _ = cldprop.cldprop_banded_blocked(
            b, static, inflag=2, iceflag=3, liqflag=1,
            coeffs=ice_liq_coeffs_blocked)
        cldf_t = cldf.t().contiguous()
        ncld = int((cldf >= rtrn.CLOUD_GATE).sum())
        if tag == "decks":
            band_in = {"rt_sweep_banded": ((cldf_t, taucb), (cldf_t, taucb),
                                           ncld),
                       "rt_sweep_maxrand": ((rows_k, taucb), (rows_p, taucb),
                                            ncld)}
        for name, kern, plain, cld_k, cld_p, ops in (
                ("rt_sweep_banded", rt_fluxes_banded, rtrn.rt_fluxes_banded,
                 cldf_t, cldf_t, OPS["rt_cloud"]),
                ("rt_sweep_maxrand", rt_fluxes_maxrand,
                 rtrn.rt_fluxes_maxrand, rows_k, rows_p, OPS["rt_maxrand"])):
            fk = kern(*args, cld_k, taucb)
            fp = plain(*args, cld_p, taucb)
            need(torch.isfinite(fk).all(), f"{name} ({tag}): non-finite")
            err = flux_err(fp, fk)
            need(err <= TOL_FLUX,
                 f"{name} ({tag}): flux err {err:.3g} > {TOL_FLUX}")
            need(torch.equal(fk, kern(*args, cld_k, taucb)),
                 f"{name} ({tag}): two runs differ")
            need(not torch.allclose(fk[0], fk[2]), f"{name} ({tag}): the "
                 "clouds left the all-sky fluxes unchanged")
            errs[name].append((float((fk - fp).abs().max()), err))
            print(f"{name} ({tag}): flux err {err:.3g}")
            if tag == "decks":
                res[name] = dict(
                    ms=cuda_ms(lambda: kern(*args, cld_k, taucb), 5),
                    device_ms=device_ms(lambda: kern(*args, cld_k, taucb)),
                    plain_ms=cuda_ms(lambda: plain(*args, cld_p, taucb), 2),
                    **bound((*args, cld_k, taucb), (fk,), 140 * (
                        OPS["rt_clear"] * L_MAIN * B_MAIN + ops * ncld)))
    for name, e in errs.items():
        res[name].update(max_abs_err=max(a for a, _ in e),
                         max_rel_err=max(r for _, r in e))
    res.update(k1_per_g_and_idrv(device, model, (*args, sc.dplankbnd_dt),
                                 fields, band_in))
    k1_edge_cases(device, model, args, sc.dplankbnd_dt)
    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']:.3g} "
              f"max_rel_err {r['max_rel_err']:.3g} kernel {r['ms']:.3f} ms "
              f"plain {r['plain_ms']:.3f} ms bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']})")
    return res


def k1_per_g_and_idrv(device, model, args, compact, band_in):
    """K1's fused and cldf-odcld modes on the mcica_blocked and mcica_tauc
    cells' clouds, then every mode at idrv=1 against its plain version:
    flux (and d/dT) error, bitwise repeat, the idrv=1 flux rows bitwise
    equal to the idrv=0 launch's, clouds that move the all-sky fluxes;
    kernel, plain and bound ms.  ``args`` are phase 3's sweep inputs,
    ``compact`` its compact McICA fields, ``band_in`` the banded and
    maxrand modes' cloud inputs (kernel, plain, cloudy layers) on the
    decks."""
    from rrtmg_lw_torch.ops import cldprop, rtrn
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.rtrn_cuda import WRAPPERS
    static = model.static_tensors()
    sc_dpl = args[-1]
    args = args[:-1]
    _, cb = inputs("mcica_blocked", device)
    _, ct = inputs("mcica_tauc", device)
    abi, abl = ice_liq_coeffs_blocked(cb.reicmc, cb.relqmc, 3, 1, static)
    odc, cfc, _ = cldprop.cldprmc_blocked(ct, static, inflag=0, iceflag=3,
                                          liqflag=1)
    gate = cb.cldfmc[:, :140] >= 0.5            # the cloudy (layer, g, col)
    ngate = int(gate.sum())
    ncld = int(gate.any(1).sum())               # cloudy (layer, col)
    cloud_ops = 140 * ncld
    ncld_c = int((compact[0][:, :140] != 0).any(1).sum())
    # entry: (mode, [(cloud args kernel, plain)], bound inputs, extra
    # bytes (the per-g arrays read only where a g-point is cloudy), ops)
    cases = {
        "rt_sweep": ("blocked", [((), ()), ((compact,), (compact,))],
                     compact, 0, OPS["rt_cloud"] * 140 * ncld_c),
        "rt_sweep_fused": ("fused", [(((*cb[:4], abi, abl),),) * 2],
                           (cb.cldfmc, abi, abl), 3 * 4 * ngate,
                           OPS["rt_cloud"] * cloud_ops),
        "rt_sweep_cldf_od": ("cldf_od", [(((cfc, odc),),) * 2], (cfc,),
                             4 * ngate, OPS["rt_cloud"] * cloud_ops),
    }
    for name in ("rt_sweep_banded", "rt_sweep_maxrand"):
        kin, pin, nc = band_in[name]
        cases[name] = (name.split("_")[-1], [(kin, pin)], kin, 0,
                       OPS["rt_cloud" if name.endswith("banded")
                           else "rt_maxrand"] * 140 * nc)
    base = OPS["rt_clear"] * L_MAIN * B_MAIN * 140
    res = {}
    for name, (mode, clouds, bin_, nb, ops) in cases.items():
        kern, plain = WRAPPERS[mode], rtrn.FLUXES[mode]
        new_mode = mode in ("fused", "cldf_od")
        for idrv in ((0, 1) if new_mode else (1,)):
            tag = name + ("_idrv" if idrv else "")
            kw = dict(dplankbnd_dt=sc_dpl) if idrv else {}
            errs, absd = [], []
            for ck, cp in clouds:
                k0 = kern(*args, *ck)
                fk = kern(*args, *ck, **kw)
                fp = plain(*args, *cp, **kw)
                if idrv:
                    need(torch.equal(fk[0], k0), f"{tag}: the flux rows "
                         "differ from the idrv=0 launch's")
                    fk, fp = torch.cat(fk), torch.cat(fp)
                    again = torch.cat(kern(*args, *ck, **kw))
                else:
                    again = kern(*args, *ck)
                need(bool(torch.isfinite(fk).all()), f"{tag}: non-finite")
                errs.append(flux_err(fp, fk))
                absd.append(float((fk - fp).abs().max()))
                need(torch.equal(fk, again), f"{tag}: two runs differ")
                if ck:
                    need(not torch.allclose(fk[0], fk[2]), f"{tag}: the "
                         "clouds left the all-sky fluxes unchanged")
            need(max(errs) <= TOL_FLUX, f"{tag}: flux err {max(errs):.3g}")
            ck, cp = clouds[-1]
            res[tag] = dict(
                max_abs_err=max(absd), max_rel_err=max(errs),
                ms=cuda_ms(lambda: kern(*args, *ck, **kw), 5),
                device_ms=device_ms(lambda: kern(*args, *ck, **kw)),
                plain_ms=cuda_ms(lambda: plain(*args, *cp, **kw), 2),
                **bound((*args, *bin_) + ((sc_dpl,) if idrv else ()),
                        (fk,), base + ops + (OPS["rt_ddt"] * L_MAIN
                                             * B_MAIN * 140 if idrv else 0),
                        nb))
            print(f"{tag}: flux err {max(errs):.3g}"
                  + (", flux rows equal to idrv=0" if idrv else ""))
    return res


def k1_edge_cases(device, model, args, dpl):
    """Every K1 instantiation (6 modes x idrv 0/1 x 4 storages) at full
    width on ``utils.snapshot.k1_edge_args``: clear, overcast and
    top-and-bottom-cloudy columns in runs across K1's 16-column tiles,
    per-g cloud fractions in (0, 0.5), the g-point od forced to exactly
    0.06 (the branch point of the gas and total-sky factors; in float32)
    and to 0.  Each within TOL_FLUX of its plain version per column,
    bitwise over two runs, the idrv=1 flux rows bitwise equal to
    idrv=0's."""
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.rtrn_cuda import WRAPPERS
    from rrtmg_lw_torch.ops.spec_codec import SPEC_DTYPES, spec_store
    from rrtmg_lw_torch.utils.snapshot import k1_edge_args
    eargs, modes, low = k1_edge_args(device, model.static_tensors(), args)
    need(low > 0, "k1 edge: no element at od 0.06 with a cloud fraction "
         "in (0, 0.5)")
    gen = torch.Generator(device=device).manual_seed(8)
    taua = 0.02 * torch.rand((L_MAIN, 16, B_MAIN), generator=gen,
                             device=device)
    worst = {}
    for spec in ("f32",) + SPECS:
        if spec == "f32":
            a, kw = eargs, {}
        else:
            sdt = SPEC_DTYPES[spec]
            a = (spec_store(eargs[0], sdt, "tg"),
                 spec_store(eargs[1], sdt, "fr"), *eargs[2:])
            kw = dict(taua_t=taua)
        for name, (w, cl) in modes.items():
            kern, plain = WRAPPERS[w], rtrn.FLUXES[w]
            tag = f"k1 edge {spec} {name}"
            k0 = kern(*a, *cl, **kw)
            k1 = flat(kern(*a, *cl, dplankbnd_dt=dpl, **kw))
            need(torch.equal(k1[:4], k0),
                 f"{tag}: the idrv=1 flux rows differ from idrv=0's")
            need(torch.equal(k1, flat(kern(*a, *cl, dplankbnd_dt=dpl,
                                           **kw))), f"{tag}: two runs differ")
            e = max(flux_err(plain(*a, *cl, **kw), k0),
                    flux_err(flat(plain(*a, *cl, dplankbnd_dt=dpl, **kw)),
                             k1))
            need(bool(torch.isfinite(k1).all()) and e <= TOL_FLUX,
                 f"{tag}: flux err {e:.3g} > {TOL_FLUX}")
            worst[spec, name] = e
    print(f"k1 edge cases: 48 instantiations within "
          f"{max(worst.values()):.3g} of plain per column, bitwise over "
          f"two runs, idrv=1 flux rows equal to idrv=0's; {low} elements "
          "at od 0.06 with a cloud fraction in (0, 0.5)")


def k1_build_info(log_path):
    """Each K1 instantiation's registers and spill stores (``_build.ptxas_info``)
    and launch configuration (``rtrn_cuda.k1_info``): {"<mode>
    idrv<0|1> <storage>[ save]": {...}}, " save" the four that keep the
    radiances for K6 (clear and compact, float32)."""
    from rrtmg_lw_torch._build import ptxas_info
    from rrtmg_lw_torch.ops.rtrn_cuda import MODES, k1_info
    from rrtmg_lw_torch.ops.spec_codec import SPEC_DTYPES
    names = {v: k for k, v in MODES.items()}
    storages = ("f32",) + SPECS

    def key(m):
        mode, idrv, spec, save = (int(x) for x in m.groups())
        return (f"{names[mode]} idrv{idrv} {storages[spec]}"
                + (" save" if save else ""))
    out = ptxas_info(log_path, r"rt_kernelILi(\d)ELb([01])ELi(\d)ELb([01])E",
                     key)
    for key, r in out.items():
        mode, idrv, spec, *save = key.split()
        info = k1_info(mode, int(idrv[-1]),
                       SPEC_DTYPES.get(spec, torch.float32), bool(save))
        need(info["registers"] == r.get("registers"),
             f"K1 {key}: {info['registers']} registers at run time, ptxas "
             f"said {r.get('registers')}")
        r.update(smem_bytes=info["static_smem"] + info["dynamic_smem"],
                 blocks_per_sm=info["blocks_per_sm"],
                 ring_levels=info["ring_levels"])
    need(len(out) == 52 and all(len(r) == 5 for r in out.values()),
         f"K1: {len(out)} instantiations in the build log, expected 52")
    need(all(out[k]["spill_bytes"] == 0 for k in out if k.endswith("save")),
         "K1: an instantiation that keeps the radiances spills")
    return out


def k6_build_info(log_path):
    """K6's registers and spill stores per instantiation (``_build.ptxas_info``)
    and launch configuration (``rtrn_cuda.k6_info``): {"clear" |
    "compact": {...}}; fails where one spills or fits fewer than two
    blocks per SM."""
    from rrtmg_lw_torch.ops.rtrn_cuda import k6_info
    from rrtmg_lw_torch._build import ptxas_info
    out = ptxas_info(log_path, r"rt_bwd_kernelILb([01])E",
                     lambda m: ("clear", "compact")[int(m.group(1))])
    need(len(out) == 2 and all(len(r) == 2 for r in out.values()),
         f"K6: {len(out)} instantiations in the build log, expected 2")
    for key, r in out.items():
        info = k6_info(key == "compact")
        need(info["registers"] == r["registers"],
             f"K6 {key}: {info['registers']} registers at run time, ptxas "
             f"said {r['registers']}")
        r.update(smem_bytes=info["static_smem"] + info["dynamic_smem"],
                 blocks_per_sm=info["blocks_per_sm"],
                 ring_levels=info["ring_levels"])
        need(r["spill_bytes"] == 0 and r["blocks_per_sm"] >= 2,
             f"K6 {key}: {r['spill_bytes']} B spill stores, "
             f"{r['blocks_per_sm']} blocks per SM")
    return out


def k2_edge_cases(device, model):
    """K2 in all four storages on ``utils.snapshot.k2_edge_args`` at each
    of ``K2_EDGE_SHAPES`` (one column, a warp's 32 columns +-1, a width
    off the 128-column tile, one layer; columns all lower, all upper or switching at laytrop,
    rows clipped at the table's last row, minor gases on both sides of
    their over-abundance threshold): float32 within TOL_TAUMOL of the
    plain engine (taug relative, fracs absolute), bins equal; each reduced
    storage against the plain encode of K2's float32 output (bf16 / f16
    bitwise, logu16 codes at most one apart), its bins equal too."""
    from rrtmg_lw_torch.ops.spec_codec import (SPEC_DTYPES, spec_order,
                                               spec_store)
    from rrtmg_lw_torch.ops.taumol_cuda import (NBIN, TaumolFn,
                                                _unpack_inputs,
                                                taumol_packed)
    from rrtmg_lw_torch.utils.snapshot import K2_EDGE_SHAPES, k2_edge_args
    worst, total = 0.0, {}
    for B, L in K2_EDGE_SHAPES:
        fld, ifld, facts = k2_edge_args(device, model, B, L)
        for k, n in facts.items():
            total[k] = total.get(k, 0) + n
        bins_p = model.engine.bins(*_unpack_inputs(fld, ifld))
        tg_p, fr_p = taumol_packed(model.engine, fld, ifld)
        f32 = None
        for spec in ("f32",) + SPECS:
            tag = f"k2 edge {B}x{L} {spec}"
            bins = torch.empty((16, NBIN, L, B), dtype=torch.int32,
                               device=device)
            got = TaumolFn.apply(fld, ifld, model.engine, model.kernel_tabs,
                                 model.kernel_desc, bins, SPEC_DTYPES[spec])
            need(torch.equal(bins, bins_p), f"{tag}: bins differ")
            if spec == "f32":
                f32 = got
                e_t = float(((got[0].double() - tg_p.double()).abs()
                             / tg_p.double().abs().clamp(min=1e-2)).max())
                e_f = float((got[1] - fr_p).abs().max())
                need(bool(torch.isfinite(got[0]).all()
                          and torch.isfinite(got[1]).all()),
                     f"{tag}: non-finite output")
                need(e_t <= TOL_TAUMOL and e_f <= TOL_TAUMOL,
                     f"{tag}: taug rel {e_t:.3g}, fracs abs {e_f:.3g}")
                worst = max(worst, e_t, e_f)
                continue
            for k, x, which in zip(got, f32, ("tg", "fr")):
                d = int((spec_order(k) - spec_order(
                    spec_store(x, SPEC_DTYPES[spec], which))).abs().max())
                need(d <= (1 if spec == "logu16" else 0),
                     f"{tag} {which}: {d} steps off the encode of K2's "
                     "float32 output")
    need(all(total[k] > 0 for k in ("both", "lower_only", "upper_only",
                                    "last_row", "n2o_over", "n2o_under")),
         f"k2 edge: an edge case is missing: {total}")
    print(f"k2 edge cases: {len(K2_EDGE_SHAPES)} shapes "
          f"{list(K2_EDGE_SHAPES)} x 4 storages, float32 within "
          f"{worst:.3g} of plain, bins equal, 16-bit storages equal to "
          f"the encode of K2's float32 output (logu16 +-1); {total}")


def k5_build_info(log_path):
    """K5's registers and spill stores (``_build.ptxas_info``) and launch
    configuration (``taumol_cuda.k5_info``); fails where it spills or
    fits fewer than its MIN_BLOCKS blocks per SM."""
    import re
    from rrtmg_lw_torch._build import ptxas_info
    from rrtmg_lw_torch.ops.taumol_cuda import k5_info
    src = (pathlib.Path(__file__).resolve().parent
           / "rrtmg_lw_torch" / "csrc" / "taumol_bwd.cu").read_text()
    min_blocks = int(re.search(r"\nconstexpr int MIN_BLOCKS = (\d+);",
                               src).group(1))
    out = ptxas_info(log_path, r"taumol_bwd_kernel", lambda m: "k5")
    need(len(out) == 1 and len(out["k5"]) == 2,
         f"K5: {len(out)} kernels in the build log, expected 1")
    r = out["k5"]
    info = k5_info()
    need(info["registers"] == r["registers"],
         f"K5: {info['registers']} registers at run time, ptxas said "
         f"{r['registers']}")
    r.update(smem_bytes=info["static_smem"] + info["dynamic_smem"],
             blocks_per_sm=info["blocks_per_sm"],
             local_bytes=info["local_bytes"], min_blocks=min_blocks)
    need(r["spill_bytes"] == 0 and info["local_bytes"] == 0
         and r["blocks_per_sm"] >= min_blocks,
         f"K5: {r['spill_bytes']} B spill stores, {info['local_bytes']} B "
         f"local memory, {r['blocks_per_sm']} blocks per SM (launch bounds "
         f"{min_blocks})")
    return r


def k2_build_info(log_path):
    """Each K2 instantiation's registers and spill stores (``_build.ptxas_info``)
    and launch configuration (``taumol_cuda.k2_info``): {storage:
    {...}}."""
    from rrtmg_lw_torch.ops.spec_codec import SPEC_DTYPES
    from rrtmg_lw_torch.ops.taumol_cuda import k2_info
    from rrtmg_lw_torch._build import ptxas_info
    storages = ("f32",) + SPECS
    out = ptxas_info(log_path, r"taumol_kernelILi(\d)E",
                     lambda m: storages[int(m.group(1))])
    for key, r in out.items():
        info = k2_info(SPEC_DTYPES[key])
        need(info["registers"] == r.get("registers"),
             f"K2 {key}: {info['registers']} registers at run time, ptxas "
             f"said {r.get('registers')}")
        r.update(smem_bytes=info["static_smem"] + info["dynamic_smem"],
                 blocks_per_sm=info["blocks_per_sm"])
    need(len(out) == 4 and all(len(r) == 4 for r in out.values()),
         f"K2: {len(out)} instantiations in the build log, expected 4")
    return out


# the K1 instantiation behind each K1 line of the JSON summary
K1_LINES = {"rt_sweep": "compact idrv0 f32", "rt_sweep_clear":
            "clear idrv0 f32", "rt_sweep_banded": "banded idrv0 f32",
            "rt_sweep_maxrand": "maxrand idrv0 f32",
            "rt_sweep_fused": "fused idrv0 f32",
            "rt_sweep_cldf_od": "cldf_od idrv0 f32",
            "rt_sweep_idrv": "compact idrv1 f32",
            "rt_sweep_banded_idrv": "banded idrv1 f32",
            "rt_sweep_maxrand_idrv": "maxrand idrv1 f32",
            "rt_sweep_fused_idrv": "fused idrv1 f32",
            "rt_sweep_cldf_od_idrv": "cldf_od idrv1 f32",
            "rt_sweep_spec": "compact idrv0 logu16",
            "rt_sweep_save": "compact idrv0 f32 save"}
# the K2 instantiation behind each K2 line of the JSON summary
K2_LINES = {"taumol": "f32", "taumol_spec": "logu16"}


def run_steps(model, atm, clouds, steps):
    """Fluxes of the last of ``steps`` calls and host ms per step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fl = model(atm, clouds)
    torch.cuda.synchronize()
    return fl, (time.perf_counter() - t0) * 1e3 / steps


def compare_models(tag, fk, fe, cloudy):
    """The kernels' Fluxes against the eager model's on the card."""
    B, L1 = fk.uflx.shape
    for name in ("uflx", "dflx", "uflxc", "dflxc", "hr", "hrc"):
        x = getattr(fk, name)
        need(x.shape[0] == B and torch.isfinite(x).all(),
             f"{tag}: {name} not finite or mis-shaped {tuple(x.shape)}")
    names = ("uflx", "dflx", "uflxc", "dflxc")
    if fk.duflx_dt is not None:
        names += ("duflx_dt", "duflxc_dt")
        need(fe.duflx_dt is not None
             and bool(torch.isfinite(fk.duflx_dt).all()
                      and torch.isfinite(fk.duflxc_dt).all())
             and bool((fk.duflx_dt[:, 0] > 0).all()),
             f"{tag}: duflx_dt missing, not finite or not positive at the "
             "surface")
    err = max(flux_err(getattr(fe, n).t(), getattr(fk, n).t())
              for n in names)
    need(err <= TOL_FLUX, f"{tag}: flux err vs eager {err:.3g}")
    olr = fk.uflx[:, -1]
    need(bool(((olr > 100) & (olr < 400)).all()),
         f"{tag}: outgoing LW outside 100-400 W/m2")
    if cloudy:
        need(fk.cld_bounds_ok is not None
             and torch.equal(fk.cld_bounds_ok, fe.cld_bounds_ok),
             f"{tag}: cld_bounds_ok differs")
    return err


def counted_steps(tag, model, atm, clouds, steps, counters, per_step):
    """``steps`` calls of ``model`` with every launch counter set to 0
    just before and read just after: each must read its ``per_step``
    count (0 where absent) times ``steps``.  (fluxes, ms, counts)."""
    for fn in counters.values():
        fn.launches = 0
    fl, ms = run_steps(model, atm, clouds, steps)
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {k: per_step.get(k, 0) * steps for k in counters}
    need(counts == want, f"{tag}: launches {counts}, expected {want}")
    print(f"{tag}: launches in its {steps} step(s): {counts}")
    return fl, ms, counts


def forward_cells(device, counters, cells):
    """Each cell of ``cells`` ((tag, cell of utils/profiling.py, steps,
    launches per step[, config overrides])) through the kernels, counted
    on its own, then once through the eager model on the card; fluxes
    held to eager."""
    from rrtmg_lw_torch import make_model
    from rrtmg_lw_torch.utils.profiling import CELLS
    launches, rows = {}, []
    for tag, cell, steps, per_step, *over in cells:
        atm, clouds = inputs(cell, device)
        models = {impl: make_model(CELLS[cell].config(impl=impl,
                                                      **dict(*over)),
                                   device=device)
                  for impl in ("cuda", "eager")}
        models["cuda"](atm, clouds)          # warm-up (first launches)
        torch.cuda.synchronize()
        fk, ms, launches[tag] = counted_steps(tag, models["cuda"], atm,
                                              clouds, steps, counters,
                                              per_step)
        fe, ms_e = run_steps(models["eager"], atm, clouds, 1)
        err = compare_models(tag, fk, fe, clouds is not None)
        if clouds is not None:
            need(not torch.allclose(fk.uflx, fk.uflxc),
                 f"{tag}: the clouds left the all-sky fluxes unchanged")
        for impl, t in (("cuda", ms), ("eager", ms_e)):
            rows.append(dict(cell=tag, impl=impl, ncol=B_MAIN, nlay=L_MAIN,
                             ms_per_step=t, cols_per_sec=B_MAIN / (t * 1e-3),
                             **(dict(launches=launches[tag])
                                if impl == "cuda" else {})))
        print(f"{tag}: flux err cuda vs eager {err:.3g}")
        del models, atm, clouds, fk, fe
        torch.cuda.empty_cache()
    return launches, rows


# forward cells: tag, cell of utils/profiling.py (its inputs and config),
# steps, launches per step[, config overrides]
FWD = dict(taumol=1, planck=2, cldcoef=1)
NO_K4 = dict(FWD, cldcoef=0)
CELLS_MAIN = (("clear", "clear", STEPS, dict(NO_K4, rt_sweep=1)),
              ("mcica_cloudy", "mcica_cloudy", STEPS, dict(FWD, rt_sweep=1)))
# deterministic clouds (imca=0): K1 banded for icld=1, the overlap rows
# and K1 maxrand for icld 2/3 (icld=3 reaches the same kernels: one step)
CELLS_BAND = (("band_cloudy", "band_cloudy", STEPS,
               dict(FWD, rt_sweep_banded=1)),
              ("maxrand_cloudy", "maxrand_cloudy", STEPS,
               dict(FWD, rt_sweep_maxrand=1, overlap_rows=1)),
              ("maxrand_cloudy_icld3", "maxrand_cloudy", 1,
               dict(FWD, rt_sweep_maxrand=1, overlap_rows=1), dict(icld=3)))
# McICA per-g arrays: K1 fused (inflag=2, K4 for the coefficients) and
# cldf-odcld (inflag=0: the input cloud od, no K4); then idrv=1, whose
# launches also count on the wrapper's idrv counter (the banded, fused
# and cldf-odcld paths at idrv=1: one step each)
CELLS_PER_G = (("mcica_blocked", "mcica_blocked", STEPS,
                dict(FWD, rt_sweep_fused=1)),
               ("mcica_tauc", "mcica_tauc", STEPS,
                dict(NO_K4, rt_sweep_cldf_od=1)))
CELLS_IDRV = (("clear_idrv", "clear_idrv", STEPS,
               dict(NO_K4, rt_sweep=1, rt_sweep_idrv=1)),
              ("mcica_cloudy_idrv", "mcica_cloudy_idrv", STEPS,
               dict(FWD, rt_sweep=1, rt_sweep_idrv=1)),
              ("maxrand_cloudy_idrv", "maxrand_cloudy_idrv", STEPS,
               dict(FWD, rt_sweep_maxrand=1, rt_sweep_maxrand_idrv=1,
                    overlap_rows=1)),
              ("band_cloudy_idrv", "band_cloudy_idrv", 1,
               dict(FWD, rt_sweep_banded=1, rt_sweep_banded_idrv=1)),
              ("mcica_blocked_idrv", "mcica_blocked_idrv", 1,
               dict(FWD, rt_sweep_fused=1, rt_sweep_fused_idrv=1)),
              ("mcica_tauc_idrv", "mcica_tauc_idrv", 1,
               dict(NO_K4, rt_sweep_cldf_od=1, rt_sweep_cldf_od_idrv=1)))


def extra_steps(device, counters):
    """One from_profile step with Profile.dtbound set (a seeded +-2 K
    field; idrv=1, McICA) and one step with a float32 compact mask (K1
    fused), each through the kernels against eager on the card."""
    from rrtmg_lw_torch import make_model
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.utils.profiling import CELLS
    atm, clouds = inputs("mcica_cloudy_idrv", device)
    prof = inatm(atm, torch.float32)
    gen = torch.Generator(device=device).manual_seed(11)
    dtb = 4.0 * torch.rand(B_MAIN, generator=gen, device=device) - 2.0
    out = {impl: make_model(CELLS["mcica_cloudy_idrv"].config(impl=impl),
                            device=device).from_profile(
                                prof._replace(dtbound=dtb), clouds)
           for impl in ("cuda", "eager")}
    err = compare_models("dtbound", out["cuda"], out["eager"], True)
    plain = make_model(CELLS["mcica_cloudy_idrv"].config(impl="cuda"),
                       device=device).from_profile(prof, clouds)
    fk = out["cuda"]
    need(torch.equal(fk.dflx, plain.dflx)
         and torch.equal(fk.uflx, plain.uflx + plain.duflx_dt * dtb[:, None])
         and not torch.equal(fk.hr, plain.hr),
         "dtbound: the adjustment is not uflx + duflx_dt * dtbound")
    print(f"dtbound: flux err cuda vs eager {err:.3g}, uflx moved by "
          f"up to {float((fk.uflx - plain.uflx).abs().max()):.3g} W/m2")

    atm, clouds = inputs("mcica_cloudy", device)
    fmask = clouds._replace(cldfmc=clouds.cldfmc.float())
    model = make_model(CELLS["mcica_cloudy"].config(impl="cuda"),
                       device=device)
    fk, _, _ = counted_steps("mcica_float_mask", model, atm, fmask, 1,
                             counters, dict(FWD, rt_sweep_fused=1))
    fe = make_model(CELLS["mcica_cloudy"].config(impl="eager"),
                    device=device)(atm, fmask)
    err = compare_models("mcica_float_mask", fk, fe, True)
    same = all(torch.equal(getattr(fk, n), getattr(model(atm, clouds), n))
               for n in ("uflx", "dflx", "uflxc", "dflxc"))
    print(f"mcica_float_mask: flux err cuda vs eager {err:.3g}; "
          f"{'bitwise equal to' if same else 'differs from'} the int8 mask")


def phase_deep(device, counters):
    from rrtmg_lw_torch import LWConfig, make_model
    atm, clouds = inputs("mcica_cloudy_deep", device)
    out = {}
    for impl in ("cuda", "eager"):
        m = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False, impl=impl), device=device)
        if impl == "cuda":
            m(atm, clouds)                       # warm-up
            before = {k: fn.launches for k, fn in counters.items()}
        out[impl] = run_steps(m, atm, clouds, 1)
        if impl == "cuda":
            need(all(fn.launches > before[k] for k, fn in counters.items()),
                 "mcica_cloudy_deep: a kernel of the path never launched")
        del m
    err = compare_models("mcica_cloudy_deep", out["cuda"][0],
                         out["eager"][0], True)
    print(f"mcica_cloudy_deep: flux err cuda vs eager {err:.3g}")
    return [dict(cell="mcica_cloudy_deep", impl=impl, ncol=B_MAIN,
                 nlay=L_DEEP, ms_per_step=out[impl][1],
                 cols_per_sec=B_MAIN / (out[impl][1] * 1e-3))
            for impl in ("cuda", "eager")]


def rel_err(got, ref):
    """max |got - ref| / max |ref| (the absolute error where ref is 0)."""
    scale = float(ref.double().abs().max())
    diff = float((got.double() - ref.double()).abs().max())
    return diff / scale if scale > 0 else diff


def columns(atm, clouds, cols):
    """The columns ``cols`` (a slice) of an Atmosphere and compact clouds
    (or None)."""
    from rrtmg_lw_torch import Atmosphere, McicaCloudsCompact
    atm = Atmosphere(*(x[cols] for x in atm))
    if clouds is None:
        return atm, None
    return atm, McicaCloudsCompact(clouds.cldfmc[..., cols].contiguous(),
                                   *(x[cols] for x in clouds[1:]))


def phase_grad_kernels(device):
    """Each backward kernel vs the plain vjp on the phase-3 tensors; two
    runs of each kernel must be bitwise equal."""
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.planck_cuda import planck_interp_vjp
    from rrtmg_lw_torch.ops.rtrn_cuda import (rt_fluxes_blocked,
                                              rt_sweep_radiances,
                                              rt_sweep_vjp)
    from rrtmg_lw_torch.ops.setcoef import (interp_planck_blocked,
                                            interp_planck_vjp, setcoef)
    from rrtmg_lw_torch.utils.snapshot import (K5_BOOST, k1_edge_args,
                                               k5_inputs)
    from rrtmg_lw_torch.ops.taumol_cuda import (_pack_inputs,
                                                taumol_packed,
                                                taumol_packed_vjp,
                                                taumol_vjp)

    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False, impl="cuda"), device=device)
    atm, clouds = inputs("mcica_cloudy", device)
    prof = inatm(atm, dtype=torch.float32)
    static = model.static_tensors()
    gen = torch.Generator(device=device).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def check(name, got, ref, tol, again):
        errs, absd = [], []
        for g, r in zip(got, ref):
            if r is None:
                continue
            need(g is not None and g.shape == r.shape
                 and bool(torch.isfinite(g).all()),
                 f"{name}: non-finite or mis-shaped output")
            errs.append(rel_err(g, r))
            absd.append(float((g - r).abs().max()))
        need(max(errs) <= tol, f"{name}: rel err {max(errs):.3g} > {tol} "
             f"(per output: {[f'{e:.2g}' for e in errs]})")
        need(all(a is None or torch.equal(g, a) for g, a in zip(got, again)),
             f"{name}: two runs differ")
        return dict(max_abs_err=max(absd), max_rel_err=max(errs))

    res = {}
    # K3b at layer and level temperatures
    temps = (prof.tavel.t().contiguous(), prof.tz.t().contiguous())
    cts = [randn(t.shape[0], 16, B_MAIN) for t in temps]
    tot = model.totplnk
    res["planck_bwd"] = check(
        "planck_bwd",
        [planck_interp_vjp(t, tot, c) for t, c in zip(temps, cts)],
        [interp_planck_vjp(t, tot, c) for t, c in zip(temps, cts)], TOL_BWD,
        [planck_interp_vjp(t, tot, c) for t, c in zip(temps, cts)])
    res["planck_bwd"].update(
        ms=cuda_ms(lambda: [planck_interp_vjp(t, tot, c)
                            for t, c in zip(temps, cts)], 20),
        plain_ms=cuda_ms(lambda: [interp_planck_vjp(t, tot, c)
                                  for t, c in zip(temps, cts)], 5),
        **bound((*temps, tot, tot, *cts), temps,
                OPS["planck_bwd"] * sum(c.numel() for c in cts)))

    # K5 per field, on the main-path cells and on boosted ones that cross
    # the minor-gas over-abundance thresholds
    sc = setcoef(prof, static, planck=False)
    fld, ifld = _pack_inputs(sc, prof)
    ct_t, ct_f = randn(L_MAIN, 140, B_MAIN), randn(L_MAIN, 140, B_MAIN)
    eng, tabs, desc = model.engine, model.kernel_tabs, model.kernel_desc
    out, ref, again = [], [], []
    for f, i in ((fld, ifld), k5_inputs(device, model, boost=K5_BOOST)):
        out += list(taumol_vjp(f, i, eng, tabs, desc, ct_t, ct_f))
        ref += list(taumol_packed_vjp(eng, f, i, ct_t, ct_f))
        again += list(taumol_vjp(f, i, eng, tabs, desc, ct_t, ct_f))
    res["taumol_bwd"] = check("taumol_bwd", out, ref, TOL_BWD, again)
    ops, ct_bytes = taumol_bwd_work(desc, ifld)
    res["taumol_bwd"].update(
        ms=cuda_ms(lambda: taumol_vjp(fld, ifld, eng, tabs, desc, ct_t,
                                      ct_f), 5),
        plain_ms=cuda_ms(lambda: taumol_packed_vjp(eng, fld, ifld, ct_t,
                                                   ct_f), 2),
        **bound((fld, ifld, tabs, desc), (fld,), ops, nbytes=ct_bytes))

    # K1 keeping its radiances (the gradient step's launch) and K6 fed
    # them, clear and compact McICA, on the forward's own tensors and on
    # K1's edge cases: K1's fluxes bitwise those of its launch without
    # them, its radiances within TOL_RADS of the plain ones, K6 within
    # TOL_BWD_RT of the plain vjp; K6 without the radiances raises
    taug, fracs = taumol_packed(eng, fld, ifld)
    taut = taug + prof.taua.permute(1, 2, 0)[:, model.ngb0.long(), :]
    play, plev = (interp_planck_blocked(t, tot) for t in temps)
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float32)
    abi, abl = ice_liq_coeffs_blocked(clouds.reicmc, clouds.relqmc, 3, 1,
                                      static)
    cw = torch.stack([clouds.ciwp.t(), clouds.clwp.t()], 1).contiguous()
    ct = randn(4, L_MAIN + 1, B_MAIN)
    fl_args = (sc.plankbnd, prof.semiss, prof.pwvcm, model.ngb0, model.wg)
    # times, on the main path's compact McICA inputs (device ms: in a
    # process of its own, grad_device_times); the errors come from the
    # checks after them
    cf = (cw, abi, abl, clouds.cldfmc)
    args = (taut, fracs, play, plev, surf, *cf, model.ngb0, model.wg)
    fk, rads = rt_sweep_radiances(*args)
    grads = rt_sweep_vjp(*args, ct, rads=rads)
    mask = clouds.cldfmc
    ncld = int((mask[:, :140] != 0).any(1).sum())     # cloudy (layer, col)
    res["rt_adjoint"] = dict(
        ms=cuda_ms(lambda: rt_sweep_vjp(*args, ct, rads=rads), 5),
        plain_ms=cuda_ms(lambda: rtrn.rt_sweep_vjp(*args, ct), 1),
        **bound((*args, ct, rads), grads, OPS["rt_adjoint"] * taut.numel()))
    res["rt_sweep_save"] = dict(
        ms=cuda_ms(lambda: rt_sweep_radiances(*args), 5),
        plain_ms=cuda_ms(lambda: rtrn.rt_sweep_blocked(
            *args[:5], model.ngb0, model.wg, (mask, *cf[:3]),
            radiances=True), 1),
        **bound(args, (fk, rads),
                140 * (OPS["rt_clear"] * L_MAIN * B_MAIN
                       + OPS["rt_cloud"] * ncld)))
    del fk, rads, grads
    eargs, emodes, _ = k1_edge_args(device, static, (taut, fracs, play,
                                                     plev, *fl_args))
    emask, ecw, eabi, eabl = emodes["compact"][1][0]
    out, ref, again, save_errs = [], [], [], []
    for tag, tt, cf in (("clear", taut, (None,) * 4),
                        ("compact", taut, (cw, abi, abl, clouds.cldfmc)),
                        ("edge clear", eargs[0], (None,) * 4),
                        ("edge compact", eargs[0], (ecw, eabi, eabl,
                                                    emask))):
        fields = None if cf[3] is None else (cf[3], *cf[:3])
        args = (tt, fracs, play, plev, surf, *cf, model.ngb0, model.wg)
        fk, rads = rt_sweep_radiances(*args)
        need(torch.equal(fk, rt_fluxes_blocked(tt, fracs, play, plev,
                                               *fl_args, fields)),
             f"rt_sweep_save ({tag}): fluxes differ from K1's without the "
             "radiances")
        _, rads_p = rtrn.rt_sweep_blocked(tt, fracs, play, plev, surf,
                                          model.ngb0, model.wg, fields,
                                          radiances=True)
        e = rel_err(rads, rads_p)
        need(bool(torch.isfinite(rads).all()) and e <= TOL_RADS,
             f"rt_sweep_save ({tag}): radiances off by {e:.3g} of max "
             f"|plain| > {TOL_RADS}")
        save_errs.append((float((rads - rads_p).abs().max()), e))
        del rads_p
        try:
            rt_sweep_vjp(*args, ct)
        except ValueError:
            pass
        else:
            need(False, "rt_adjoint: K6 ran without the radiances")
        grads = rt_sweep_vjp(*args, ct, rads=rads)
        out += list(grads)
        ref += list(rtrn.rt_sweep_vjp(*args, ct))
        again += list(rt_sweep_vjp(*args, ct, rads=rads))
        print(f"rt_sweep_save ({tag}): fluxes bitwise K1's, radiances "
              f"within {e:.3g} of max |plain|")
        if tag == "clear":
            # the clear launches' bounds, counted as the compact ones
            res["rt_adjoint"]["bound_ms_clear"] = bound(
                (*args, ct, rads), grads,
                OPS["rt_adjoint"] * tt.numel())["bound_ms"]
            res["rt_sweep_save"]["bound_ms_clear"] = bound(
                args, (fk, rads),
                140 * OPS["rt_clear"] * L_MAIN * B_MAIN)["bound_ms"]
            print(f"clear bounds: rt_adjoint "
                  f"{res['rt_adjoint']['bound_ms_clear']:.3f} ms, "
                  f"rt_sweep_save "
                  f"{res['rt_sweep_save']['bound_ms_clear']:.3f} ms")
    res["rt_adjoint"].update(check("rt_adjoint", out, ref, TOL_BWD_RT,
                                   again))
    res["rt_sweep_save"].update(
        max_abs_err=max(a for a, _ in save_errs),
        max_rel_err=max(r for _, r in save_errs))
    del out, ref, again
    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']:.3g} "
              f"max_rel_err {r['max_rel_err']:.3g} kernel {r['ms']:.3f} ms "
              f"plain {r['plain_ms']:.3f} ms")
    return res


def grad_device_times():
    """Device ms of K1 keeping the radiances and of K6 fed them, compact
    McICA on phase 3's inputs, and of K5 (L=60; L=140 printed), from
    ``utils/snapshot.py --k5-times --k6-times`` in a process of its own:
    in this script's long process the profiler's traces of these launches
    held 3 of 5 early and one or none late (phase 6 holds their results
    and their wrapper ms).  -> {summary name: device ms}."""
    from rrtmg_lw_torch import _build
    out6 = _build.BUILD_ROOT / "k6_times.json"
    out5 = _build.BUILD_ROOT / "k5_times.json"
    for out in (out5, out6):
        out.unlink(missing_ok=True)
    res = subprocess.run(
        [sys.executable, "-m", "rrtmg_lw_torch.utils.snapshot",
         "--k5-times", str(out5), "--k6-times", str(out6)],
        capture_output=True, text=True,
        cwd=pathlib.Path(__file__).resolve().parent, timeout=600)
    print(res.stdout, end="")
    need(res.returncode == 0 and out5.exists() and out6.exists(),
         f"snapshot.py --k5-times --k6-times failed:\n{res.stderr[-3000:]}")
    rows = {r["mode"]: r for r in json.loads(out6.read_text())}
    c = rows["compact"]
    k5 = {r["nlay"]: r["device_ms"] for r in json.loads(out5.read_text())}
    print(f"device ms, K1 keeping the radiances {c['k1_save_ms']:.3f} "
          f"(without {c['k1_ms']:.3f}), K6 {c['k6_ms']:.3f}, K5 "
          f"{k5[L_MAIN]:.3f} (L={L_DEEP}: {k5[L_DEEP]:.3f})")
    return {"rt_sweep_save": c["k1_save_ms"], "rt_adjoint": c["k6_ms"],
            "taumol_bwd": k5[L_MAIN]}


def grad_errs(tag, gk, ge):
    """Per Atmosphere field, max |kernels - eager| / max |eager|; printed."""
    errs = {}
    for name in gk._fields:
        g, r = getattr(gk, name), getattr(ge, name)
        need(g.shape == r.shape and bool(torch.isfinite(g).all()),
             f"{tag}: gradient of {name} not finite or mis-shaped")
        errs[name] = rel_err(g, r)
    worst = max(errs, key=errs.get)
    print(f"{tag}: gradients on {B_MAIN} columns, kernels vs eager, max rel "
          f"err {errs[worst]:.3g} ({worst}); " + ", ".join(
              f"{k} {v:.2g}" for k, v in errs.items()))
    return worst, errs[worst]


def phase_grad_step(device, counters):
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.parallel import make_grad_step
    cfg = dict(dtype="float32", use_lut=False)
    atm, clouds = inputs("mcica_cloudy", device)
    # The gate's loss sums seeded cotangents times uflx, dflx, uflxc and
    # dflxc over every level and column.  Linear in the fluxes, its
    # gradient reads the forward only through the kernels' linearization
    # points, so the two backward paths are held to each other.  The
    # default loss is not: its hr**2 term is ill-conditioned in f32 at the
    # top layers (tests/test_torch_grad.py::test_f32_gradient_conditioning).
    gen = torch.Generator(device=device).manual_seed(7)
    cts = [torch.randn(B_MAIN, L_MAIN + 1, generator=gen, device=device)
           for _ in range(4)]

    def linear(cts):
        return lambda f: sum((c * x).sum() for c, x in zip(
            cts, (f.uflx, f.dflx, f.uflxc, f.dflxc)))

    rows, launches = [], None
    for icld, steps in ((2, STEPS), (0, 1)):
        tag = "mcica_cloudy_grad" if icld else "clear_grad"
        cl = clouds if icld else None
        model = make_model(LWConfig(icld=icld, imca=1, impl="cuda", **cfg),
                           device=device)
        step = make_grad_step(model)
        step(atm, cl)                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, grads = step(atm, cl)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        counts = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        need(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads),
             f"{tag}: non-finite loss or gradient")
        need(all(n > 0 for k, n in counts.items()
                 if icld or k != "cldcoef"),
             f"{tag}: a kernel of the path never launched: {counts}")
        need(counts["rt_sweep"] == counts["rt_sweep_save"] == steps,
             f"{tag}: K1 keeping the radiances launched "
             f"{counts['rt_sweep_save']} times in {steps} step(s), K1 "
             f"{counts['rt_sweep']}, expected one each a step")
        if icld:
            launches = counts
        else:
            need(counts["cldcoef"] == 0, "cldcoef launched on clear_grad")
        print(f"{tag}: launches in the timed steps: {counts}")
        del step, grads
        # the gate, on every column; the loss is a sum over columns, so
        # the eager step runs in column chunks
        _, gk = make_grad_step(model, linear(cts))(atm, cl)
        eager = make_model(LWConfig(icld=icld, imca=1, impl="eager", **cfg),
                           device=device)
        chunks = [make_grad_step(eager, linear([c[s] for c in cts]))(
            *columns(atm, cl, s))[1] for s in (
                slice(i, i + B_CHUNK) for i in range(0, B_MAIN, B_CHUNK))]
        ge = type(gk)(*(torch.cat(g) for g in zip(*chunks)))
        worst, err = grad_errs(tag, gk, ge)
        need(err <= TOL_STEP,
             f"{tag}: gradient of {worst} off by {err:.3g} of max |eager|")
        rows.append(dict(cell=tag, impl="cuda", ncol=B_MAIN, nlay=L_MAIN,
                         ms_per_step=ms, cols_per_sec=B_MAIN / (ms * 1e-3),
                         peak_gib=peak, grad_rel_err_vs_eager=err))
        del model, eager, gk, ge, chunks
        torch.cuda.empty_cache()
    return launches, rows


def phase_grad_idrv(device):
    """The McICA gradient step (default loss) at idrv=1 runs through K6
    and gives the idrv=0 step's loss and gradients bitwise (the loss reads
    no d/dT; both with deterministic algorithms, under which two idrv=0
    steps are bitwise equal too); a loss that reads duflx_dt, and a backward through the
    fused mode, raise NotImplementedError on the card."""
    from rrtmg_lw_torch import Atmosphere, make_model
    from rrtmg_lw_torch.parallel import make_grad_step
    from rrtmg_lw_torch.utils.profiling import CELLS
    atm, clouds = inputs("mcica_cloudy", device)
    steps = [make_grad_step(make_model(CELLS[c].config(impl="cuda"),
                                       device=device))
             for c in ("mcica_cloudy", "mcica_cloudy", "mcica_cloudy_idrv")]
    # autograd's scatter-adds (the backward of the band -> g gathers) use
    # float atomics on the card unless deterministic algorithms are on
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (l0, g0), (lr, gr), (l1, g1) = (step(atm, clouds) for step in steps)
    finally:
        torch.use_deterministic_algorithms(False)

    def diffs(ga, gb):
        return {n: float((a - b).abs().max()) for n, a, b in
                zip(Atmosphere._fields, ga, gb) if not torch.equal(a, b)}
    need(torch.equal(l0, lr) and not diffs(g0, gr),
         f"mcica_cloudy_grad: two deterministic steps differ: {diffs(g0, gr)}")
    need(torch.equal(l0, l1) and not diffs(g0, g1),
         f"mcica_cloudy_idrv_grad: gradients differ from idrv=0's: "
         f"{diffs(g0, g1)}")
    del steps, g0, gr, g1
    idrv = make_model(CELLS["mcica_cloudy_idrv"].config(impl="cuda"),
                      device=device)
    atm_b, blk = inputs("mcica_blocked", device)
    fused = make_model(CELLS["mcica_blocked"].config(impl="cuda"),
                       device=device)
    for tag, step, a, c in (
            ("d/dT cotangent", make_grad_step(idrv, lambda f: (
                f.duflx_dt ** 2).mean()), atm, clouds),
            ("fused backward", make_grad_step(fused), atm_b, blk)):
        try:
            step(a, c)
        except NotImplementedError as e:
            need("ROADMAP" in str(e), f"{tag}: {e}")
        else:
            need(False, f"{tag}: the backward did not raise on the card")
        print(f"grad: {tag} raises NotImplementedError on the card")
    print("mcica_cloudy_idrv_grad: loss and gradients bitwise equal to "
          "idrv=0's (deterministic algorithms)")


# reduced spectral storage (RRTMG_SPEC_DTYPE, K7): the storage dtypes
SPECS = ("bf16", "f16", "logu16")
FLUX_NAMES = ("uflx", "dflx", "uflxc", "dflxc")


def flat(out):
    """A sweep's fluxes, with the d/dT rows after them at idrv=1."""
    return torch.cat(out) if isinstance(out, tuple) else out


def phase_storage_kernels(device):
    """K2 in each reduced storage against the plain encode of K2's own
    float32 output (bf16 / f16 bitwise, logu16 codes equal or one apart)
    and of the plain K2's; K1 in every mode x idrv 0/1 x storage against
    the plain decode + aerosol add + sweep on the same codes, within
    TOL_FLUX per column and bitwise over two runs, on a seeded aerosol od
    that varies in layer, band and column: the same check of a K1 that
    dropped the add, or read taua at reversed bands or layers or at
    shifted columns, must fail.  Times of the logu16 K2 and of the logu16
    compact sweep."""
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.planck_cuda import planck_interp_blocked
    from rrtmg_lw_torch.ops.rtrn_cuda import WRAPPERS
    from rrtmg_lw_torch.ops.setcoef import setcoef
    from rrtmg_lw_torch.ops.spec_codec import (SPEC_DTYPES, spec_load_frac,
                                               spec_load_taut, spec_order,
                                               spec_store)
    from rrtmg_lw_torch.ops.taumol_cuda import _pack_inputs, taumol_blocked
    from rrtmg_lw_torch.utils.profiling import AOD_SPEC
    from rrtmg_lw_torch.utils.snapshot import k1_cloud_args

    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False, impl="cuda"), device=device)
    atm, clouds = inputs("mcica_cloudy", device, aod=AOD_SPEC)
    prof = inatm(atm, dtype=torch.float32)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    eng, tabs, desc = model.engine, model.kernel_tabs, model.kernel_desc
    f32_k = taumol_blocked(sc, prof, eng, tabs, desc)
    f32_p = eng.blocked(sc, prof)
    res, codes = {}, {}
    for spec in SPECS:
        sdt = SPEC_DTYPES[spec]
        got = taumol_blocked(sc, prof, eng, tabs, desc, spec_dtype=sdt)
        again = taumol_blocked(sc, prof, eng, tabs, desc, spec_dtype=sdt)
        need(all(torch.equal(spec_order(a), spec_order(b))
                 for a, b in zip(got, again)),
             f"taumol_spec {spec}: two runs differ")
        line, err = [], 0.0
        for k, xk, xp, which in zip(got, f32_k, f32_p, ("tg", "fr")):
            d_own = (spec_order(k)
                     - spec_order(spec_store(xk, sdt, which))).abs()
            plain = spec_store(xp, sdt, which)
            d_plain = (spec_order(k) - spec_order(plain)).abs()
            n_own, n_plain = int((d_own != 0).sum()), int((d_plain != 0).sum())
            need(int(d_own.max()) <= (1 if spec == "logu16" else 0)
                 and int(d_plain.max()) <= 1,
                 f"taumol_spec {spec} {which}: {n_own} elements off the "
                 f"encode of K2's float32 output (max {int(d_own.max())}), "
                 f"{n_plain} off the plain K2's (max {int(d_plain.max())})")
            load = spec_load_taut if which == "tg" else spec_load_frac
            err = max(err, float((load(k) - load(plain)).abs().max()))
            line.append(f"{which} {n_own} ({n_own / k.numel():.2e}) / "
                        f"{n_plain} ({n_plain / k.numel():.2e})")
        print(f"taumol_spec {spec}: elements one step off the encode of "
              f"K2's float32 output / of the plain K2's: " + "; ".join(line)
              + f"; max |decoded diff| vs plain {err:.3g}")
        codes[spec] = got
        if spec == "logu16":
            def k2():
                return taumol_blocked(sc, prof, eng, tabs, desc,
                                      spec_dtype=sdt)

            res["taumol_spec"] = dict(
                max_abs_err=err, ms=cuda_ms(k2, 5),
                device_ms=device_ms(k2, symbol="taumol_kernel"),
                plain_ms=cuda_ms(lambda: [
                    spec_store(x, sdt, w) for x, w in
                    zip(eng.blocked(sc, prof), ("tg", "fr"))], 2),
                **bound((*_pack_inputs(sc, prof), tabs, desc), got,
                        (OPS["taumol"] + OPS["spec_codec"])
                        * got[0].numel()))
    del f32_k, f32_p

    # the aerosol od K1 adds after the decode, up to 0.02 per layer and
    # band (a column od ~0.6), different in every (layer, band, column)
    gen = torch.Generator(device=device).manual_seed(4)
    taua_t = 0.02 * torch.rand((L_MAIN, 16, B_MAIN), generator=gen,
                               device=device)
    faults = {"no aerosol add": torch.zeros_like(taua_t),
              "bands reversed": taua_t.flip(1).contiguous(),
              "layers reversed": taua_t.flip(0).contiguous(),
              "columns shifted": taua_t.roll(1, 2).contiguous()}
    rest = (planck_interp_blocked(prof.tavel.t().contiguous(), model.totplnk),
            planck_interp_blocked(prof.tz.t().contiguous(), model.totplnk),
            sc.plankbnd, prof.semiss, prof.pwvcm, model.ngb0, model.wg)
    modes = k1_cloud_args(device, static, clouds)
    worst = (0.0, 0.0)
    for spec in SPECS:
        tg, fr = codes[spec]
        errs, moved = [], []
        for name, (w, cl) in modes.items():
            kern, plain = WRAPPERS[w], rtrn.FLUXES[w]
            fp = plain(tg, fr, *rest, *cl, taua_t=taua_t)
            for fault, ta in faults.items():
                e = flux_err(fp, kern(tg, fr, *rest, *cl, taua_t=ta))
                need(e > TOL_FLUX, f"rt_sweep_spec {spec} {name}: with "
                     f"{fault} K1 would pass ({e:.3g} <= {TOL_FLUX})")
                moved.append(e)
            for idrv in (0, 1):
                kw = dict(taua_t=taua_t,
                          dplankbnd_dt=sc.dplankbnd_dt if idrv else None)
                fk = flat(kern(tg, fr, *rest, *cl, **kw))
                fp = flat(plain(tg, fr, *rest, *cl, **kw))
                tag = f"rt_sweep_spec {spec} {name}" + (" idrv" if idrv
                                                        else "")
                need(bool(torch.isfinite(fk).all()), f"{tag}: non-finite")
                need(torch.equal(fk, flat(kern(tg, fr, *rest, *cl, **kw))),
                     f"{tag}: two runs differ")
                e = flux_err(fp, fk)
                need(e <= TOL_FLUX, f"{tag}: flux err {e:.3g} > {TOL_FLUX}")
                errs.append(e)
                worst = max(worst, (e, float((fk - fp).abs().max())))
        print(f"rt_sweep_spec {spec}: 6 modes x idrv 0/1 within "
              f"{max(errs):.3g} of the plain decode-add-sweep per column, "
              "bitwise over two runs; with the aerosol add dropped or "
              f"misread ({', '.join(faults)}) at least {min(moved):.3g}")
    tg, fr = codes["logu16"]
    cf = modes["compact"][1]
    ncld = int((clouds.cldfmc[:, :140] != 0).any(1).sum())
    kw = dict(taua_t=taua_t)
    fk = WRAPPERS["blocked"](tg, fr, *rest, *cf, **kw)
    res["rt_sweep_spec"] = dict(
        max_abs_err=worst[1], max_rel_err=worst[0],
        ms=cuda_ms(lambda: WRAPPERS["blocked"](tg, fr, *rest, *cf, **kw), 5),
        device_ms=device_ms(
            lambda: WRAPPERS["blocked"](tg, fr, *rest, *cf, **kw)),
        plain_ms=cuda_ms(lambda: rtrn.FLUXES["blocked"](tg, fr, *rest, *cf,
                                                        **kw), 2),
        **bound((tg, fr, taua_t, *rest, *cf[0]), (fk,),
                140 * (OPS["rt_clear"] * L_MAIN * B_MAIN
                       + OPS["rt_cloud"] * ncld)
                + 2 * OPS["spec_codec"] * tg.numel()))
    for name in ("taumol_spec", "rt_sweep_spec"):
        r = res[name]
        print(f"{name}: max_abs_err {r['max_abs_err']:.3g} kernel "
              f"{r['ms']:.3f} ms plain {r['plain_ms']:.3f} ms bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    return res


# reduced-storage cells: tag, cell of utils/profiling.py, steps, launches
# per step, storage; the main path's two cells in logu16 for 3 steps, one
# step of the other storages and of the other K1 modes
SPEC_FWD = dict(FWD, taumol_spec=1)
CELLS_SPEC = (
    ("clear_logu16", "clear_logu16", STEPS,
     dict(SPEC_FWD, cldcoef=0, rt_sweep=1, rt_sweep_spec=1), "logu16"),
    ("mcica_cloudy_logu16", "mcica_cloudy_logu16", STEPS,
     dict(SPEC_FWD, rt_sweep=1, rt_sweep_spec=1), "logu16"),
    ("mcica_cloudy_bf16", "mcica_cloudy", 1,
     dict(SPEC_FWD, rt_sweep=1, rt_sweep_spec=1), "bf16"),
    ("mcica_cloudy_f16", "mcica_cloudy", 1,
     dict(SPEC_FWD, rt_sweep=1, rt_sweep_spec=1), "f16"),
    ("band_cloudy_logu16", "band_cloudy", 1,
     dict(SPEC_FWD, rt_sweep_banded=1, rt_sweep_banded_spec=1), "logu16"),
    ("maxrand_cloudy_logu16", "maxrand_cloudy", 1,
     dict(SPEC_FWD, rt_sweep_maxrand=1, rt_sweep_maxrand_spec=1,
          overlap_rows=1), "logu16"),
    ("mcica_blocked_logu16", "mcica_blocked", 1,
     dict(SPEC_FWD, rt_sweep_fused=1, rt_sweep_fused_spec=1), "logu16"),
    ("mcica_tauc_logu16", "mcica_tauc", 1,
     dict(SPEC_FWD, cldcoef=0, rt_sweep_cldf_od=1, rt_sweep_cldf_od_spec=1),
     "logu16"))


def storage_cells(device, counters):
    """Each cell of CELLS_SPEC through the kernels with its storage, on an
    atmosphere with aerosol (AOD_SPEC), counted on its own; every K1
    launch must receive taug / fracs in that storage and the nonzero
    aerosol od apart (no add outside K1); fluxes held to the eager model
    with the same storage on the card, and to the float32 step: logu16
    within TOL_TAUMOL of max |flux|, bf16 / f16 printed."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    from rrtmg_lw_torch.ops.spec_codec import SPEC_DTYPES
    from rrtmg_lw_torch.utils.profiling import AOD_SPEC, CELLS
    launches, rows, seen = {}, [], []
    launch = rtrn_cuda._launch

    def spy(mode, wrapper, taut_t, *a, taua=None, **kw):
        seen.append((taut_t.dtype, taua))
        return launch(mode, wrapper, taut_t, *a, taua=taua, **kw)

    rtrn_cuda._launch = spy
    try:
        for tag, cell, steps, per_step, spec in CELLS_SPEC:
            atm, clouds = inputs(cell, device, aod=AOD_SPEC)
            need(float(atm.tauaer.min()) > 0.0,
                 f"{tag}: the atmosphere has no aerosol")
            c = CELLS[cell]
            model = c.make_model(device, spec=spec, impl="cuda")
            need(model.spec_dtype == SPEC_DTYPES[spec]
                 and model.reduced_storage, f"{tag}: storage not set")
            model(atm, clouds)                       # warm-up
            torch.cuda.synchronize()
            seen.clear()
            fk, ms, launches[tag] = counted_steps(tag, model, atm, clouds,
                                                  steps, counters, per_step)
            got = [(d, None if t is None else float(t.min()))
                   for d, t in seen]
            need(len(got) == steps and all(
                d == SPEC_DTYPES[spec] and t is not None and t > 0.0
                for d, t in got),
                 f"{tag}: K1 received {got} (storage, least aerosol od), "
                 f"expected taug in {SPEC_DTYPES[spec]} and the aerosol od "
                 "apart")
            fe, ms_e = run_steps(c.make_model(device, spec=spec,
                                              impl="eager"), atm, clouds, 1)
            err = compare_models(tag, fk, fe, clouds is not None)
            f32 = c.make_model(device, spec="", impl="cuda")(atm, clouds)
            e32 = max(rel_err(getattr(fk, n), getattr(f32, n))
                      for n in FLUX_NAMES)
            e32c = max(flux_err(getattr(f32, n).t(), getattr(fk, n).t())
                       for n in FLUX_NAMES)
            if spec == "logu16":
                need(e32 <= TOL_TAUMOL, f"{tag}: flux err vs the float32 "
                     f"step {e32:.3g} of max |flux| > {TOL_TAUMOL}")
            print(f"{tag}: flux err cuda vs eager {err:.3g}; vs the float32 "
                  f"step {e32:.3g} of max |flux| ({e32c:.3g} per column)"
                  + ("" if spec == "logu16" else ", not gated"))
            for impl, t in (("cuda", ms), ("eager", ms_e)):
                rows.append(dict(cell=tag, impl=impl, ncol=B_MAIN,
                                 nlay=L_MAIN, ms_per_step=t,
                                 cols_per_sec=B_MAIN / (t * 1e-3),
                                 err_vs_f32=e32,
                                 **(dict(launches=launches[tag])
                                    if impl == "cuda" else {})))
            del model, atm, clouds, fk, fe, f32
            torch.cuda.empty_cache()
    finally:
        rtrn_cuda._launch = launch
    return launches, rows


def peak_memory(device):
    """Peak device memory of one forward step of ``clear`` and
    ``mcica_cloudy``, in float32 and in logu16 storage (allocations since
    the reset after a warm-up step, the model and inputs included)."""
    from rrtmg_lw_torch.utils.profiling import CELLS
    out = {}
    for cell in ("clear", "mcica_cloudy"):
        atm, clouds = inputs(cell, device)
        for spec in ("", "logu16"):
            model = CELLS[cell].make_model(device, spec=spec, impl="cuda")
            model(atm, clouds)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model(atm, clouds)
            torch.cuda.synchronize()
            out[cell, spec or "f32"] = torch.cuda.max_memory_allocated()
            del model
            torch.cuda.empty_cache()
        print(f"peak memory {cell}: float32 {out[cell, 'f32'] / 2**30:.3f} "
              f"GiB, logu16 {out[cell, 'logu16'] / 2**30:.3f} GiB "
              f"({(out[cell, 'f32'] - out[cell, 'logu16']) / 1e9:.3f} GB "
              "less)")
    return out


def storage_grad_raises(device):
    """A gradient step of a logu16 model raises NotImplementedError on
    both impls (cuda at B=16384, eager on 256 columns)."""
    from rrtmg_lw_torch.parallel import make_grad_step
    from rrtmg_lw_torch.utils.profiling import CELLS
    atm, clouds = inputs("mcica_cloudy", device)
    for impl, (a, c) in (("cuda", (atm, clouds)),
                         ("eager", columns(atm, clouds, slice(0, 256)))):
        model = CELLS["mcica_cloudy_logu16"].make_model(device, impl=impl)
        try:
            make_grad_step(model)(a, c)
        except NotImplementedError as e:
            need("RRTMG_SPEC_DTYPE" in str(e), f"grad logu16 {impl}: {e}")
        else:
            need(False, f"grad logu16 {impl}: the backward did not raise")
        print(f"grad: a logu16 step raises NotImplementedError ({impl})")


def phase_probes(device):
    """The archived probes' counterparts (utils/probes.py): bitwise
    checks, then the one-hot and gather rates, launch latency and matmul
    rates.  -> (kernel entries, launches during the probes)."""
    from rrtmg_lw_torch.utils import probes
    probes.onehot_select.launches = probes.gather_rows.launches = 0
    m = probes.measure(device)
    launches = dict(probe_onehot=probes.onehot_select.launches,
                    probe_gather=probes.gather_rows.launches)
    for name, r in m.items():
        if name.startswith("onehot"):
            print(f"probe {name}: bitwise equal to tbl[idx]; kernel "
                  f"{r['ms']:.4f} ms = {r['tflops_as_archived']:.1f} TFLOP/s "
                  f"as test_mxu_rate.py counts (C R D 2), "
                  f"{r['tflops_done']:.1f} done, {r['gbps_written']:.0f} "
                  f"GB/s written; plain {r['plain_ms']:.3f} ms, tbl[idx] "
                  f"{r['library_ms']:.4f} ms")
        elif name.startswith("gather_onehot"):
            print(f"probe {name}: the one-hot's rows by the gather kernel, "
                  f"bitwise equal to tbl[idx]; {r['ms']:.4f} ms = "
                  f"{r['gbps_written']:.0f} GB/s written")
        elif name == "gather":
            print(f"probe gather (1760 x 16)[{probes.C_PROBE}]: bitwise "
                  f"equal to tbl[idx]; kernel {r['ms']:.4f} ms = "
                  f"{r['gbps_written']:.0f} GB/s written, "
                  f"{r['rows_per_s']:.3g} rows/s; plain {r['plain_ms']:.4f} "
                  f"ms, tbl[idx] {r['library_ms']:.4f} ms")
        elif name.startswith("matmul"):
            print(f"probe {name} {probes.MATMUL_N}^3 (torch.matmul): "
                  f"{r['ms']:.3f} ms = {r['tflops']:.1f} TFLOP/s; chained "
                  f"{r['chained_ms']:.3f} ms = {r['chained_tflops']:.1f}")
    print("probe launch latency, host ms per one-hot (bf16, dout 128) "
          "launch, n back to back: " + ", ".join(
              f"n={n} {t:.4f}" for n, t in m["latency_ms_per_iter"].items())
          + f"; dependent chain {m['chained_onehot_ms_per_iter']:.4f} ms")
    idx, tbl = probes.probe_inputs(device)
    gidx, gtbl = probes.probe_inputs(device, R=probes.R_GATHER,
                                     D=probes.D_GATHER)
    C, dout = probes.C_PROBE, probes.DOUT_PROBE
    kpad = (probes.R_PROBE + 15) // 16 * 16
    on, g = m[f"onehot_exact_{dout}"], m["gather"]
    res = {
        "probe_onehot": dict(
            max_abs_err=0.0, ms=on["ms"], plain_ms=on["plain_ms"],
            **bound((idx, tbl[:, :dout]), (), C * kpad * dout * 2 * 3,
                    nbytes=C * dout * 4, ops_rate=BF16_TC_OPS_PER_S,
                    library_ms=on["library_ms"])),
        "probe_gather": dict(
            max_abs_err=0.0, ms=g["ms"], plain_ms=g["plain_ms"],
            **bound((gidx, gtbl), (), 0, nbytes=gidx.numel() * gtbl.shape[1]
                    * 4, library_ms=g["library_ms"]))}
    return res, launches


def main() -> int:
    # importing the port first: from a directory without it this fails
    # before anything is printed
    from rrtmg_lw_torch import _build
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.planck_cuda import (planck_interp_blocked,
                                                planck_interp_vjp)
    from rrtmg_lw_torch.ops.rtrn_cuda import (rt_fluxes_banded,
                                              rt_fluxes_blocked,
                                              rt_fluxes_cldf_od,
                                              rt_fluxes_fused,
                                              rt_fluxes_maxrand,
                                              rt_sweep_vjp)
    from rrtmg_lw_torch.ops.rtrnmr_cuda import overlap_rows
    from rrtmg_lw_torch.ops.taumol_cuda import taumol_blocked, taumol_vjp
    from rrtmg_lw_torch.utils import profiling

    need(profiling.NCOL == B_MAIN
         and all(c.nlay == L_MAIN for k, c in profiling.CELLS.items()
                 if k != "mcica_cloudy_deep")
         and profiling.CELLS["mcica_cloudy_deep"].nlay == L_DEEP,
         "the cells' inputs are not of this script's shapes")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = nvidia_smi_line()
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    print(smi, flush=True)

    # 2. build
    path, secs = _build.build()
    _build.library()
    print(f"build: {path} in {secs:.1f} s", flush=True)
    for line in (path.parent / "build.log").read_text().splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    k1_build = k1_build_info(path.parent / "build.log")
    for key, r in k1_build.items():
        print(f"K1 {key}: {r['registers']} registers, {r['spill_bytes']} B "
              f"spill stores, {r['smem_bytes']} B shared memory, "
              f"{r['blocks_per_sm']} blocks per SM, ring of "
              f"{r['ring_levels']} levels")
    k6_build = k6_build_info(path.parent / "build.log")
    for key, r in k6_build.items():
        print(f"K6 {key}: {r['registers']} registers, {r['spill_bytes']} B "
              f"spill stores, {r['smem_bytes']} B shared memory, "
              f"{r['blocks_per_sm']} blocks per SM, ring of "
              f"{r['ring_levels']} levels")
    k2_build = k2_build_info(path.parent / "build.log")
    for key, r in k2_build.items():
        print(f"K2 {key}: {r['registers']} registers, {r['spill_bytes']} B "
              f"spill stores, {r['smem_bytes']} B shared memory, "
              f"{r['blocks_per_sm']} blocks per SM")
    k5_build = k5_build_info(path.parent / "build.log")
    print(f"K5: {k5_build['registers']} registers, "
          f"{k5_build['spill_bytes']} B spill stores, "
          f"{k5_build['local_bytes']} B local memory, "
          f"{k5_build['smem_bytes']} B shared memory, "
          f"{k5_build['blocks_per_sm']} blocks per SM (launch bounds "
          f"{k5_build['min_blocks']})")

    # 3. kernels vs plain versions; then K2 and K1 in reduced storage
    res = phase_kernels(device)
    torch.cuda.empty_cache()
    grad_dev = grad_device_times()
    torch.cuda.empty_cache()
    res.update(phase_storage_kernels(device))
    torch.cuda.empty_cache()

    # 4. end to end, each cell with its own launch counts: clear and
    # McICA, then the deterministic clouds
    counters = {"taumol": taumol_blocked, "planck": planck_interp_blocked,
                "cldcoef": ice_liq_coeffs_blocked,
                "rt_sweep": rt_fluxes_blocked}
    fwd_counters = dict(counters, rt_sweep_save=rt_fluxes_blocked.save,
                        rt_sweep_banded=rt_fluxes_banded,
                        rt_sweep_maxrand=rt_fluxes_maxrand,
                        overlap_rows=overlap_rows,
                        rt_sweep_fused=rt_fluxes_fused,
                        rt_sweep_cldf_od=rt_fluxes_cldf_od,
                        rt_sweep_idrv=rt_fluxes_blocked.idrv,
                        rt_sweep_banded_idrv=rt_fluxes_banded.idrv,
                        rt_sweep_maxrand_idrv=rt_fluxes_maxrand.idrv,
                        rt_sweep_fused_idrv=rt_fluxes_fused.idrv,
                        rt_sweep_cldf_od_idrv=rt_fluxes_cldf_od.idrv,
                        taumol_spec=taumol_blocked.spec,
                        rt_sweep_spec=rt_fluxes_blocked.spec,
                        rt_sweep_banded_spec=rt_fluxes_banded.spec,
                        rt_sweep_maxrand_spec=rt_fluxes_maxrand.spec,
                        rt_sweep_fused_spec=rt_fluxes_fused.spec,
                        rt_sweep_cldf_od_spec=rt_fluxes_cldf_od.spec)
    cell_launches, rows = forward_cells(
        device, fwd_counters, CELLS_MAIN + CELLS_BAND + CELLS_PER_G
        + CELLS_IDRV)
    extra_steps(device, fwd_counters)
    # the reduced-storage cells (K7), and peak memory f32 vs logu16
    spec_launches, spec_rows = storage_cells(device, fwd_counters)
    cell_launches.update(spec_launches)
    rows += spec_rows
    peak_memory(device)
    # each kernel's launches: those of the first cell that runs it
    launches = {}
    for counts in cell_launches.values():
        for k, n in counts.items():
            if n and k not in launches:
                launches[k] = n

    # 5. deep
    rows += phase_deep(device, counters)
    torch.cuda.empty_cache()

    # 6. grad: backward kernels vs plain vjps, then the gradient step
    res.update(phase_grad_kernels(device))
    for name, ms in grad_dev.items():
        res[name]["device_ms"] = ms
    torch.cuda.empty_cache()
    counters.update(taumol_bwd=taumol_vjp, planck_bwd=planck_interp_vjp,
                    rt_adjoint=rt_sweep_vjp,
                    rt_sweep_save=rt_fluxes_blocked.save)
    grad_launches, grad_rows = phase_grad_step(device, counters)
    rows += grad_rows
    phase_grad_idrv(device)
    storage_grad_raises(device)
    torch.cuda.empty_cache()
    launches.update({k: grad_launches[k] for k in (
        "taumol_bwd", "planck_bwd", "rt_adjoint", "rt_sweep_save")})

    # 7. the archived probes' counterparts
    probe_res, probe_launches = phase_probes(device)
    res.update(probe_res)
    launches.update(probe_launches)
    for r in rows:
        print("e2e " + json.dumps(r))

    launches["rt_sweep_clear"] = cell_launches["clear"]["rt_sweep"]
    for name, key in K1_LINES.items():
        r = res[name]
        r.update(k1_build[key], instantiation=key,
                 gbps=r["bytes_once"] / (r["device_ms"] * 1e-3) / 1e9)
        print(f"{name} ({key}): device {r['device_ms']:.3f} ms, "
              f"{r['gbps']:.0f} GB/s of its bytes read once, bound "
              f"{r['bound_ms']:.3f} ms")
    res["rt_sweep"]["k1_instantiations"] = k1_build
    r = res["rt_adjoint"]
    r.update(k6_build["compact"], instantiation="compact",
             gbps=r["bytes_once"] / (r["device_ms"] * 1e-3) / 1e9)
    print(f"rt_adjoint (compact): device {r['device_ms']:.3f} ms, "
          f"{r['gbps']:.0f} GB/s of its bytes read once, bound "
          f"{r['bound_ms']:.3f} ms")
    r = res["taumol_bwd"]
    r.update(k5_build, gbps=r["bytes_once"] / (r["device_ms"] * 1e-3) / 1e9)
    print(f"taumol_bwd: device {r['device_ms']:.3f} ms, {r['gbps']:.0f} GB/s "
          f"of its bytes read once, bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']})")
    for name, key in K2_LINES.items():
        r = res[name]
        r.update(k2_build[key], instantiation=key,
                 gbps=r["bytes_once"] / (r["device_ms"] * 1e-3) / 1e9)
        print(f"{name} ({key}): device {r['device_ms']:.3f} ms, "
              f"{r['gbps']:.0f} GB/s of its bytes read once, bound "
              f"{r['bound_ms']:.3f} ms")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **res[name])
               for name, src, rep in KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
