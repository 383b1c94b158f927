#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (``rrtmg_lw_torch``).

Run from the repository root on a machine with one CUDA GPU (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels from csrc/ (one nvcc per source, in
     parallel), timed, with the registers and spills ptxas reports; for
     each of K1's 72 instantiations (48, and the 24 of the gradient step
     that keep the radiances for K6, every mode at idrv 0 and 1 in
     float32 by either store path, bulk tensor stores or scalar stores,
     which must not spill) its registers
     and spill stores, its shared memory per block, blocks per SM (the
     CUDA occupancy API) and levels in its ring, the same (but the ring)
     for K2's 4, K6's registers and spill stores, and K5's registers,
     spill stores, local memory, shared memory and blocks per SM (it must
     not spill and must fit its MIN_BLOCKS launch bound); the overlap
     rows', their adjoint's, K6 maxrand's, K6's in the banded, fused and
     cldf-odcld modes and K4b's registers and spill stores (none may
     spill; each K6 fits two blocks per SM; K6 banded, fused and
     cldf-odcld at L=60 and L=140, with no local memory, their tile,
     ring and staging printed); K6's six instantiations with the d/dT
     sweep's adjoint (one a mode: registers, spill stores, local memory,
     shared memory and blocks per SM at L=60 and L=140; none may spill);
  2b. configs (``phase_configs``), the configurations the kernels do not
     cover whole, through ``make_model`` at B=16384, L=60, each step
     counted: (a) the default config (float64, use_lut=True: the plain
     sweep on the card) against the same model on the CPU on 256 columns
     within 1e-10 of a column's max |flux|, the lookup-table indices that
     differ between the two counted; (b) float32 use_lut=True, clear and
     McICA: K2, K3 and (cloudy) K4 launch, K1 does not, the fluxes within
     5e-3 W/m2 (tests/test_f32_accuracy.py's gate) and the heating rates
     within 0.1 K/day (the reference's contract; that test's 0.05 gate
     printed beside) of the float64 LUT step on the card, and the closed
     form through K1 clear against the float64 closed form, the same
     gates (the control), with the thinnest top layer and the heating
     rate one float32 ulp of its flux moves; (c) band subsets (16, 16)
     and (5, 9), McICA, the same, against the CPU's float64 step on 256
     columns; (d) per-band clouds (imca=0) on make_ncbands_clouds (final
     ncbands 1, 5 and 16), icld 1 and 2 with (iceflag, liqflag) (1, 1),
     (0, 1) and (3, 0), and icld=4, through K1 banded / maxrand: K1
     against its plain twin on the inputs the step gave it within
     TOL_FLUX, bitwise over two runs, the step against eager; (e) McICA
     with iceflag 1, liqflag 0 (no K4) through K1 compact, the same; (f)
     one gradient step of (b)'s McICA at 4096 columns (w.r.t. the
     Atmosphere, water paths and radii: K5, K3b and K4b, no K1 or K6)
     within TOL_STEP of eager per field; the wall, device busy,
     columns/s and peak of (a), (b), (f) and one (d) step on ``configs``
     lines;
  2c. McICA sampling (``phase_mcica``): K8 (csrc/mcica.cu) bitwise equal
     to its plain version (ops/mcica.py ``subcol_mask``: the Philox draw
     and the overlap walk) at B=2048 and B=2051 (its two store paths:
     whole-line vector stores where B % 4 == 0, element stores
     elsewhere), L=60 and L=140, and at B=16384, L=60, icld 1-5, float32
     and float64 in, int8 and float masks, also fed given uniforms (the
     overlap walk alone against ``mask_from_uniforms``), each launch's
     store path counted (``subcol_mask.vector`` / ``.scalar``); the
     hand-written Philox4x32-10 equal to curand_Philox4x32_10 and to the
     plain version on 4096 counters; tests/test_mcica.py's statistics on
     K8's output at B=16384 (per-layer cloudy fraction, pairwise overlap,
     the binomial envelope); the generate-then-radiate step (utils/profiling.py's
     ``mcica_generate`` cells: K8 then K2, K3, K4 and K1 compact, icld 2
     and icld 4 with ``get_alpha``) at B=16384, L=60, 3 steps counted on
     every counter, held to the eager model on the same mask under
     ``compare_models``' gates, then profiled beside ``mcica_cloudy`` (the
     same step on fixed clouds: wall, busy, idle share, launches, K8's ms
     in the step, peak); K8's wrapper, plain and
     torch.rand-of-its-uniforms ms, registers and spills of its 64
     instantiations (none may spill);
  2d. the column-mode CLI (``phase_cli``): ``cli.run_case`` on a clear
     and a McICA deck (nmca=2) written to a temporary directory, on the
     card (its raws computed there) within 1e-10 of the CPU run;
  2e. the parallel layer (``phase_parallel``) on a one-rank NCCL process
     group: the GCM entry point (``rrtmg_lw_torch.examples.gcm_step``)
     through ``make_sharded_step`` and ``run_epoch`` at B=16384, counted,
     its fluxes bitwise the model's on the same batch, the metrics equal
     torch reductions, ``make_sharded_grad_step`` within 1e-6 of
     ``make_grad_step`` at B=4096; K9 (csrc/wire.cu) against its plain
     twin at B=16384 and 2051 (logratio within 2 ulps, the other codecs,
     the ok flags on six corruptions and the mask unpack bitwise); the C++
     wire encoder required, bitwise the numpy one; the wire entry point
     (``examples.wire_streaming``: K9, K8, K2, K3, K4, K1 compact)
     counted, within TOL_FLUX of its step through the plain decode, and a
     corrupted batch flagged in exactly its columns; the ``gcm_step`` and
     ``wire_stream`` cells of utils/profiling.py (wall, the prefetch
     overlap against depth 0, busy, idle, launches, bytes a column, peak);
     K9's wrapper, device, plain and bound ms, registers and spills;
  2f. observability and on-card verification (``phase_verify``): (a)
     ``rrtmg_lw_torch.tools.gpu_verify``'s checks at their defaults (the
     JAX package's tools/tpu_verify.py by name and tolerance: K2 and K3
     against their plain versions, every model configuration through the
     kernels against eager, the isothermal enclosure against the
     blackbody quadrature, the wire format decoded and sampled on the
     card, L=140, B=16384), each printed, all required; (b) the
     sensitivities entry point (``examples.sensitivities.sensitivities``)
     at B=16384, L=60, float32: K2, K3 (two launches), K1 SAVE clear at
     idrv=1, K6 clear, K5 and K3b counted (K6's d/dT instantiation
     never: the loss reads no d/dT), dOLR/dT, dOLR/dln q, dOLR/dTsfc and
     the idrv derivative at the top within TOL_STEP of max |eager| (the
     eager pass in column chunks), the dOLR/dTsfc cross-check printed,
     with the step's wall, device busy and peak; (c)
     ``utils.device_time.device_seconds_per_iter`` on the
     ``mcica_cloudy`` step, positive, beside ``profile_cell``'s busy and
     the glue's largest ops; (d) ``ThroughputMeter`` over 10
     ``mcica_cloudy`` steps and ``device_memory_stats``, whose peak must
     be ``max_memory_allocated``'s;
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
     with an input cloud od) and each at idrv=1, and the overlap rows
     (bitwise equal to the plain version's, with their device ms), each
     also bitwise equal over two runs, the idrv=1 flux rows bitwise
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
     must raise; the maxrand gradient's kernels on the band_cloudy
     cell's clouds and on mixed_clouds' (K1 and K6 also on K1's edge
     cases): the overlap adjoint within TOL_BWD of the plain vjp of
     rtrnmr.overlap_rows, K1 keeping the maxrand state (its fluxes
     bitwise K1's, the state within TOL_RADS of the plain sweep's, the
     sub-streams where K1 keeps them), K6 maxrand fed it within
     TOL_BWD_RT of the plain vjp on B_SUB columns (zeros in the flag
     rows; without the state it raises; unchanged with NaN in the
     sub-streams K1 does not keep), each bitwise over two runs; the
     banded, fused and cldf-odcld gradients' kernels on the band_cloudy
     (and mixed_clouds'), mcica_blocked and mcica_tauc cells' clouds and
     on K1's edge cases: K1 keeping the radiances in the mode (fluxes
     bitwise K1's, radiances within TOL_RADS of the plain sweep's), K6 in
     the mode fed them within TOL_BWD_RT of the plain vjp on B_SUB
     columns (the pad rows of its per-g cotangents zero; without the
     radiances it raises; fused and cldf-odcld fed the cloudy-layer
     words K1 kept, equal to the plain ones), and K4b within TOL_BWD of
     the plain vjp on the mcica_blocked cell's radii and on radii off and
     on the tables' grid, each bitwise over two runs; K6 with the d/dT
     sweep's adjoint in the six modes (``ddt_grad_kernels``: at L=60 on
     phase 3's inputs with each mode's cell clouds, on their first 37
     and B_ODD columns and at L=140, fed the state K1 kept (compact's on
     K6-g's tile, fed K1 SAVE compact's cloudy-layer words; on the
     band-group tile staged by bulk copies where the rows allow them,
     compact's where B % 16 == 0), within TOL_BWD_RT of
     the plain vjp of the sweep on seeded flux and d/dT cotangents on
     B_SUB columns, at L=60 also without the flux cotangent, bitwise over
     two runs, the cotangent of dplankbnd_dt nonzero; the d/dT
     derivatives K1 SAVE keeps at idrv=1 in every mode but clear, which
     their d/dT K6 reads in place of a scratch (``rtrn_cuda.KEEPS_DDT``),
     within TOL_DDT_PLANES of the plain sweep's in float64); K1 keeping the
     state by both store paths (``k1_save_cases``): every mode at idrv 0
     and 1 on the cell, K1's edge cases, L_DEEP, B=4100 (bulk tensor
     stores, a last tile of 4 columns) and B=37 (scalar stores), the path
     each case took printed and held to B % 4, fluxes bitwise K1's,
     radiances (maxrand: the state) within TOL_RADS of plain, bitwise
     over two runs, in fused, cldf-odcld and compact at idrv=1 the words
     equal to the plain ones and K6 (compact: its d/dT) fed them within
     TOL_BWD_RT of the plain vjp; then the
     gradient step
     (make_grad_step, the default loss, w.r.t. every Atmosphere field) at B=16384, L=60 through the kernels: McICA,
     3 timed steps with the launch counters reset just before and read
     just after (K1 keeping the radiances once a step, and never in a
     forward cell), peak memory; its gradients of a column-sum loss, linear
     in the four flux arrays with seeded cotangents, held on all 16384
     columns against the eager step's (run in column chunks); clear sky,
     1 step, the same check; then the maxrand gradient step
     (maxrand_cloudy_grad, BandClouds, icld=2) w.r.t. every
     Atmosphere field and the cloud fraction and water paths: 3 timed
     steps counted the same way (K2, K3, K4, the overlap rows, K1 keeping
     the maxrand state, K6 maxrand, K5, K3b and the overlap adjoint, once
     each a step but K3 and K3b twice; K1's state launch never in a
     forward cell), peak memory, the linear-loss gradients on all 16384
     columns within TOL_STEP of the eager step's; the banded, fused and
     cldf-odcld gradient steps the same way: band_cloudy_grad (icld=1, K1 banded,
     w.r.t. the Atmosphere, the cloud fraction, water paths and
     effective radii: K1 keeping the radiances, K6 banded and K4b once
     a step), mcica_blocked_grad (K1 fused, w.r.t. every
     McicaCloudsBlocked field) and mcica_tauc_grad (K1 cldf-odcld, w.r.t.
     cldfmc and taucmc); then the d/dT
     adjoint's main path, the gradient step at idrv=1 of a loss linear in uflx,
     duflx_dt and duflxc_dt in each mode (utils/profiling.py's
     ``*_ddt_grad`` cells: clear, McICA, banded, maxrand, also at icld=3,
     fused, cldf-odcld; w.r.t. the Atmosphere and the cell's cloud
     fields), counted (K6
     with the d/dT adjoint once a step, the idrv=0 K6 never), its ms a
     step and peak memory, held to the eager step within TOL_STEP per
     field the same way; the McICA and the maxrand steps at idrv=1 with
     the default loss bitwise equal to idrv=0's; a logu16 grad step
     raising NotImplementedError on both impls;
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
"rt_sweep" the table of all 72 K1 instantiations and K1 compact's
device, plain and bound ms at L=140 (``k1_deep``: *_deep); the K1 SAVE
entries (rt_sweep_save*) the store path of each of their mode's
``k1_save_cases``; K6's entry
(rt_adjoint) its registers, spill bytes, device_ms and GB/s, and K5's
(taumol_bwd) the same with its shared memory and blocks per SM; K5's
bound counts its operations and cotangent bytes per (band, region)
(``taumol_bwd_work``); the overlap rows', their adjoint's, every other
K6's and K4b's entries their registers, spill bytes and GB/s; the bounds
of K1 SAVE maxrand and K6 maxrand count the sub-streams only where K1
keeps them and K6 reads them (cloudy layers without a restart), those
of K1 SAVE and K6 fused and cldf-odcld the per-g water paths and cloud
od only where the g-point's gate holds (the only places they are read),
and the plain_ms of K6 in those four modes is the plain vjp's on
plain_ncol columns; K6 banded, fused and cldf-odcld's entries also carry
bytes_moved and gbps_moved (every access the kernel makes,
``k6g_traffic``), their tile, ring slots and staging; the
overlap kernels are timed on rotating copies of their inputs (L2 cold,
``utils.snapshot.rotating``).
K5's, K6's, K1 SAVE's (every mode) and K8's device_ms come from
``utils/snapshot.py --k5-times --k6-times --k6-ddt-times --k8-times`` in
a process of its own, started after phase 3; the entries of K6 with the d/dT
adjoint (rt_adjoint_ddt_<mode>) also carry device_ms_deep (L=140), their
registers, spill, shared memory and blocks per SM, scratch_gb (the bytes
of clear's scratch, written and read once, beside the bound; 0 in the
modes whose K6 reads K1 SAVE's derivatives), and the device ms of K1 SAVE
at idrv=1 in the mode and the pair's sum (k1_save_idrv_ms, ddt_pair_ms;
at L=140 *_deep), printed on a ``ddt pair`` line a mode.  Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
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
# K1 SAVE's d/dT derivatives (rads planes 4-5, idrv=1 in KEEPS_DDT: every
# mode but clear) against the plain sweep's in float64 on the same inputs,
# of max |plain|
TOL_DDT_PLANES = 1e-6
# the grad step against the eager one, per Atmosphere field / max |eager|,
# for a loss linear in the fluxes: f32 against f64 on the CPU reads
# <= 1.1e-5 (tests/test_torch_grad.py::test_f32_gradient_conditioning)
TOL_STEP = 1e-4
# columns of the plain vjp of the maxrand sweep that K6 maxrand is held
# to (autograd through the plain sweep at full width would hold ~10x the
# saved state), and of its plain time
B_SUB = 2048
# columns whose rows of floats are 16-byte aligned but the compact mask's
# int8 rows are not (B % 16 == 4): K6-g's compact d/dT stages every row
# element by element there
B_ODD = 2052

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
           rt_ddt=10, spec_codec=10, overlap_bwd=150, rt_adjoint_mr=160,
           cldcoef_bwd=6)
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

# K8's operations, counted from csrc/mcica.cu: a Philox4x32-10 call (10
# rounds of 2 high and 2 low 32-bit products and 4 xors; the four words'
# shift, conversion and scale; the key schedule is shared by all calls),
# and per (layer, g-point, column) the overlap walk's subtract, compare,
# select or multiply, the mask's compare and conversion
PHILOX_OPS = 92
MCICA_OPS = 5

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
    # the maxrand gradient: the overlap rows' adjoint, K1 keeping the
    # maxrand state, K6 maxrand (XLA's vjp in the JAX package)
    ("overlap_bwd", "rrtmg_lw_torch/csrc/overlap.cu",
     "rrtmg_lw_tpu/ops/rtrn_pallas.py:1208"),
    ("rt_sweep_save_maxrand", K1_SRC, "rrtmg_lw_tpu/ops/rtrn_pallas.py:140"),
    ("rt_adjoint_maxrand", "rrtmg_lw_torch/csrc/rtrn_bwd_mr.cu",
     "rrtmg_lw_tpu/ops/rtrn_pallas.py:1208"),
) + tuple(
    # the banded, fused and cldf-odcld gradients: K1 keeping the radiances
    # in the mode, K6 in the mode (XLA's vjp of the random-overlap sweep
    # in the JAX package), and K4b (XLA's vjp of _ice_liq_coeffs)
    (f"rt_sweep_save_{m}", K1_SRC, "rrtmg_lw_tpu/ops/rtrn_pallas.py:140")
    for m in ("banded", "fused", "cldf_od")) + tuple(
    (f"rt_adjoint_{m}", "rrtmg_lw_torch/csrc/rtrn_bwd_g.cu",
     "rrtmg_lw_tpu/ops/rtrn_pallas.py:1040")
    for m in ("banded", "fused", "cldf_od")) + (
    ("cldcoef_bwd", "rrtmg_lw_torch/csrc/cldcoef.cu",
     "rrtmg_lw_tpu/ops/cldprop.py:43"),
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
# K1's modes, and K6's instantiation in each that also runs the d/dT
# sweep's adjoint (idrv=1 with a cotangent of duflx_dt / duflxc_dt): XLA's
# vjp of the Pallas sweep in the JAX package, its unrolled backward taking
# no idrv
DDT_MODES = ("clear", "compact", "banded", "maxrand", "fused", "cldf_od")
# K6's d/dT instantiations at two blocks per SM may spill a few bytes
# (maxrand's 4, banded's 4; at one block per SM, spill-free, they ran
# 1.4-1.6x longer: PERF.md section 6): a gate against heavier spilling
# (compact on K1's 16 x 16 tile at two blocks: 386 B); each is held to 128
# registers and two blocks per SM
DDT_SPILL_MAX = 64
DDT_SOURCES = {"clear": "rtrn_bwd.cu", "compact": "rtrn_bwd_g.cu",
               "maxrand": "rtrn_bwd_mr.cu", "banded": "rtrn_bwd_g.cu",
               "fused": "rtrn_bwd_g.cu", "cldf_od": "rtrn_bwd_g.cu"}
KERNELS += tuple(
    (f"rt_adjoint_ddt_{m}", "rrtmg_lw_torch/csrc/" + DDT_SOURCES[m],
     "rrtmg_lw_tpu/ops/rtrn_pallas.py:" + ("1208" if m == "maxrand"
                                           else "1040"))
    for m in DDT_MODES)
# K8, the McICA sampler: the counterpart of an XLA scan (no Pallas original)
KERNELS += (("mcica", "rrtmg_lw_torch/csrc/mcica.cu",
             "rrtmg_lw_tpu/ops/mcica.py:164"),)
# K9, the wire format's decode: the counterpart of XLA's fusion of the jnp
# decoders (no Pallas original)
KERNELS += (("wire_decode", "rrtmg_lw_torch/csrc/wire.cu",
             "rrtmg_lw_tpu/parallel/wire.py:400"),)


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
    from rrtmg_lw_torch.utils.snapshot import rotating

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
    # the overlap rows first (bitwise equal to the plain version's), then
    # K1 banded and maxrand on them; times on the main path's clouds
    _, bc = inputs("band_cloudy", device)
    errs = {k: [] for k in ("overlap_rows", "rt_sweep_banded",
                            "rt_sweep_maxrand")}
    for tag, b in (("decks", bc), ("mixed", mixed_clouds(bc, device))):
        cldf = b.cldfrac
        rows_k, rows_p = overlap_rows(cldf), rtrnmr.overlap_rows(cldf)
        nbad = int((rows_k != rows_p).sum())
        need(nbad == 0, f"overlap_rows ({tag}): {nbad} of {rows_k.numel()} "
             f"rows' elements differ from plain, by up to "
             f"{float((rows_k - rows_p).abs().max()):.3g}")
        need(torch.equal(rows_k, overlap_rows(cldf)),
             f"overlap_rows ({tag}): two runs differ")
        errs["overlap_rows"].append((0.0, 0.0))
        print(f"overlap_rows ({tag}): bitwise equal to plain, nonzero "
              f"factors {float((rows_p[:, 4:] != 0).double().mean()):.1%}")
        if tag == "decks":
            # the fractions (3.9 MB) would stay in L2 across repeats
            cold = rotating(overlap_rows, cldf)
            res["overlap_rows"] = dict(
                ms=cuda_ms(cold, 20),
                device_ms=device_ms(cold, reps=20, symbol="overlap_kernel"),
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


def k1_deep(device):
    """K1 compact at L_DEEP on the mcica_cloudy_deep cell's sweep inputs
    (``utils.snapshot.sweep_inputs``): within TOL_FLUX of the plain
    version, its device ms, the plain version's ms and its bound, formed
    as ``phase_kernels``' rt_sweep entry forms them at L_MAIN: ->
    {device_ms_deep, plain_ms_deep, bound_ms_deep}."""
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.rtrn_cuda import rt_fluxes_blocked
    from rrtmg_lw_torch.utils.snapshot import compact_args, sweep_inputs
    x = sweep_inputs(device, "mcica_cloudy_deep")
    args, fields = x["args"], compact_args(x["static"], x["mc"])
    L, _, B = args[0].shape

    def kernel():
        return rt_fluxes_blocked(*args, cloud_fields=fields)

    def plain():
        return rtrn.rt_fluxes_blocked(*args, cloud_fields=fields)
    fk = kernel()
    e = flux_err(plain(), fk)
    need(bool(torch.isfinite(fk).all()) and e <= TOL_FLUX,
         f"rt_sweep at L={L}: flux err {e:.3g} > {TOL_FLUX}")
    ncld = int((fields[0][:, :140] != 0).any(1).sum())
    out = dict(device_ms_deep=device_ms(kernel),
               plain_ms_deep=cuda_ms(plain, 1),
               bound_ms_deep=bound((*args, *fields), (fk,), 140 * (
                   OPS["rt_clear"] * L * B + OPS["rt_cloud"] * ncld))[
                       "bound_ms"])
    print(f"rt_sweep (compact) at L={L}: flux err {e:.3g}, device "
          f"{out['device_ms_deep']:.3f} ms, plain {out['plain_ms_deep']:.3f}"
          f" ms, bound {out['bound_ms_deep']:.3f} ms")
    return out


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
    idrv<0|1> <storage>[ save <path>]": {...}}, " save bulk" and " save
    scalar" the 24 that keep the radiances for K6 (every mode, float32,
    by either store path)."""
    from rrtmg_lw_torch._build import ptxas_info
    from rrtmg_lw_torch.ops.rtrn_cuda import MODES, SAVE_PATHS, k1_info
    from rrtmg_lw_torch.ops.spec_codec import SPEC_DTYPES
    names = {v: k for k, v in MODES.items()}
    paths = {v: k for k, v in SAVE_PATHS.items()}
    storages = ("f32",) + SPECS

    def key(m):
        mode, idrv, spec, save = (int(x) for x in m.groups())
        return (f"{names[mode]} idrv{idrv} {storages[spec]}"
                + (f" save {paths[save]}" if save else ""))
    out = ptxas_info(log_path, r"rt_kernelILi(\d)ELb([01])ELi(\d)ELi(\d)E",
                     key)
    for key, r in out.items():
        mode, idrv, spec, *save = key.split()
        info = k1_info(mode, int(idrv[-1]),
                       SPEC_DTYPES.get(spec, torch.float32),
                       save[1] if save else None)
        need(info["registers"] == r.get("registers"),
             f"K1 {key}: {info['registers']} registers at run time, ptxas "
             f"said {r.get('registers')}")
        r.update(smem_bytes=info["static_smem"] + info["dynamic_smem"],
                 blocks_per_sm=info["blocks_per_sm"],
                 ring_levels=info["ring_levels"])
    need(len(out) == 72 and all(len(r) == 5 for r in out.values()),
         f"K1: {len(out)} instantiations in the build log, expected 72")
    need(all(out[k]["spill_bytes"] == 0 for k in out if " save " in k),
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


def new_build_info(log_path):
    """Registers and spill stores of the kernels of the last two slices
    (``_build.ptxas_info``): the overlap rows and their adjoint, K6
    maxrand, K6 in the banded, fused and cldf-odcld modes (with their
    launch configurations at L_MAIN, ``rtrn_cuda.k6_mr_info``,
    ``k6_g_info``) and K4b; fails where one spills, or a K6 fits fewer
    than two blocks per SM.  -> {name: {...}}."""
    from rrtmg_lw_torch._build import ptxas_info
    from rrtmg_lw_torch.ops.rtrn_cuda import MODES, k6_g_info, k6_mr_info
    names = {"14overlap_kernelE": "overlap_rows",
             "18overlap_bwd_kernelE": "overlap_bwd",
             "16rt_bwd_mr_kernelE": "rt_adjoint_maxrand",
             "18cldcoef_bwd_kernelE": "cldcoef_bwd"}
    names.update({f"15rt_bwd_g_kernelILi{MODES[m]}EE": f"rt_adjoint_{m}"
                  for m in ("banded", "fused", "cldf_od")})
    out = ptxas_info(log_path, "|".join(names),
                     lambda m: names[m.group(0)])
    need(sorted(out) == sorted(names.values())
         and all(len(r) == 2 for r in out.values()),
         f"new kernels: {sorted(out)} in the build log")
    infos = {"rt_adjoint_maxrand": k6_mr_info(L_MAIN)}
    infos.update({f"rt_adjoint_{m}": k6_g_info(m, L_MAIN)
                  for m in ("banded", "fused", "cldf_od")})
    deep = {"rt_adjoint_maxrand": k6_mr_info(L_DEEP)}
    deep.update({f"rt_adjoint_{m}": k6_g_info(m, L_DEEP)
                 for m in ("banded", "fused", "cldf_od")})
    for name, info in infos.items():
        need(info["registers"] == out[name]["registers"],
             f"{name}: registers at run time differ from ptxas'")
        out[name].update(smem_bytes=info["static_smem"]
                         + info["dynamic_smem"],
                         blocks_per_sm=info["blocks_per_sm"])
    for name, info in deep.items():
        # K6 maxrand and K6-g: the tile and ring at L_DEEP
        out[name].update(threads=info["threads"], columns=info["columns"],
                         ring_slots=info["ring_levels"],
                         smem_bytes_deep=info["static_smem"]
                         + info["dynamic_smem"],
                         blocks_per_sm_deep=info["blocks_per_sm"])
    need(all(r["spill_bytes"] == 0 for r in out.values())
         and all(i["blocks_per_sm"] >= 2 and i["local_bytes"] == 0
                 for i in (*infos.values(), *deep.values())),
         f"new kernels: spill stores, local memory or a K6 of fewer than "
         f"two blocks per SM (at L={L_MAIN} or {L_DEEP}): {out}")
    return out


def ddt_build_info(log_path):
    """Registers and spill stores (``_build.ptxas_info``) and launch
    configuration (``rtrn_cuda.k6_info``, ``k6_mr_info``, ``k6_g_info``
    with ``ddt=True``, at L_MAIN and L_DEEP) of K6's instantiations with
    the d/dT sweep's adjoint, one a mode (compact's on K6-g's tile); fails
    where one spills more than DDT_SPILL_MAX bytes, takes more than 128
    registers or fits fewer than two blocks per SM.  -> {summary name:
    {...}}."""
    from rrtmg_lw_torch._build import ptxas_info
    from rrtmg_lw_torch.ops.rtrn_cuda import (MODES, k6_g_info, k6_info,
                                              k6_mr_info)
    names = {"17rt_bwd_ddt_kernelILb0EE": "rt_adjoint_ddt_clear",
             "20rt_bwd_mr_ddt_kernelE": "rt_adjoint_ddt_maxrand"}
    names.update({f"19rt_bwd_g_ddt_kernelILi{MODES[m]}EE":
                  f"rt_adjoint_ddt_{m}" for m in ("compact", *G_MODES)})
    out = ptxas_info(log_path, "|".join(names), lambda m: names[m.group(0)])
    need(sorted(out) == sorted(names.values())
         and all(len(r) == 2 for r in out.values()),
         f"d/dT adjoint: {sorted(out)} in the build log")

    def info(mode, nlay):
        if mode == "clear":
            return k6_info(False, ddt=True)
        if mode == "maxrand":
            return k6_mr_info(nlay, ddt=True)
        return k6_g_info(mode, nlay, ddt=True)
    for mode in DDT_MODES:
        r = out[f"rt_adjoint_ddt_{mode}"]
        i, d = info(mode, L_MAIN), info(mode, L_DEEP)
        need(i["registers"] == r["registers"],
             f"rt_adjoint_ddt_{mode}: registers at run time differ from "
             "ptxas'")
        r.update(smem_bytes=i["static_smem"] + i["dynamic_smem"],
                 blocks_per_sm=i["blocks_per_sm"],
                 local_bytes=max(i["local_bytes"], d["local_bytes"]),
                 threads=i["threads"], columns=i["columns"],
                 smem_bytes_deep=d["static_smem"] + d["dynamic_smem"],
                 blocks_per_sm_deep=d["blocks_per_sm"])
    need(all(r["spill_bytes"] <= DDT_SPILL_MAX
             and r["local_bytes"] <= DDT_SPILL_MAX and r["registers"] <= 128
             and min(r["blocks_per_sm"], r["blocks_per_sm_deep"]) >= 2
             for r in out.values()),
         f"d/dT adjoint: spill stores or local memory over {DDT_SPILL_MAX} "
         f"B, over 128 registers or fewer than two blocks per SM: {out}")
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
            "rt_sweep_save": "compact idrv0 f32 save bulk",
            "rt_sweep_save_maxrand": "maxrand idrv0 f32 save bulk",
            "rt_sweep_save_banded": "banded idrv0 f32 save bulk",
            "rt_sweep_save_fused": "fused idrv0 f32 save bulk",
            "rt_sweep_save_cldf_od": "cldf_od idrv0 f32 save bulk"}
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


# phase_configs: the configurations whose RT sweep is plain (use_lut=True,
# the default config; band subsets) and the cloud optics with closed forms
# or the running ncbands, through the entry points at the main width
B_CPU = 256             # (a): columns held to the same model on the CPU
B_CFG_GRAD = 4096       # (f): the plain LUT sweep's autograd at full width
                        # would keep ~20 (B, 140) tensors a level
TOL_CFG_F64 = 1e-10     # (a): per column, of its max |flux|
# float32 against float64: tests/test_f32_accuracy.py's flux gate (W/m2),
# and on the heating rates the reference's accuracy contract it keeps its
# gates inside of (K/day; test_f32_accuracy.py:1-3), not its 0.05 at B=8:
# at B=16384 on the H100 the float32 steps, the kernels' closed form too
# (the control in phase_configs (b)), exceed 0.05 in the top two layers,
# where one ulp of a 250 W/m2 flux moves the heating rate by ~0.02 K/day
# (PERF.md)
TOL_F32_FLUX, TOL_F32_HR = 5e-3, 0.1
TEST_F32_HR = 0.05      # test_f32_accuracy.py's heating gate, printed beside
# (d): per-band clouds without McICA through K1 banded / maxrand, use_lut
# False: (icld, iceflag, liqflag); the running ncbands but icld=4's
CFG_NCBANDS = ((1, 1, 1), (1, 0, 1), (1, 3, 0), (2, 1, 1), (2, 0, 1),
               (2, 3, 0), (4, 3, 1))


@contextlib.contextmanager
def lut_indices(ncol):
    """Records the first ``ncol`` columns of every lookup-table index the
    plain sweep forms ((B, L, G) int64, ``rtrn._lut_index``), in order."""
    from rrtmg_lw_torch.ops import rtrn
    orig, kept = rtrn._lut_index, []

    def index(x):
        it = orig(x)
        kept.append(it[:ncol].cpu())
        return it

    rtrn._lut_index = index
    try:
        yield kept
    finally:
        rtrn._lut_index = orig


@contextlib.contextmanager
def k1_calls():
    """Records (mode, args, kwargs, output) of every call the model makes
    to K1's wrappers (``rtrn_cuda.WRAPPERS``)."""
    from rrtmg_lw_torch.models import radiation
    orig, calls = radiation.WRAPPERS, []

    def recording(mode, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            calls.append((mode, a, kw, out))
            return out
        return call

    radiation.WRAPPERS = {k: recording(k, f) for k, f in orig.items()}
    try:
        yield calls
    finally:
        radiation.WRAPPERS = orig


def step_stats(tag, step, ncol):
    """Wall ms (host clock around a synchronized call), device busy ms
    (``torch.profiler``: the union of the device intervals of one call),
    columns/s and peak GiB of ``step()`` after a warm-up call; printed."""
    from rrtmg_lw_torch.utils.profiling import _union_ms
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        step()
        torch.cuda.synchronize()
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA])
    row = dict(cell=tag, ncol=ncol, nlay=L_MAIN, wall_ms=wall, busy_ms=busy,
               cols_per_sec=ncol / (wall * 1e-3), peak_gib=peak)
    print(f"configs {tag}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"{row['cols_per_sec']:.0f} cols/s, peak {peak:.2f} GiB")
    return row


def f32_contract(tag, f32, f64):
    """The float32 step's fluxes and heating rates against the float64
    step's (columns of f32 the first of f64's) within TOL_F32_FLUX and
    TOL_F32_HR; -> (flux W/m2, heating K/day) max differences."""
    ncol = f32.uflx.shape[0]
    dflux = max(float((getattr(f32, n).double().cpu()
                       - getattr(f64, n)[:ncol].double().cpu()).abs().max())
                for n in ("uflx", "dflx", "uflxc", "dflxc"))
    dhr = max(float((getattr(f32, n).double().cpu()
                     - getattr(f64, n)[:ncol].double().cpu()).abs().max())
              for n in ("hr", "hrc"))
    need(dflux < TOL_F32_FLUX and dhr < TOL_F32_HR,
         f"{tag}: float32 off the float64 step by {dflux:.3g} W/m2, "
         f"{dhr:.3g} K/day")
    below = max(float((getattr(f32, n)[:, :-2].double().cpu()
                       - getattr(f64, n)[:ncol, :-2].double().cpu()).abs()
                      .max()) for n in ("hr", "hrc"))
    print(f"{tag}: float32 vs float64 {dflux:.3g} W/m2 (gate "
          f"{TOL_F32_FLUX}), {dhr:.3g} K/day (gate {TOL_F32_HR}; "
          f"test_f32_accuracy.py's {TEST_F32_HR} "
          f"{'held' if dhr < TEST_F32_HR else 'not held'}), {below:.3g} "
          "K/day below the top two layers")
    return dflux, dhr


def f64_inputs(atm, clouds):
    """float32 inputs in float64 (the same values), for the reference."""
    def up(t):
        return t.double() if t is not None and t.is_floating_point() else t
    return (type(atm)(*(up(x) for x in atm)),
            None if clouds is None else type(clouds)(*(up(x)
                                                       for x in clouds)))


def k1_against_plain(tag, calls):
    """Each recorded K1 call again (bitwise the model's output) and its
    plain twin (``rtrn.FLUXES``) on the same inputs, within TOL_FLUX;
    -> the largest error."""
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.rtrn_cuda import WRAPPERS
    need(calls, f"{tag}: the step never called K1")
    worst = 0.0
    for mode, a, kw, out in calls:
        again = WRAPPERS[mode](*a, **kw)
        need(torch.equal(again, out), f"{tag}: K1 {mode} differs over two "
             "runs")
        plain = rtrn.FLUXES[mode](*a, **{k: v for k, v in kw.items()
                                         if k != "kept"})
        err = flux_err(plain, out)
        need(err <= TOL_FLUX, f"{tag}: K1 {mode} vs plain err {err:.3g}")
        worst = max(worst, err)
    return worst


def phase_configs(device, counters):
    """The configurations the kernels do not cover whole, each through
    ``make_model`` at B_MAIN x L_MAIN: (a) the default config (float64,
    use_lut=True: plain on the card) against the same model on the CPU
    on B_CPU columns; (b) float32 use_lut=True, clear and McICA, K2, K3
    and K4 and no K1, against the float64 LUT step; (c) band subsets
    (16, 16) and (5, 9), McICA, against the CPU's float64 step on B_CPU
    columns; (d) per-band clouds through K1 banded and maxrand on the
    running ncbands (``CFG_NCBANDS``, ``make_ncbands_clouds``), K1 against
    its plain twin on the inputs the step gave it and bitwise over two
    runs, the step against eager; (e) McICA with the closed-form optics
    (iceflag 1, liqflag 0) through K1 compact, the same checks; (f) a
    gradient step of (b)'s McICA (w.r.t. the Atmosphere, the water paths
    and the radii: K5, K3b and K4b) at B_CFG_GRAD columns against eager
    on the card.  Every step counted.  -> rows of wall, busy, cols/s, peak."""
    from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig,
                                make_model)
    from rrtmg_lw_torch.constants import heatfac
    from rrtmg_lw_torch.ops import cldprop
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.parallel import make_grad_step
    from rrtmg_lw_torch.utils.synthetic import (make_atmosphere,
                                                make_ncbands_clouds)
    rows = []
    fwd = dict(taumol=1, planck=2)

    # (a) the default config
    natm = make_atmosphere(B_MAIN, L_MAIN, seed=0)
    model = make_model(device=device)
    need(model.impl == "eager" and not model.rt_kernels
         and model.luts is not None,
         "the default config does not take the plain LUT sweep")
    atm = Atmosphere.from_numpy(natm, device)
    with lut_indices(B_CPU) as idx_card:
        fa = model(atm)
    cpu = make_model(device="cpu")
    with lut_indices(B_CPU) as idx_cpu:
        fc = cpu(Atmosphere.from_numpy(
            type(natm)(*(x[:B_CPU] for x in natm)), "cpu"))
    err = max(flux_err(getattr(fc, n).t(), getattr(fa, n)[:B_CPU].cpu().t())
              for n in ("uflx", "dflx", "uflxc", "dflxc"))
    need(err <= TOL_CFG_F64,
         f"default: card vs CPU {err:.3g} of a column's max |flux|")
    need(len(idx_card) == len(idx_cpu) and all(
        a.shape == b.shape for a, b in zip(idx_card, idx_cpu)),
         "default: the card and the CPU formed different LUT lookups")
    flips = sum(int((a != b).sum()) for a, b in zip(idx_card, idx_cpu))
    total = sum(a.numel() for a in idx_card)
    print(f"default (float64, use_lut=True, plain on the card): card vs CPU "
          f"on {B_CPU} columns {err:.3g} of max |flux|; LUT indices that "
          f"differ: {flips} of {total}")
    rows.append(dict(step_stats("default", lambda: model(atm), B_MAIN),
                     err_vs_cpu=err, lut_index_flips=flips))
    del model, cpu, fa, fc, idx_card, idx_cpu
    torch.cuda.empty_cache()

    # (b) float32 with the tables, clear and McICA: K2, K3, K4, no K1; and
    # the closed form through K1 clear, the float32 contract's control
    for tag, cell, lut in (("lut_f32_clear", "clear", True),
                           ("lut_f32_mcica", "mcica_cloudy", True),
                           ("k1_f32_clear", "clear", False)):
        atm, clouds = inputs(cell, device)
        icld = 0 if clouds is None else 2
        model = make_model(LWConfig(icld=icld, dtype="float32",
                                    use_lut=lut), device=device)
        need(model.impl == "cuda" and model.rt_kernels != lut,
             f"{tag}: expected the kernels, with the plain sweep where "
             "use_lut")
        model(atm, clouds)
        f32, _, _ = counted_steps(tag, model, atm, clouds, 1, counters,
                                  dict(fwd, cldcoef=int(icld > 0),
                                       rt_sweep=int(not lut)))
        f64 = make_model(LWConfig(icld=icld, use_lut=lut), device=device)(
            *f64_inputs(atm, clouds))
        f32_contract(tag, f32, f64)
        if tag == "lut_f32_mcica":
            rows.append(step_stats(tag, lambda: model(atm, clouds), B_MAIN))
        del model, f32, f64
        torch.cuda.empty_cache()
    pz = inatm(atm, torch.float32).pz
    dp = float((pz[:, -2] - pz[:, -1]).min())
    ulp = heatfac() * float(np.spacing(np.float32(250.0))) / dp
    print(f"float32 contract: the thinnest top layer {dp:.3g} hPa, where one "
          f"float32 ulp of a 250 W/m2 flux moves its heating rate by "
          f"{ulp:.3g} K/day")

    # (c) band subsets
    atm, clouds = inputs("mcica_cloudy", device)
    for istart, iend in ((16, 16), (5, 9)):
        tag = f"bands_{istart}_{iend}"
        kw = dict(icld=2, istart=istart, iend=iend)
        model = make_model(LWConfig(dtype="float32", **kw), device=device)
        need(model.impl == "cuda" and not model.rt_kernels,
             f"{tag}: expected the kernels with the plain sweep")
        model(atm, clouds)
        f32, _, _ = counted_steps(tag, model, atm, clouds, 1, counters,
                                  dict(fwd, cldcoef=1))
        sub = columns(*f64_inputs(atm, clouds), slice(0, B_CPU))
        f64 = make_model(LWConfig(**kw), device="cpu")(
            type(sub[0])(*(x.cpu() for x in sub[0])),
            type(sub[1])(*(x.cpu() for x in sub[1])))
        f32_contract(tag, type(f32)(*(None if x is None else x[:B_CPU]
                                      for x in f32)), f64)
        del model, f32, f64
        torch.cuda.empty_cache()

    # (d) the running ncbands through K1 banded / maxrand
    bc = BandClouds.from_numpy(make_ncbands_clouds(B_MAIN, L_MAIN), device,
                               torch.float32)
    atm, _ = inputs("clear", device)
    for icld, iceflag, liqflag in CFG_NCBANDS:
        tag = f"ncbands_icld{icld}_ice{iceflag}_liq{liqflag}"
        cfg = LWConfig(icld=icld, imca=0, iceflag=iceflag, liqflag=liqflag,
                       dtype="float32", use_lut=False)
        model = make_model(cfg, device=device)
        need(model.rt_kernels, f"{tag}: expected K1")
        model(atm, bc)
        mode = dict(rt_sweep_banded=1) if icld == 1 else dict(
            rt_sweep_maxrand=1, overlap_rows=1)
        with k1_calls() as calls:
            fk, _, _ = counted_steps(
                tag, model, atm, bc, 1, counters,
                dict(fwd, **mode,
                     cldcoef=int(cldprop.tabulated(iceflag, liqflag))))
        kerr = k1_against_plain(tag, calls)
        fe = make_model(cfg.replace(impl="eager"), device=device)(atm, bc)
        err = compare_models(tag, fk, fe, True)
        need(not torch.allclose(fk.uflx, fk.uflxc),
             f"{tag}: the clouds left the all-sky fluxes unchanged")
        print(f"{tag}: K1 vs plain {kerr:.3g}, step vs eager {err:.3g}")
        if icld == 2 and iceflag == 1:
            rows.append(step_stats(tag, lambda: model(atm, bc), B_MAIN))
        del model, fk, fe, calls
        torch.cuda.empty_cache()

    # (e) McICA with the closed-form optics through K1 compact
    atm, clouds = inputs("mcica_cloudy", device)
    tag = "mcica_ice1_liq0"
    cfg = LWConfig(icld=2, iceflag=1, liqflag=0, dtype="float32",
                   use_lut=False)
    model = make_model(cfg, device=device)
    model(atm, clouds)
    with k1_calls() as calls:
        fk, _, _ = counted_steps(tag, model, atm, clouds, 1, counters,
                                 dict(fwd, rt_sweep=1))
    kerr = k1_against_plain(tag, calls)
    fe = make_model(cfg.replace(impl="eager"), device=device)(atm, clouds)
    err = compare_models(tag, fk, fe, True)
    print(f"{tag}: K1 vs plain {kerr:.3g}, step vs eager {err:.3g}")
    del model, fk, fe, calls
    torch.cuda.empty_cache()

    # (f) a gradient step of (b)'s McICA: K5, K3b and K4b in its backward
    tag = "lut_f32_mcica_grad"
    atm, clouds = columns(*inputs("mcica_cloudy", device),
                          slice(0, B_CFG_GRAD))
    gen = torch.Generator(device=device).manual_seed(7)
    cts = [torch.randn(B_CFG_GRAD, L_MAIN + 1, generator=gen, device=device)
           for _ in range(4)]

    def linear(f):
        return sum((c * x).sum() for c, x in zip(
            cts, (f.uflx, f.dflx, f.uflxc, f.dflxc)))

    cfg = LWConfig(icld=2, dtype="float32")
    fields = ("ciwp", "clwp", "reicmc", "relqmc")
    step = make_grad_step(make_model(cfg, device=device), linear, fields)
    step(atm, clouds)
    for fn in counters.values():
        fn.launches = 0
    _, gk, ck = step(atm, clouds)
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {k: 0 for k in counters}
    want.update(fwd, cldcoef=1, taumol_bwd=1, planck_bwd=2, cldcoef_bwd=1)
    need(counts == want, f"{tag}: launches {counts}, expected {want}")
    print(f"{tag}: launches in its step: {counts}")
    _, ge, ce = make_grad_step(make_model(cfg.replace(impl="eager"),
                                          device=device), linear, fields)(
        atm, clouds)
    errs = {n: rel_err(getattr(gk, n), getattr(ge, n)) for n in gk._fields}
    errs.update({n: rel_err(a, b) for n, a, b in zip(fields, ck, ce)})
    worst = max(errs, key=errs.get)
    need(all(bool(torch.isfinite(g).all()) for g in (*gk, *ck))
         and errs[worst] <= TOL_STEP,
         f"{tag}: gradient of {worst} off by {errs[worst]:.3g} of max "
         "|eager|")
    print(f"{tag}: gradients on {B_CFG_GRAD} columns, kernels vs eager, "
          f"max rel err {errs[worst]:.3g} ({worst})")
    rows.append(dict(step_stats(tag, lambda: step(atm, clouds), B_CFG_GRAD),
                     grad_rel_err_vs_eager=errs[worst]))
    del step, gk, ge, ck, ce
    torch.cuda.empty_cache()
    for r in rows:
        print("configs " + json.dumps(r))
    return rows


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


def rel_err(got, ref, chunk=1 << 27):
    """max |got - ref| / max |ref| (the absolute error where ref is 0), in
    float64 ``chunk`` elements at a time (K1 SAVE's radiances at L_DEEP
    are 7.7 GB in float32)."""
    got, ref = got.reshape(-1), ref.reshape(-1)
    spans = [slice(i, i + chunk) for i in range(0, max(ref.numel(), 1),
                                                chunk)]
    scale = max(float(ref[c].double().abs().max()) for c in spans)
    diff = max(float((got[c].double() - ref[c].double()).abs().max())
               for c in spans)
    return diff / scale if scale > 0 else diff


def columns(atm, clouds, cols):
    """The columns ``cols`` (a slice) of an Atmosphere and its clouds
    (``cloud_columns``)."""
    from rrtmg_lw_torch import Atmosphere
    return Atmosphere(*(x[cols] for x in atm)), cloud_columns(clouds, cols)


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
    fk, rads, _ = rt_sweep_radiances(*args)
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
        fk, rads, _ = rt_sweep_radiances(*args)
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
    torch.cuda.empty_cache()
    res.update(maxrand_grad_kernels(
        device, model, (taut, fracs, play, plev, *fl_args), surf, randn))
    torch.cuda.empty_cache()
    res.update(g_grad_kernels(
        device, model, (taut, fracs, play, plev, *fl_args), surf, randn))
    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']:.3g} "
              f"max_rel_err {r['max_rel_err']:.3g} kernel {r['ms']:.3f} ms "
              f"plain {r['plain_ms']:.3f} ms")
    return res


def maxrand_grad_kernels(device, model, args, surf, randn):
    """The maxrand gradient's kernels on phase 3's sweep inputs ``args``
    (taut_t, fracs_t, planklay_t, planklev_t, plankbnd, semiss, pwvcm,
    ngb0, wg) and the band_cloudy cell's clouds (make_band_clouds, and
    mixed_clouds' fractions varying inside the decks): the overlap
    adjoint within TOL_BWD of the plain vjp of rtrnmr.overlap_rows; K1
    keeping the maxrand state (the radiances and the packed sub-streams),
    its fluxes bitwise K1's and the state within TOL_RADS of the plain
    sweep's, compared unpacked (``rtrn.unpack_state``), there and on K1's
    edge cases; K6 maxrand fed that state within TOL_BWD_RT of the plain
    vjp of rtrn.rt_sweep_maxrand on the first B_SUB columns, zeros in the
    flag rows, and raising without the state; each kernel bitwise over
    two runs (K6's second with NaN in the slots past each column's
    count); K1 keeping the state and K6 also at B = 37 (element copies)
    and at L_DEEP.  -> the three kernels' summary entries (K1's and K6's
    device ms come from grad_device_times)."""
    from rrtmg_lw_torch.ops import cldprop, rtrn, rtrnmr
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.rtrn_cuda import (k6_mr_info, rt_fluxes_maxrand,
                                              rt_sweep_maxrand_radiances,
                                              rt_sweep_maxrand_vjp)
    from rrtmg_lw_torch.ops.rtrnmr_cuda import (overlap_rows,
                                                overlap_rows_vjp)
    from rrtmg_lw_torch.utils.snapshot import (g_cloud_args, k1_edge_args,
                                               rotating, sweep_inputs)
    static = model.static_tensors()
    ngb0, wg = args[7:]
    _, bc = inputs("band_cloudy", device)
    fields = (("decks", bc), ("mixed", mixed_clouds(bc, device)))
    res = {}

    # the overlap adjoint
    errs = []
    for tag, b in fields:
        cf = b.cldfrac
        ct = randn(L_MAIN, 16, B_MAIN)
        got = overlap_rows_vjp(cf, ct)

        def plain(cf=cf, ct=ct):
            x = cf.clone().requires_grad_()
            return torch.autograd.grad(rtrnmr.overlap_rows(x), x, ct)[0]
        ref = plain()
        e = rel_err(got, ref)
        need(bool(torch.isfinite(got).all()) and e <= TOL_BWD,
             f"overlap_bwd ({tag}): rel err {e:.3g} > {TOL_BWD}")
        need(torch.equal(got, overlap_rows_vjp(cf, ct)),
             f"overlap_bwd ({tag}): two runs differ")
        errs.append((float((got - ref).abs().max()), e))
        print(f"overlap_bwd ({tag}): within {e:.3g} of max |plain vjp|, "
              "bitwise over two runs")
        if tag == "decks":
            # the inputs (67 MB) would stay mostly in L2 across repeats
            cold = rotating(overlap_rows_vjp, cf, ct)
            res["overlap_bwd"] = dict(
                ms=cuda_ms(cold, 20),
                device_ms=device_ms(cold, reps=20,
                                    symbol="overlap_bwd_kernel"),
                plain_ms=cuda_ms(plain, 2),
                # the 13 rows that carry a gradient are read
                **bound((cf,), (got,), OPS["overlap_bwd"] * cf.numel(),
                        nbytes=13 * L_MAIN * B_MAIN * 4))
    res["overlap_bwd"].update(max_abs_err=max(a for a, _ in errs),
                              max_rel_err=max(r for _, r in errs))

    # K1 keeping the maxrand state and K6 maxrand: phase 3's inputs with
    # both clouds, K1's edge cases, a ragged edge (B = 37: element
    # copies) and L_DEEP
    cases = []
    for tag, b in fields:
        taucb, _ = cldprop.cldprop_banded_blocked(
            b, static, inflag=2, iceflag=3, liqflag=1,
            coeffs=ice_liq_coeffs_blocked)
        cases.append((tag, args, overlap_rows(b.cldfrac), taucb))
    eargs, emodes, _ = k1_edge_args(device, static, args)
    cases.append(("edge", eargs, *emodes["maxrand"][1]))

    def cut(t, n=37):
        """the first n columns of an (L, *, B) or (B, *) input"""
        if t.dim() == 3:
            return t[..., :n].contiguous()
        return t[:n].contiguous() if t.shape[0] == B_MAIN else t
    cases.append(("B=37", tuple(cut(t) for t in args),
                  *(cut(t) for t in cases[0][2:])))
    xd = sweep_inputs(device, "mcica_cloudy_deep")
    cfd, taucbd = g_cloud_args(device, static, L_DEEP)["banded"]
    cases.append((f"L={L_DEEP}", xd["args"],
                  overlap_rows(cfd.t().contiguous()), taucbd))
    sub = slice(0, B_SUB)
    save_errs, out, ref = [], [], []
    for tag, a9, rows, taucb in cases:
        L, _, B = a9[0].shape
        sf = surf if a9 is args or a9 is eargs else rtrn.surf_rows(
            *a9[4:7], torch.float32)
        a = (*a9[:4], sf, rows, taucb, ngb0, wg)
        ct = randn(4, L + 1, B)
        fk, rads, subs = rt_sweep_maxrand_radiances(*a)
        need(torch.equal(fk, rt_fluxes_maxrand(*a9, rows, taucb)),
             f"rt_sweep_save_maxrand ({tag}): fluxes differ from K1's "
             "without the state")
        _, counts = rtrn.substream_slots(rows)
        K = rtrn.kept_depth(counts)
        need(subs.shape == (2, 3, K, 140, B),
             f"rt_sweep_save_maxrand ({tag}): packed sub-streams "
             f"{tuple(subs.shape)}, expected K = {K} slots")
        # K1 writes a column's slots up to its count: two runs compared
        # there, the state against the plain one unpacked, in chunks of
        # B_CHUNK columns (at L_DEEP the first B_SUB)
        past = (torch.arange(K, device=device)[None, :, None]
                >= counts[:, None, :])[:, None, :, None, :]
        _, rads2, subs2 = rt_sweep_maxrand_radiances(*a)
        need(torch.equal(rads, rads2) and torch.equal(
            subs.masked_fill(past, 0.0), subs2.masked_fill(past, 0.0)),
             f"rt_sweep_save_maxrand ({tag}): two runs differ")
        del rads2, subs2
        d_max = r_max = 0.0
        finite = True
        ncmp = B if L == L_MAIN else min(B, B_SUB)
        for c0 in range(0, ncmp, B_CHUNK):
            c = slice(c0, min(c0 + B_CHUNK, ncmp))
            state = rtrn.unpack_state(rads[..., c], subs[..., c],
                                      rows[..., c])
            state_p = rtrn.unpack_state(*rtrn.rt_sweep_maxrand(
                *(t[..., c].contiguous() for t in a[:7]), ngb0, wg,
                radiances=True)[1:], rows[..., c].contiguous())
            finite &= bool(torch.isfinite(state).all())
            d_max = max(d_max, float((state - state_p).abs().max()))
            r_max = max(r_max, float(state_p.abs().max()))
            del state, state_p
        e = d_max / max(r_max, 1e-30)
        need(finite and e <= TOL_RADS,
             f"rt_sweep_save_maxrand ({tag}): state off by {e:.3g} of max "
             f"|plain| > {TOL_RADS}")
        save_errs.append((d_max, e))
        try:
            rt_sweep_maxrand_vjp(*a, ct)
        except ValueError:
            pass
        else:
            need(False, "rt_adjoint_maxrand: K6 ran without the state")
        got = rt_sweep_maxrand_vjp(*a, ct, state=(rads, subs))
        # NaN in the slots past each column's count: K6 must not read them
        subs.masked_fill_(past, float("nan"))
        need(all(torch.equal(g, h) for g, h in zip(
            got, rt_sweep_maxrand_vjp(*a, ct, state=(rads, subs)))),
             f"rt_adjoint_maxrand ({tag}): two runs differ, or K6 read a "
             "slot past a column's count")
        need(not bool(got[5][:, 1:4].any()),
             f"rt_adjoint_maxrand ({tag}): cotangents in the flag rows")
        xs = tuple(x[..., sub].contiguous() for x in a[:7])
        cs = ct[..., sub].contiguous()
        r = rtrn.rt_sweep_maxrand_vjp(*xs, ngb0, wg, cs)
        out += [g[..., sub].contiguous() for g in got]
        ref += list(r)
        e6 = max(rel_err(g[..., sub], x) for g, x in zip(got, r))
        print(f"rt_sweep_save_maxrand ({tag}): fluxes bitwise K1's, state "
              f"(K = {K}) within {e:.3g} of max |plain|; "
              f"rt_adjoint_maxrand within {e6:.3g} of max |plain vjp| on "
              f"{min(B, B_SUB)} columns")
        if tag == "decks":
            ncld = int((rows[:, 0] >= rtrn.CLOUD_GATE).sum())
            # the sub-streams K6 reads: cloudy layers without a restart
            nsub = int(counts.sum())
            base = OPS["rt_clear"] * L_MAIN * B_MAIN * 140
            # the radiances and clear twins, and the sub-streams where
            # they are kept, are written
            res["rt_sweep_save_maxrand"] = dict(
                ms=cuda_ms(lambda: rt_sweep_maxrand_radiances(*a), 5),
                plain_ms=cuda_ms(lambda: rtrn.rt_sweep_maxrand(
                    *a, radiances=True), 1),
                state_gb_allocated=(rads.numel() + subs.numel()) * 4 / 1e9,
                state_gb_written=(rads.numel() + 3 * 140 * nsub) * 4 / 1e9,
                **bound((*a9, rows, taucb), (fk, rads),
                        base + OPS["rt_maxrand"] * 140 * ncld,
                        nbytes=3 * 140 * 4 * nsub))
            res["rt_adjoint_maxrand"] = dict(
                ms=cuda_ms(lambda: rt_sweep_maxrand_vjp(
                    *a, ct, state=(rads, subs)), 3),
                plain_ms=cuda_ms(lambda: rtrn.rt_sweep_maxrand_vjp(
                    *xs, ngb0, wg, cs), 1),
                plain_ncol=B_SUB,
                bytes_moved=mr_traffic(a, nsub),
                **bound((*a[:7], ct, rads), got,
                        OPS["rt_adjoint"] * a9[0].numel()
                        + OPS["rt_adjoint_mr"] * 140 * ncld,
                        nbytes=3 * 140 * 4 * nsub))
            print(f"rt_adjoint_maxrand: reads the sub-streams of {nsub} "
                  f"cloudy (layer, column, sweep) without a restart of "
                  f"{2 * ncld} cloudy ones, packed in K = {K} slots a "
                  f"sweep: the state {rads.numel() * 4 / 1e9:.2f} + "
                  f"{subs.numel() * 4 / 1e9:.3f} GB allocated")
        del rads, subs, got
    del xd
    res["rt_sweep_save_maxrand"].update(
        max_abs_err=max(a for a, _ in save_errs),
        max_rel_err=max(r for _, r in save_errs))
    e = [rel_err(g, r) for g, r in zip(out, ref)]
    need(max(e) <= TOL_BWD_RT, f"rt_adjoint_maxrand: rel err {max(e):.3g} "
         f"> {TOL_BWD_RT} (per output: {[f'{x:.2g}' for x in e]})")
    res["rt_adjoint_maxrand"].update(
        max_abs_err=max(float((g - r).abs().max()) for g, r in zip(out,
                                                                    ref)),
        max_rel_err=max(e))
    info = k6_mr_info(L_MAIN)
    print(f"rt_adjoint_maxrand: tile {info['columns']} columns x band "
          f"groups {info['groups']}, ring of {info['ring_levels']} slots, "
          f"boxes of {info['columns']} x {info['box_rows']}, shares of "
          f"{info['share_floats']} floats a (layer, column) in the "
          "scratch")
    return res


def mr_traffic(a, nsub):
    """The bytes K6 maxrand moves on its inputs ``a`` (taut_t, fracs_t,
    planklay_t, planklev_t, surf, rows_t, taucb_t, ...), each access
    counted as the kernel makes it (``k6g_traffic``'s conventions, the
    tile and groups from the library): taut and fracs read in both
    sweeps, the radiance entering each layer and its clear twin, ct_taut
    and ct_fracs written, read back and written again (8-row boxes); the
    Planck rows and their cotangents' partials in 8-band boxes a group,
    the cotangents written twice; the flux rows, read by each group; the
    overlap rows' prelude (4 rows a group); where a column of the tile is
    cloudy the layer's 16 overlap rows and taucb (and its cotangent's
    partial in the down sweep), in both sweeps, and the groups' shares
    (written, and read by the last group); the sub-streams of ``nsub``
    kept (layer, column, sweep); ct_rows written once; taucb's cotangent
    written by the up sweep and read and written at cloudy columns by the
    down sweep."""
    from rrtmg_lw_torch.data.ktables import load_static
    from rrtmg_lw_torch.ops.rtrn_cuda import k6_mr_info
    rows_t = a[5]
    L, _, B = a[0].shape
    info = k6_mr_info(L)
    first, hbox, cols = info["groups"], info["box_rows"], info["columns"]
    f4, ngrp = 4, len(first) - 1
    ng = np.bincount(np.asarray(load_static()["ngb"]) - 1, minlength=16)
    nrows = sum(-(-int(ng[a:b].sum()) // hbox) * hbox
                for a, b in zip(first, first[1:]))
    box = ngrp * hbox
    per_g = L * 140 * B * f4
    per_g_r = per_g * nrows / 140
    band = L * 16 * B * f4
    band_r = band * box / 16
    n = 4 * per_g_r + (4 * L - 2) * nrows * B * f4 + 2 * per_g_r + 4 * per_g
    n += 2 * band_r + band_r * 2 + 4 * band + 2 * 2 * L * ngrp * B * f4
    cloudy = rows_t[:, 0] >= 1e-6
    pad = (-B) % cols
    tiles = torch.nn.functional.pad(cloudy, (0, pad)).reshape(
        L, -1, cols).any(-1)
    tc = int(tiles.sum()) * cols
    ncly = int(cloudy.sum())
    n += 4 * ngrp * L * B * f4 + 2 * tc * ngrp * (16 + hbox) * f4
    n += tc * box * f4 + band + 2 * ncly * 16 * f4
    n += tc * ngrp * (14 + 1) * f4 + tc * ngrp * 13 * f4
    n += 3 * 140 * nsub * f4 + L * 16 * B * f4
    return n


def k6g_staging(mode):
    """How K6 in ``mode`` (maxrand, or a ``G_MODES`` one) staged its rows
    at its last launch, as the library reports it
    (``rtrn_cuda.k6_mr_info``, ``k6_g_info``): the bulk tensor copies
    where every row is 16-byte aligned, element by element elsewhere."""
    from rrtmg_lw_torch.ops.rtrn_cuda import k6_g_info, k6_mr_info
    info = (k6_mr_info(L_MAIN) if mode == "maxrand"
            else k6_g_info(mode, L_MAIN))
    return {"tma": "bulk tensor copies (TMA: 2D tensor maps, boxes of "
                   f"{info['columns']} columns x {info['box_rows']} rows)",
            "elements": "element by element (cp.async)"}.get(
                info["staging"], "no launch")


def k6g_traffic(mode, x, cl, cloudy):
    """The bytes K6 in ``mode`` moves on the sweep inputs ``x`` (taut_t,
    fracs_t, planklay_t, planklev_t, surf) and clouds ``cl``, each access
    counted as the kernel makes it: taut and fracs read in both sweeps;
    the radiance entering each layer and its clear twin; ct_taut and
    ct_fracs written, read back and written again (the per-g reads in
    8-row boxes: 144 rows a layer for the groups' 140); the Planck rows
    and their cotangents' partials in 8-band boxes a group, the
    cotangents written twice; the flux rows, read by each group; the
    cloud rows where a column of the 32-column tile is cloudy (``cloudy``
    (L, B) bool), in both sweeps; banded: cldfrac read by each group for
    the flags, its cotangent written by group 0 and read and written by
    the others, each adding its share; the
    per-g modes: the cloudy-layer words K1 kept, read by each group (a
    word per 32-column tile and layer), their cloud cotangents
    written in the up sweep (the zeros too) and read and written again in
    the down sweep's cloudy columns."""
    from rrtmg_lw_torch.data.ktables import load_static
    from rrtmg_lw_torch.ops.rtrn_cuda import k6_g_info
    L, _, B = x[0].shape
    info = k6_g_info(mode, L)   # the tile, band groups and box of the build
    first, hbox, cols = info["groups"], info["box_rows"], info["columns"]
    f4, ngrp = 4, len(first) - 1
    ng = np.bincount(np.asarray(load_static()["ngb"]) - 1, minlength=16)
    rows = sum(-(-int(ng[a:b].sum()) // hbox) * hbox
               for a, b in zip(first, first[1:]))
    box = ngrp * hbox                     # band rows a group reads
    a = L * 140 * B * f4                  # a per-g array
    ar = a * rows / 140                   # the same, read in boxes
    band = L * 16 * B * f4
    bandr = band * box / 16
    n = 4 * ar + (4 * L - 2) * rows * B * f4 + 2 * ar + 4 * a
    n += 2 * bandr + bandr * 2 + 4 * band + 2 * 2 * L * ngrp * B * f4
    pad = (-B) % cols
    tiles = torch.nn.functional.pad(cloudy, (0, pad)).reshape(
        L, -1, cols).any(-1)
    tc = int(tiles.sum()) * cols          # columns of cloudy tiles
    ncly = int(cloudy.sum())
    if mode == "banded":
        n += ngrp * L * B * f4 + 2 * tc * (1 + box) * f4
        n += band + 2 * tc * box * f4 + (2 * ngrp - 1) * L * B * f4
    else:
        ncg = 4 if mode == "fused" else 2
        n += ngrp * L * -(-B // 32) * 4 + 2 * tc * ncg * rows * f4
        n += ncg * L * 144 * B * f4 + 2 * ncly * ncg * 140 * f4
        if mode == "fused":
            n += 2 * 2 * tc * box * f4 + 2 * band + 2 * 2 * tc * box * f4
    return n


# the random-overlap gradients' modes and the cells whose clouds each
# runs on
G_MODES = {"banded": "band_cloudy", "fused": "mcica_blocked",
           "cldf_od": "mcica_tauc"}
# the per-g cloud inputs K1 and K6 read only at a g-point whose gate
# (cldf >= 0.5) holds: their index in CLOUD_INPUTS[mode]
GATED = {"banded": (), "fused": (1, 2, 3), "cldf_od": (1,)}


def g_grad_kernels(device, model, args, surf, randn):
    """The banded, fused and cldf-odcld gradients' kernels on phase 3's
    sweep inputs ``args`` (as ``maxrand_grad_kernels``') with each mode's
    clouds (``utils.snapshot.k1_cloud_args``: the cells of ``G_MODES``;
    banded also on mixed_clouds' fractions) and on K1's edge cases: K1
    keeping the radiances in the mode (``rt_sweep_g_radiances``), its
    fluxes bitwise K1's without them and the radiances within TOL_RADS of
    the plain sweep's; K6 in the mode fed them within TOL_BWD_RT of the
    plain vjp on the first B_SUB columns, raising without them, the pad
    rows of its (L, 144, B) cotangents zero; K4b
    (``ice_liq_coeffs_vjp``) within TOL_BWD of the plain vjp on the
    mcica_blocked cell's radii and on radii below, on and above the
    tables' grid, iceflag 2 and 3; each kernel bitwise over two runs.
    -> the summary entries of K1 SAVE and K6 in the three modes and of
    K4b (K1's and K6's device ms come from grad_device_times)."""
    from rrtmg_lw_torch.ops import cldprop, rtrn
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_vjp
    from rrtmg_lw_torch.ops.rtrn_cuda import (WRAPPERS, rt_sweep_banded_vjp,
                                              rt_sweep_g_radiances,
                                              rt_sweep_g_vjp)
    from rrtmg_lw_torch.utils.snapshot import k1_cloud_args, k1_edge_args
    static = model.static_tensors()
    ngb0, wg = args[7:]
    _, mc = inputs("mcica_cloudy", device)
    cell_clouds = k1_cloud_args(device, static, mc)
    eargs, emodes, _ = k1_edge_args(device, static, args)

    def clouds_of(mode, cl):
        return tuple(cl) if mode == "banded" else tuple(cl[0])
    cases = [(m, "cell", args, clouds_of(m, cell_clouds[m][1]))
             for m in G_MODES]
    _, bc = inputs("band_cloudy", device)
    mb = mixed_clouds(bc, device)
    taucb, _ = cldprop.cldprop_banded_blocked(mb, static, inflag=2,
                                              iceflag=3, liqflag=1)
    cases.append(("banded", "mixed", args,
                  (mb.cldfrac.t().contiguous(), taucb)))
    cases += [(m, "edge", eargs, clouds_of(m, emodes[m][1]))
              for m in G_MODES]
    ct = randn(4, L_MAIN + 1, B_MAIN)
    sub = slice(0, B_SUB)
    res, save_errs, k6_errs = {}, [], []
    for mode, tag, a9, cl in cases:
        x = (*a9[:4], surf)
        fk, rads, words = rt_sweep_g_radiances(mode, *x, cl, ngb0, wg)
        fields = cl if mode == "banded" else (cl,)
        need(torch.equal(fk, WRAPPERS[mode](*a9, *fields)),
             f"rt_sweep_save_{mode} ({tag}): fluxes differ from K1's "
             "without the radiances")
        need(torch.equal(rads, rt_sweep_g_radiances(mode, *x, cl, ngb0,
                                                    wg)[1]),
             f"rt_sweep_save_{mode} ({tag}): two runs differ")
        kw = {}
        if mode == "banded":
            _, rads_p = rtrn.rt_sweep_banded(*x, *cl, ngb0, wg,
                                             radiances=True)
        else:
            _, rads_p, words_p = rtrn.rt_sweep_blocked(*x, ngb0, wg, cl,
                                                       radiances=True)
            need(torch.equal(words, words_p),
                 f"rt_sweep_save_{mode} ({tag}): cloudy-layer words differ "
                 "from the plain ones")
            kw = dict(words=words)
        e = rel_err(rads, rads_p)
        need(bool(torch.isfinite(rads).all()) and e <= TOL_RADS,
             f"rt_sweep_save_{mode} ({tag}): radiances off by {e:.3g} of "
             f"max |plain| > {TOL_RADS}")
        save_errs.append((mode, float((rads - rads_p).abs().max()), e))
        del rads_p

        def k6(**kw):
            if mode == "banded":
                return rt_sweep_banded_vjp(*x, *cl, ngb0, wg, ct, **kw)
            return rt_sweep_g_vjp(*x, cl, ngb0, wg, ct, **kw)
        try:
            k6()
        except ValueError:
            pass
        else:
            need(False, f"rt_adjoint_{mode}: K6 ran without the radiances")
        got = k6(rads=rads, **kw)
        need(all(torch.equal(g, h) for g, h in zip(got, k6(rads=rads,
                                                          **kw))),
             f"rt_adjoint_{mode} ({tag}): two runs differ")
        need(not any(bool(g[:, 140:].any()) for g in got[5:]
                     if g.dim() == 3 and g.shape[1] == 144),
             f"rt_adjoint_{mode} ({tag}): cotangents in the pad rows")
        xs = tuple(t[..., sub].contiguous() for t in (*x, *cl))
        cs = ct[..., sub].contiguous()
        ref = (rtrn.rt_sweep_banded_vjp(*xs, ngb0, wg, cs) if mode == "banded"
               else rtrn.rt_sweep_g_vjp(*xs[:5], xs[5:], ngb0, wg, cs))
        e6 = [rel_err(g[..., sub], r) for g, r in zip(got, ref)]
        need(all(bool(torch.isfinite(g).all()) for g in got)
             and max(e6) <= TOL_BWD_RT,
             f"rt_adjoint_{mode} ({tag}): rel err {max(e6):.3g} > "
             f"{TOL_BWD_RT} (per output: {[f'{v:.2g}' for v in e6]})")
        k6_errs.append((mode, max(float((g[..., sub] - r).abs().max())
                                  for g, r in zip(got, ref)), max(e6)))
        print(f"rt_sweep_save_{mode} ({tag}): fluxes bitwise K1's, "
              f"radiances within {e:.3g} of max |plain|; rt_adjoint_{mode} "
              f"within {max(e6):.3g} of max |plain vjp| on {B_SUB} columns, "
              "bitwise over two runs")
        if tag == "cell":
            cf = cl[0]
            cloudy = (cf >= rtrn.CLOUD_GATE if mode == "banded"
                      else (cf[:, :140] >= 0.5).any(1))
            ncld = int(cloudy.sum())
            # the per-g inputs read only where the g-point's gate holds
            ngate = int((cf[:, :140] >= 0.5).sum()) if GATED[mode] else 0
            read = [c for i, c in enumerate(cl) if i not in GATED[mode]]
            gated = 4 * ngate * len(GATED[mode])
            res[f"rt_sweep_save_{mode}"] = dict(
                ms=cuda_ms(lambda: rt_sweep_g_radiances(mode, *x, cl, ngb0,
                                                        wg), 3),
                plain_ms=cuda_ms(lambda: rtrn.rt_sweep_banded(
                    *x, *cl, ngb0, wg, radiances=True) if mode == "banded"
                    else rtrn.rt_sweep_blocked(*x, ngb0, wg, cl,
                                               radiances=True), 1),
                **bound((*x, *read, ngb0, wg), (fk, rads),
                        140 * (OPS["rt_clear"] * L_MAIN * B_MAIN
                               + OPS["rt_cloud"] * ncld), nbytes=gated))
            res[f"rt_adjoint_{mode}"] = dict(
                ms=cuda_ms(lambda: k6(rads=rads, **kw), 3),
                plain_ms=cuda_ms(lambda: rtrn.rt_sweep_banded_vjp(
                    *xs, ngb0, wg, cs) if mode == "banded"
                    else rtrn.rt_sweep_g_vjp(*xs[:5], xs[5:], ngb0, wg, cs),
                    1),
                plain_ncol=B_SUB,
                **bound((*x, *read, ngb0, wg, ct, rads), got,
                        OPS["rt_adjoint"] * x[0].numel(), nbytes=gated))
            res[f"rt_adjoint_{mode}"]["bytes_moved"] = k6g_traffic(
                mode, x, cl, cloudy)
            print(f"rt_adjoint_{mode}: {ncld} cloudy (layer, column), "
                  f"{ngate} gated (layer, g, column)")
        del rads, words, got, ref, xs
    for name, errs in (("rt_sweep_save", save_errs), ("rt_adjoint", k6_errs)):
        for mode in G_MODES:
            r = res[f"{name}_{mode}"]
            r.update(max_abs_err=max(a for m, a, _ in errs if m == mode),
                     max_rel_err=max(e for m, _, e in errs if m == mode))

    # K4b on the mcica_blocked cell's radii and on radii off and on the
    # tables' grid (reic = 2 + 3k, relq = 1.5 + k exactly)
    _, cb = inputs("mcica_blocked", device)
    gen = torch.Generator(device=device).manual_seed(13)
    u = torch.rand((B_MAIN, L_MAIN), generator=gen, device=device)
    k = torch.randint(0, 60, (B_MAIN, L_MAIN), generator=gen, device=device)
    edge = (torch.where(u < 0.5, 160.0 * u, 2.0 + 3.0 * k),
            torch.where(u < 0.5, 140.0 * u, 1.5 + k))
    errs, res_k4 = [], None
    for iceflag in (3, 2):
        for tag, (reic, relq) in (("cell", (cb.reicmc, cb.relqmc)),
                                  ("edge", edge)):
            cts = (randn(L_MAIN, 16, B_MAIN), randn(L_MAIN, 16, B_MAIN))
            got = ice_liq_coeffs_vjp(reic, relq, iceflag, 1, static, *cts)
            ref = cldprop.ice_liq_coeffs_vjp(reic, relq, iceflag, 1,
                                             static, *cts)
            e = max(rel_err(g, r) for g, r in zip(got, ref))
            need(all(bool(torch.isfinite(g).all()) for g in got)
                 and e <= TOL_BWD, f"cldcoef_bwd ({tag}, iceflag "
                 f"{iceflag}): rel err {e:.3g} > {TOL_BWD}")
            need(all(torch.equal(g, h) for g, h in zip(
                got, ice_liq_coeffs_vjp(reic, relq, iceflag, 1, static,
                                        *cts))),
                 f"cldcoef_bwd ({tag}): two runs differ")
            errs.append((max(float((g - r).abs().max())
                             for g, r in zip(got, ref)), e))
            print(f"cldcoef_bwd ({tag}, iceflag {iceflag}): within {e:.3g} "
                  "of max |plain vjp|, bitwise over two runs")
            if res_k4 is None:
                def k4b(reic=reic, relq=relq, cts=cts):
                    return ice_liq_coeffs_vjp(reic, relq, 3, 1, static,
                                              *cts)

                def plain(reic=reic, relq=relq, cts=cts):
                    return cldprop.ice_liq_coeffs_vjp(reic, relq, 3, 1,
                                                      static, *cts)
                res_k4 = dict(
                    ms=cuda_ms(k4b, 20),
                    device_ms=device_ms(k4b, reps=20,
                                        symbol="cldcoef_bwd_kernel"),
                    plain_ms=cuda_ms(plain, 5),
                    **bound((reic, relq, static["absice3"],
                             static["absliq1"], *cts), got,
                            OPS["cldcoef_bwd"] * cts[0].numel()))
    res["cldcoef_bwd"] = dict(res_k4, max_abs_err=max(a for a, _ in errs),
                              max_rel_err=max(e for _, e in errs))
    return res


def ddt_grad_kernels(device):
    """K6's instantiations with the d/dT sweep's adjoint (idrv=1), one a
    mode, on ``utils.snapshot.ddt_cases`` (phase 3's sweep inputs with
    surf (4, 16, B) and each mode's cell clouds) at L_MAIN, on their first
    37 columns (element copies), on their first B_ODD (rows 16-byte
    aligned but not the int8 mask's: compact's element copies beside the
    other modes' bulk ones) and at L_DEEP, each fed the state K1 kept
    on the same inputs: within TOL_BWD_RT of the plain vjp of the mode's
    sweep on the cotangent (ct, ct_ddt), seeded, per output on the first
    B_SUB columns (all 37), at L_MAIN also with ct None (a loss that reads
    d/dT alone), bitwise over two runs, the cotangent of dplankbnd_dt
    (surf's row 3) nonzero; on the band-group tile staged by bulk tensor
    copies where its rows allow them.  In KEEPS_DDT (every mode but
    clear) K1 SAVE's d/dT derivatives (rads planes 4-5) within
    TOL_DDT_PLANES of the plain sweep's in float64 on those columns.  ->
    the summary entries, their bounds those of K6 in the mode (its inputs
    read once, its outputs written once) with ct_ddt and surf's row 3 and
    its cotangent; clear's scratch bytes (written once, read once) beside
    them (device ms: grad_device_times)."""
    from rrtmg_lw_torch.ops.rtrn_cuda import KEEPS_DDT, k6_g_info, k6_mr_info
    from rrtmg_lw_torch.utils.snapshot import (cut_columns, ddt_cases,
                                               ddt_plain_vjp, ddt_state,
                                               ddt_vjp)
    gen = torch.Generator(device=device).manual_seed(11)
    main = ddt_cases(device, L_MAIN)
    B = main[0][0].shape[2]
    cases = [(f"L={L_MAIN}", lambda: main),
             ("B=37", lambda: (cut_columns(main[0], 37, B), *main[1:3],
                               {m: cut_columns(c, 37, B)
                                for m, c in main[3].items()})),
             (f"B={B_ODD}", lambda: (
                 cut_columns(main[0], B_ODD, B), *main[1:3],
                 {m: cut_columns(c, B_ODD, B) for m, c in main[3].items()})),
             (f"L={L_DEEP}", lambda: ddt_cases(device, L_DEEP))]
    res, errs = {}, {m: [] for m in DDT_MODES}
    for tag, case in cases:
        x, ngb0, wg, clouds = case()
        L, _, Bc = x[0].shape
        ct = torch.randn((4, L + 1, Bc), generator=gen, device=device)
        ct_ddt = torch.randn((2, L + 1, Bc), generator=gen, device=device)
        n = min(Bc, B_SUB)
        xs = cut_columns(x, n, Bc)
        cs, ds = ct[..., :n].contiguous(), ct_ddt[..., :n].contiguous()
        for mode in DDT_MODES:
            name = f"rt_adjoint_ddt_{mode}"
            cl = clouds[mode]
            cln = cut_columns(cl, n, Bc)
            kw = ddt_state(mode, x, cl, ngb0, wg)
            if mode in KEEPS_DDT:
                e = ddt_planes_err(mode, ddt_rads(mode, kw), xs, cln, ngb0,
                                   wg)
                need(e <= TOL_DDT_PLANES,
                     f"K1 SAVE {mode} idrv=1 ({tag}): the d/dT derivatives "
                     f"off by {e:.3g} of max |plain| > {TOL_DDT_PLANES}")
                print(f"K1 SAVE {mode} idrv=1 ({tag}): d/dT derivatives "
                      f"(planes 4-5) within {e:.3g} of max |plain, f64| on "
                      f"{n} columns")

            def k6(c=ct):
                return ddt_vjp(mode, x, cl, ngb0, wg, c, ct_ddt, kw)

            def plain(c=cs):
                return ddt_plain_vjp(mode, xs, cln, ngb0, wg, c, ds)
            runs = [(k6(), plain(), "")]
            need(all(g is None or torch.equal(g, h)
                     for g, h in zip(runs[0][0], k6())),
                 f"{name} ({tag}): two runs differ")
            if mode != "clear":         # the band-group tile's staging
                st = (k6_mr_info(L, ddt=True) if mode == "maxrand"
                      else k6_g_info(mode, L, ddt=True))["staging"]
                need(st == ("tma" if Bc % (16 if mode == "compact" else 4)
                            == 0 else "elements"),
                     f"{name} ({tag}): staged by {st} at B={Bc}")
            if tag == f"L={L_MAIN}":
                runs.append((k6(None), plain(None), ", ct None"))
            for got, ref, what in runs:
                e = [rel_err(g[..., :n], r) for g, r in zip(got, ref)
                     if r is not None]
                need(all(bool(torch.isfinite(g).all()) for g in got
                         if g is not None) and max(e) <= TOL_BWD_RT,
                     f"{name} ({tag}{what}): rel err {max(e):.3g} > "
                     f"{TOL_BWD_RT} (per output: {[f'{v:.2g}' for v in e]})")
                need(bool(got[4][3].any()),
                     f"{name} ({tag}{what}): no cotangent of dplankbnd_dt")
                errs[mode].append((max(float((g[..., :n] - r).abs().max())
                                       for g, r in zip(got, ref)
                                       if r is not None), max(e)))
                print(f"{name} ({tag}{what}): within {max(e):.3g} of max "
                      f"|plain vjp| on {n} columns, bitwise over two runs")
            if tag == f"L={L_MAIN}":
                res[name] = dict(
                    ms=cuda_ms(k6, 3), plain_ms=cuda_ms(plain, 1),
                    plain_ncol=n, **ddt_bound(mode, x, cl, ct, ct_ddt, kw,
                                              runs[0][0]))
            del kw, runs
        del x, clouds
    for mode in DDT_MODES:
        res[f"rt_adjoint_ddt_{mode}"].update(
            max_abs_err=max(a for a, _ in errs[mode]),
            max_rel_err=max(e for _, e in errs[mode]))
    return res


def ddt_rads(mode, kw):
    """The radiances K1 SAVE kept in ``mode`` at idrv=1, from the state
    keywords of ``utils.snapshot.ddt_state`` (maxrand's beside its packed
    sub-streams)."""
    return kw["state"][0] if mode == "maxrand" else kw["rads"]


def ddt_planes_err(mode, rads, xs, cln, ngb0, wg):
    """K1 SAVE's d/dT derivatives, planes 4-5 of ``rads`` on their first
    columns, against the plain sweep's in float64 on those columns' inputs
    ``xs``, ``cln`` (``utils.snapshot.ddt_plain_planes``): max |diff| /
    max |plain| over the two planes."""
    from rrtmg_lw_torch.utils.snapshot import ddt_plain_planes
    n = xs[0].shape[2]
    return rel_err(rads[4:6, ..., :n],
                   ddt_plain_planes(mode, xs, cln, ngb0, wg))


def ddt_cloudy_columns(mode, cl):
    """(B,) bool: the columns with a cloudy layer in ``mode``'s flat clouds
    ``cl`` (a mode of KEEPS_DDT), where K6 reads PC (K1 SAVE's plane 5)."""
    from rrtmg_lw_torch.ops import rtrn
    if mode == "banded":
        return (cl[0] >= rtrn.CLOUD_GATE).any(0)
    if mode == "maxrand":
        return cl[0][0, rtrn.ROW_ICLDDN] > 0.0
    return (cl[0][:, :140] >= 0.5).any(1).any(0)


def ddt_bound(mode, x, cl, ct, ct_ddt, kw, got):
    """``bound`` of K6 with the d/dT sweep's adjoint in ``mode`` on one
    case: K6's inputs in the mode read once (as its idrv=0 entry counts
    them: maxrand's sub-streams where K6 reads them, the gated per-g
    cloud inputs where the gate holds; in KEEPS_DDT K1 SAVE's derivative
    P, and its clear twin PC in the columns with a cloud), ct_ddt and
    surf's fourth row, the outputs written once; and ``scratch_gb``, the
    bytes of clear's scratch, written once and read once, beside the
    bound (0 in KEEPS_DDT)."""
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.rtrn_cuda import KEEPS_DDT
    L, _, B = x[0].shape
    ops = (OPS["rt_adjoint"] + 2 * OPS["rt_ddt"]) * x[0].numel()
    nbytes, read = 0, cl
    if mode == "maxrand":
        nsub = int(rtrn.substream_slots(cl[0])[1].sum())
        nbytes = 3 * 140 * 4 * nsub
    elif mode in GATED:
        ngate = int((cl[0][:, :140] >= 0.5).sum()) if GATED[mode] else 0
        nbytes = 4 * ngate * len(GATED[mode])
        read = [c for i, c in enumerate(cl) if i not in GATED[mode]]
    state = (ddt_rads(mode, kw),)
    if mode in KEEPS_DDT:
        nbytes += L * 140 * int(ddt_cloudy_columns(mode, cl).sum()) * 4
        state = (state[0][:5],)
    nlam = 0 if mode in KEEPS_DDT else 1
    return dict(scratch_gb=2 * nlam * L * 140 * B * 4 / 1e9,
                **bound((*x, *read, ct, ct_ddt, *state), got, ops,
                        nbytes=nbytes))


def maxrand_state_err(got, x5, clouds, ngb0, wg):
    """K1 maxrand's kept state ``got`` (fluxes, rads, subs) on the sweep
    inputs ``x5`` and ``clouds`` (rows_t, taucb_t) against the plain
    sweep's, both unpacked (``rtrn.unpack_state``), in chunks of B_CHUNK
    columns (at L_DEEP the first B_SUB): max |diff| / max |plain|; raises
    on a non-finite state."""
    from rrtmg_lw_torch.ops import rtrn
    L, _, B = x5[0].shape
    rows = clouds[0]
    ncmp = B if L == L_MAIN else min(B, B_SUB)
    d_max = r_max = 0.0
    for c0 in range(0, ncmp, B_CHUNK):
        c = slice(c0, min(c0 + B_CHUNK, ncmp))
        part = tuple(t[..., c].contiguous() for t in (*x5, *clouds))
        state = rtrn.unpack_state(got[1][..., c], got[2][..., c],
                                  rows[..., c])
        state_p = rtrn.unpack_state(*rtrn.rt_sweep_maxrand(
            *part, ngb0, wg, radiances=True)[1:], part[5])
        need(bool(torch.isfinite(state).all()),
             "K1 SAVE maxrand: non-finite state")
        d_max = max(d_max, float((state - state_p).abs().max()))
        r_max = max(r_max, float(state_p.abs().max()))
        del state, state_p
    return d_max / max(r_max, 1e-30)


def k1_save_cases(device):
    """K1 keeping the state K6 reads, in every mode at idrv 0 and 1, by
    both store paths: on phase 3's inputs with each mode's cell clouds
    (``utils.snapshot.k1_cloud_args``), on K1's edge cases
    (``k1_edge_args``), at L_DEEP (the mcica_cloudy_deep cell's
    atmosphere, ``g_cloud_args``' clouds), and on the first 4100 columns
    (a last 16-column tile of 4) and 37 of phase 3's inputs
    (``snapshot.SAVE_COLUMNS``).  Each case: the store path the
    launch took (``rtrn_cuda.k1_save_path``: bulk where B % 4 == 0, else
    scalar), its fluxes bitwise those of K1 without the state, the
    radiances (maxrand: the state unpacked, ``rtrn.unpack_state``) within
    TOL_RADS of max |plain| and bitwise over two runs; fused and
    cldf-odcld: the cloudy-layer words equal to the plain ones and K6 fed
    them within TOL_BWD_RT of the plain vjp on the first B_SUB columns;
    compact at idrv=1 likewise (its d/dT K6 on a seeded d/dT cotangent),
    at idrv=0 no words.
    -> {"<mode> idrv<i> <case>": store path}, printed."""
    from rrtmg_lw_torch.ops import rtrn, rtrnmr
    from rrtmg_lw_torch.ops.rtrn_cuda import (WRAPPERS, k1_save_path,
                                              rt_sweep_g_radiances,
                                              rt_sweep_g_vjp,
                                              rt_sweep_maxrand_radiances,
                                              rt_sweep_radiances,
                                              rt_sweep_vjp)
    from rrtmg_lw_torch.utils.snapshot import (SAVE_COLUMNS, compact_args,
                                               cut_columns, g_cloud_args,
                                               k1_cloud_args, k1_edge_args,
                                               sweep_inputs)
    x = sweep_inputs(device)
    static, args, dpl = x["static"], x["args"], x["sc"].dplankbnd_dt
    cell = {m: (w, tuple(c)) for m, (w, c) in k1_cloud_args(
        device, static, x["mc"]).items()}
    eargs, emodes, _ = k1_edge_args(device, static, args)
    xd = sweep_inputs(device, "mcica_cloudy_deep")
    gd = g_cloud_args(device, static, L_DEEP)
    deep = {"clear": ("blocked", ()),
            "compact": ("blocked", (compact_args(static, xd["mc"]),)),
            "banded": ("banded", gd["banded"]),
            "maxrand": ("maxrand", (rtrnmr.overlap_rows(
                gd["banded"][0].t().contiguous()), gd["banded"][1])),
            "fused": ("fused", (gd["fused"],)),
            "cldf_od": ("cldf_od", (gd["cldf_od"],))}
    sizes = [("cell", args, dpl, cell), ("edge", eargs, dpl, emodes),
             (f"L={L_DEEP}", xd["args"], xd["sc"].dplankbnd_dt, deep)]
    for n in SAVE_COLUMNS:
        sizes.append((f"B={n}", cut_columns(args, n, B_MAIN),
                      cut_columns(dpl, n, B_MAIN),
                      {m: (w, cut_columns(c, n, B_MAIN)) for m, (w, c)
                       in cell.items()}))
    gen = torch.Generator(device=device).manual_seed(17)
    paths = {}
    for tag, a9, dp, modes in sizes:
        L, _, B = a9[0].shape
        ngb0, wg = a9[7:]
        ct = torch.randn((4, L + 1, B), generator=gen, device=device)
        for mode, (w, clouds) in modes.items():
            for idrv in (0, 1):
                surf = rtrn.surf_rows(*a9[4:7], torch.float32,
                                      dp if idrv else None)
                x5 = (*a9[:4], surf)
                name = f"{mode} idrv{idrv} {tag}"
                if mode in ("clear", "compact"):
                    fields = clouds[0] if clouds else None
                    cf = ((None,) * 4 if fields is None
                          else (*fields[1:], fields[0]))

                    def keep():
                        return rt_sweep_radiances(*x5, *cf, ngb0, wg)
                    plain = rtrn.rt_sweep_blocked(*x5, ngb0, wg, fields,
                                                  radiances=True)
                elif mode == "maxrand":
                    def keep():
                        return rt_sweep_maxrand_radiances(*x5, *clouds,
                                                          ngb0, wg)
                    plain = None        # compared in chunks below
                else:
                    cl = clouds if mode == "banded" else clouds[0]

                    def keep():
                        return rt_sweep_g_radiances(mode, *x5, cl, ngb0, wg)
                    plain = (rtrn.rt_sweep_banded(*x5, *cl, ngb0, wg,
                                                  radiances=True)
                             if mode == "banded" else
                             rtrn.rt_sweep_blocked(*x5, ngb0, wg, cl,
                                                   radiances=True))
                got = keep()
                paths[name] = k1_save_path(mode)
                need(paths[name] == ("bulk" if B % 4 == 0 else "scalar"),
                     f"K1 SAVE {name}: store path {paths[name]} at B={B}")
                fl = WRAPPERS[w](*a9, *clouds,
                                 **(dict(dplankbnd_dt=dp) if idrv else {}))
                need(torch.equal(got[0], torch.cat(fl) if idrv else fl),
                     f"K1 SAVE {name}: fluxes differ from K1's without the "
                     "state")
                again = list(keep())
                if mode == "maxrand":
                    # the slots past a column's count are not written
                    _, counts = rtrn.substream_slots(clouds[0])
                    past = (torch.arange(got[2].shape[2], device=device)
                            [None, :, None] >= counts[:, None, :]
                            )[:, None, :, None, :]
                    again[2] = again[2].masked_fill(past, 0.0)
                    got = (*got[:2], got[2].masked_fill(past, 0.0))
                need(all(a is None and b is None or torch.equal(a, b)
                         for a, b in zip(got[1:], again[1:])),
                     f"K1 SAVE {name}: two runs differ")
                del again
                if mode == "maxrand":
                    e = maxrand_state_err(got, x5, clouds, ngb0, wg)
                else:
                    e = rel_err(got[1], plain[1])
                need(bool(torch.isfinite(got[1]).all()) and e <= TOL_RADS,
                     f"K1 SAVE {name}: radiances off by {e:.3g} of max "
                     f"|plain| > {TOL_RADS}")
                msg = (f"K1 SAVE {name} (B={B}, L={L}): {paths[name]} "
                       f"stores, fluxes bitwise K1's, radiances within "
                       f"{e:.3g} of max |plain|, bitwise over two runs")
                if mode in ("fused", "cldf_od"):
                    words = got[2]
                    need(torch.equal(words, plain[2]),
                         f"K1 SAVE {name}: cloudy-layer words differ from "
                         "the plain ones")
                    s3 = surf[:3].contiguous()
                    g6 = rt_sweep_g_vjp(*x5[:4], s3, cl, ngb0, wg, ct,
                                        rads=got[1], words=words)
                    sub = slice(0, min(B, B_SUB))
                    xs = tuple(t[..., sub].contiguous()
                               for t in (*x5[:4], s3, *cl))
                    ref = rtrn.rt_sweep_g_vjp(*xs[:5], xs[5:], ngb0, wg,
                                              ct[..., sub].contiguous())
                    e6 = max(rel_err(g[..., sub], r)
                             for g, r in zip(g6, ref))
                    need(all(bool(torch.isfinite(g).all()) for g in g6)
                         and e6 <= TOL_BWD_RT,
                         f"K6 {mode} fed K1 SAVE {name}: rel err {e6:.3g} "
                         f"> {TOL_BWD_RT}")
                    msg += (f"; words equal plain, K6 fed them within "
                            f"{e6:.3g} of max |plain vjp| on {sub.stop} "
                            "columns")
                    del g6, ref, xs
                if mode == "compact" and not idrv:
                    need(got[2] is None,
                         f"K1 SAVE {name}: words kept at idrv=0")
                if mode == "compact" and idrv:
                    words = got[2]
                    need(torch.equal(words, rtrn.cloudy_words(fields[0])),
                         f"K1 SAVE {name}: cloudy-layer words differ from "
                         "the plain ones (rtrn.cloudy_words of the mask)")
                    cd = torch.randn((2, L + 1, B), generator=gen,
                                     device=device)
                    g8 = rt_sweep_vjp(*x5, *cf, ngb0, wg, ct, rads=got[1],
                                      ct_ddt=cd, words=words)
                    sub = slice(0, min(B, B_SUB))
                    xs = tuple(t[..., sub].contiguous() for t in (*x5, *cf))
                    ref = rtrn.rt_sweep_vjp(
                        *xs, ngb0, wg, torch.cat([ct, cd])[..., sub]
                        .contiguous())
                    e8 = max(rel_err(g[..., sub], r) for g, r in zip(g8, ref))
                    need(all(bool(torch.isfinite(g).all()) for g in g8)
                         and e8 <= TOL_BWD_RT,
                         f"K6 compact d/dT fed K1 SAVE {name}: rel err "
                         f"{e8:.3g} > {TOL_BWD_RT}")
                    msg += (f"; words equal plain, K6's d/dT fed them within "
                            f"{e8:.3g} of max |plain vjp| on {sub.stop} "
                            "columns")
                    del g8, ref, xs
                print(msg)
                del got, plain
        torch.cuda.empty_cache()
    for p in ("bulk", "scalar"):
        print(f"K1 SAVE store paths: {p} in "
              f"{sum(v == p for v in paths.values())} cases: "
              + ", ".join(k for k, v in paths.items() if v == p))
    return paths


def grad_device_times():
    """Device ms of K1 keeping the radiances and of K6 fed them, compact
    McICA on phase 3's inputs, maxrand and the ``G_MODES`` on their cells'
    clouds, of K5 (L=60; L=140 printed) and of K8 (icld 2 at L=60; icld 4
    and L=140 beside it), from ``utils/snapshot.py --k5-times --k6-times
    --k8-times`` in a process of its own:
    in this script's long process the profiler's traces of these launches
    held 3 of 5 early and one or none late (phase 6 holds their results
    and their wrapper ms).  -> {summary name: device ms}."""
    from rrtmg_lw_torch import _build
    out6 = _build.BUILD_ROOT / "k6_times.json"
    out5 = _build.BUILD_ROOT / "k5_times.json"
    outd = _build.BUILD_ROOT / "k6_ddt_times.json"
    out8 = _build.BUILD_ROOT / "k8_times.json"
    for out in (out5, out6, outd, out8):
        out.unlink(missing_ok=True)
    res = subprocess.run(
        [sys.executable, "-m", "rrtmg_lw_torch.utils.snapshot",
         "--k5-times", str(out5), "--k6-times", str(out6),
         "--k6-ddt-times", str(outd), "--k8-times", str(out8)],
        capture_output=True, text=True,
        cwd=pathlib.Path(__file__).resolve().parent, timeout=600)
    print(res.stdout, end="")
    need(res.returncode == 0
         and all(o.exists() for o in (out5, out6, outd, out8)),
         f"snapshot.py --k5-times --k6-times --k6-ddt-times --k8-times "
         f"failed:\n{res.stderr[-3000:]}")
    all_rows = json.loads(out6.read_text())
    rows = {r["mode"]: r for r in all_rows if r["nlay"] == L_MAIN}
    deep = {r["mode"]: r for r in all_rows if r["nlay"] == L_DEEP}
    k5 = {r["nlay"]: r["device_ms"] for r in json.loads(out5.read_text())}
    print("device ms, K1 keeping the radiances (without), K6: " + "; ".join(
        f"{m} {r['k1_save_ms']:.3f} ({r['k1_ms']:.3f}), {r['k6_ms']:.3f}"
        for m, r in rows.items() if m != "clear")
          + f"; K5 {k5[L_MAIN]:.3f} (L={L_DEEP}: {k5[L_DEEP]:.3f})")
    print(f"device ms at L={L_DEEP}, K1 keeping the radiances (without), "
          "K6: " + "; ".join(
              f"{m} {r['k1_save_ms']:.3f} ({r['k1_ms']:.3f}), "
              f"{r['k6_ms']:.3f}" for m, r in deep.items()))
    out = {"rt_sweep_save": rows["compact"]["k1_save_ms"],
           "rt_adjoint": rows["compact"]["k6_ms"], "taumol_bwd": k5[L_MAIN]}
    for m in ("maxrand", *G_MODES):
        out[f"rt_sweep_save_{m}"] = rows[m]["k1_save_ms"]
        out[f"rt_adjoint_{m}"] = rows[m]["k6_ms"]
    # K6 with the d/dT sweep's adjoint: at L_MAIN, and at L_DEEP beside it
    ddt = json.loads(outd.read_text())
    for m in DDT_MODES:
        ms = {r["nlay"]: r["k6_ddt_ms"] for r in ddt if r["mode"] == m}
        k1 = {r["nlay"]: r["k1_save_ms"] for r in ddt if r["mode"] == m}
        out[f"rt_adjoint_ddt_{m}"] = dict(
            device_ms=ms[L_MAIN], device_ms_deep=ms[L_DEEP],
            k1_save_idrv_ms=k1[L_MAIN], k1_save_idrv_ms_deep=k1[L_DEEP])
    k8 = {(r["icld"], r["nlay"], r.get("dtype", "float32")): r["device_ms"]
          for r in json.loads(out8.read_text())}
    out["mcica"] = dict(device_ms=k8[2, L_MAIN, "float32"],
                        device_ms_icld4=k8[4, L_MAIN, "float32"],
                        device_ms_deep=k8[2, L_DEEP, "float32"])
    print("device ms, K8 (int8 mask): " + ", ".join(
        f"{dt} icld {i} L={n} {ms:.4f}" for (i, n, dt), ms in k8.items()))
    print(f"device ms, K6 with the d/dT adjoint (at L={L_DEEP}): "
          + "; ".join(f"{m} {out[f'rt_adjoint_ddt_{m}']['device_ms']:.3f} "
                      f"({out[f'rt_adjoint_ddt_{m}']['device_ms_deep']:.3f})"
                      for m in DDT_MODES))
    return out


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


# the gradient cells' launches per step, w.r.t. the Atmosphere and the
# cell's cloud fields (utils/profiling.py Cell.cloud_grads): K1's launch
# that keeps the radiances also counts on its mode's wrapper
GRAD_BWD = dict(taumol_bwd=1, planck_bwd=2)
GRAD_CELLS = {
    "maxrand_cloudy_grad": dict(
        FWD, **GRAD_BWD, rt_sweep_maxrand=1, rt_sweep_save_maxrand=1,
        overlap_rows=1, overlap_bwd=1, rt_adjoint_maxrand=1),
    "band_cloudy_grad": dict(
        FWD, **GRAD_BWD, rt_sweep_banded=1, rt_sweep_save_banded=1,
        rt_adjoint_banded=1, cldcoef_bwd=1),
    "mcica_blocked_grad": dict(
        FWD, **GRAD_BWD, rt_sweep_fused=1, rt_sweep_save_fused=1,
        rt_adjoint_fused=1, cldcoef_bwd=1),
    "mcica_tauc_grad": dict(
        NO_K4, **GRAD_BWD, rt_sweep_cldf_od=1, rt_sweep_save_cldf_od=1,
        rt_adjoint_cldf_od=1)}
# the d/dT adjoint's main path: the ``*_ddt_grad`` cells of
# utils/profiling.py, the gradient step at idrv=1 of a loss linear in
# uflx, duflx_dt and duflxc_dt (``ddt``), one a mode, and maxrand's once
# at icld=3: (its cell, steps, config overrides).  Their launches a step:
# those of the mode's gradient cell with K6's d/dT instantiation in place
# of K6, K1 counted on its wrapper's idrv counter too
GRAD_OVERRIDES = {"maxrand_cloudy_icld3_ddt_grad": (
    "maxrand_cloudy_ddt_grad", 1, dict(icld=3))}
GRAD_CELLS.update({
    "clear_ddt_grad": dict(NO_K4, **GRAD_BWD, rt_sweep=1, rt_sweep_idrv=1,
                           rt_sweep_save=1, rt_adjoint_ddt_clear=1),
    "mcica_cloudy_ddt_grad": dict(FWD, **GRAD_BWD, rt_sweep=1,
                                  rt_sweep_idrv=1, rt_sweep_save=1,
                                  rt_adjoint_ddt_compact=1),
    "band_cloudy_ddt_grad": dict(
        FWD, **GRAD_BWD, rt_sweep_banded=1, rt_sweep_banded_idrv=1,
        rt_sweep_save_banded=1, rt_adjoint_ddt_banded=1, cldcoef_bwd=1),
    "mcica_blocked_ddt_grad": dict(
        FWD, **GRAD_BWD, rt_sweep_fused=1, rt_sweep_fused_idrv=1,
        rt_sweep_save_fused=1, rt_adjoint_ddt_fused=1, cldcoef_bwd=1),
    "mcica_tauc_ddt_grad": dict(
        NO_K4, **GRAD_BWD, rt_sweep_cldf_od=1, rt_sweep_cldf_od_idrv=1,
        rt_sweep_save_cldf_od=1, rt_adjoint_ddt_cldf_od=1)})
GRAD_CELLS["maxrand_cloudy_ddt_grad"] = GRAD_CELLS[
    "maxrand_cloudy_icld3_ddt_grad"] = dict(
        FWD, **GRAD_BWD, rt_sweep_maxrand=1, rt_sweep_maxrand_idrv=1,
        rt_sweep_save_maxrand=1, overlap_rows=1, overlap_bwd=1,
        rt_adjoint_ddt_maxrand=1)


def cloud_columns(clouds, cols):
    """The columns ``cols`` (a slice) of BandClouds, McicaCloudsBlocked
    (whose per-g arrays have the columns last), McicaCloudsCompact (its
    mask too) or None."""
    from rrtmg_lw_torch import McicaCloudsBlocked, McicaCloudsCompact
    if clouds is None:
        return None
    if isinstance(clouds, McicaCloudsBlocked):
        return McicaCloudsBlocked(*(x[..., cols].contiguous()
                                    for x in clouds[:4]),
                                  *(x[cols] for x in clouds[4:]))
    if isinstance(clouds, McicaCloudsCompact):
        return McicaCloudsCompact(clouds.cldfmc[..., cols].contiguous(),
                                  *(x[cols] for x in clouds[1:]))
    return type(clouds)(*(x[cols] for x in clouds))


def grad_cell(device, counters, tag):
    """The gradient step of cell ``tag`` (utils/profiling.py, B=16384,
    L=60; a ``GRAD_OVERRIDES`` tag: its cell, steps and config overrides)
    through the kernels, w.r.t. every Atmosphere field and the cell's
    cloud fields: 3 timed steps with every launch counter set to 0 just
    before and read just after (GRAD_CELLS[tag] a step, 0 for the
    others), peak memory; its gradients of a loss linear in the four flux
    arrays (a ``ddt`` cell: in ``profiling.DDT_LOSS``, the timed steps'
    loss too) with seeded cotangents on all 16384 columns against the
    eager step's, run in B_CHUNK-column chunks, within TOL_STEP of max
    |eager| per field.  -> (launches in the timed steps, e2e row)."""
    from rrtmg_lw_torch import McicaCloudsBlocked
    from rrtmg_lw_torch.parallel import make_grad_step
    from rrtmg_lw_torch.utils.profiling import CELLS, DDT_LOSS
    cell, steps, kw = GRAD_OVERRIDES.get(tag, (tag, STEPS, {}))
    ddt = CELLS[cell].ddt
    names = DDT_LOSS if ddt else ("uflx", "dflx", "uflxc", "dflxc")
    atm, cl = inputs(cell, device)
    fields = CELLS[cell].cloud_grads
    gen = torch.Generator(device=device).manual_seed(7)
    cts = [torch.randn(B_MAIN, L_MAIN + 1, generator=gen, device=device)
           for _ in names]

    def linear(cts):
        return lambda f: sum((c * getattr(f, n)).sum()
                             for c, n in zip(cts, names))

    def run(step, atm, cl):
        """(loss, Atmosphere grads, cloud grads) of a step"""
        out = step(atm, cl)
        return out if fields else (*out, ())

    model = CELLS[cell].make_model(device, impl="cuda", **kw)
    step = make_grad_step(model, linear(cts) if ddt else None, fields)
    run(step, atm, cl)                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, ga, gc = run(step, atm, cl)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: GRAD_CELLS[tag].get(k, 0) * steps for k in counters}
    need(counts == want, f"{tag}: launches {counts}, expected {want}")
    need(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in (*ga, *gc)),
         f"{tag}: non-finite loss or gradient")
    print(f"{tag}: launches in its {steps} steps: {counts}; "
          f"{ms:.2f} ms a step (host clock, synchronized); peak "
          f"{peak:.3f} GiB")
    del step, ga, gc
    _, gk, ck = run(make_grad_step(model, linear(cts), fields), atm, cl)
    eager = CELLS[cell].make_model(device, impl="eager", **kw)
    chunks = []
    for i in range(0, B_MAIN, B_CHUNK):
        s = slice(i, i + B_CHUNK)
        _, ga, gc = run(make_grad_step(eager, linear([c[s] for c in cts]),
                                       fields),
                        type(atm)(*(x[s] for x in atm)),
                        cloud_columns(cl, s))
        chunks.append((*ga, *gc))
    # McicaCloudsBlocked's per-g arrays have the columns last
    last = len(gk) + 4 if isinstance(cl, McicaCloudsBlocked) else 0
    ge = [torch.cat(g, dim=-1 if i < last and i >= len(gk) else 0)
          for i, g in enumerate(zip(*chunks))]
    worst, err = grad_errs(tag, gk, type(gk)(*ge[:len(gk)]))
    cerr = {n: rel_err(g, r) for n, g, r in zip(fields, ck, ge[len(gk):])}
    cmax = max(cerr.values(), default=0.0)
    need(all(bool(torch.isfinite(g).all()) for g in ck),
         f"{tag}: non-finite cloud gradient")
    if fields:
        print(f"{tag}: cloud gradients, kernels vs eager, max rel err "
              + ", ".join(f"{k} {v:.2g}" for k, v in cerr.items()))
    need(err <= TOL_STEP and cmax <= TOL_STEP,
         f"{tag}: gradient of {worst} off by {err:.3g}, cloud "
         f"gradients by {cmax:.3g} of max |eager|")
    # zero only where eager's is (mcica_blocked's taucmc: every cloudy
    # g-point there has water, and cldprmc reads taucmc only where none)
    zero = [n for n, g, r in zip(fields, ck, ge[len(gk):])
            if bool(g.any()) != bool(r.any())]
    need(not zero and (not fields or bool(ck[0].any())),
         f"{tag}: zero cloud gradients where eager's are not: {zero}")
    row = dict(cell=tag, impl="cuda", ncol=B_MAIN, nlay=L_MAIN,
               ms_per_step=ms, cols_per_sec=B_MAIN / (ms * 1e-3),
               peak_gib=peak, grad_rel_err_vs_eager=max(err, cmax))
    del model, eager, gk, ck, ge, chunks
    torch.cuda.empty_cache()
    return counts, row


def phase_grad_idrv(device):
    """The McICA gradient step (default loss) at idrv=1 runs through K6
    and gives the idrv=0 step's loss and gradients bitwise (the loss reads
    no d/dT; both with deterministic algorithms, under which two idrv=0
    steps are bitwise equal too), and so does the maxrand step (K6
    maxrand, w.r.t. the Atmosphere and the clouds): with no d/dT
    cotangent the idrv=0 instantiations of K6 run (a loss that reads d/dT:
    the ``*_ddt_grad`` cells)."""
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
    # the maxrand step at idrv 0 (twice) and 1
    _, bc = inputs("maxrand_cloudy", device)
    cfg = CELLS["maxrand_cloudy_grad"].config
    steps = [make_grad_step(make_model(cfg(impl="cuda", idrv=i),
                                       device=device),
                            cloud_fields=CELLS["maxrand_cloudy_grad"]
                            .cloud_grads) for i in (0, 0, 1)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = [step(atm, bc) for step in steps]
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, g0, c0), (lr, gr, cr), (l1, g1, c1) = out
    need(torch.equal(l0, lr) and not diffs(g0, gr)
         and all(torch.equal(a, b) for a, b in zip(c0, cr)),
         f"maxrand_cloudy_grad: two deterministic steps differ: "
         f"{diffs(g0, gr)}")
    need(torch.equal(l0, l1) and not diffs(g0, g1)
         and all(torch.equal(a, b) for a, b in zip(c0, c1)),
         f"maxrand_cloudy_idrv_grad: gradients differ from idrv=0's: "
         f"{diffs(g0, g1)}")
    print("maxrand_cloudy_idrv_grad: loss and gradients (Atmosphere and "
          "clouds) bitwise equal to idrv=0's (deterministic algorithms)")
    del steps, out
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


# K8, the McICA sampler: columns of its bitwise checks against the plain
# version (the plain draw's int64 temporaries at the main width are ~275 MB
# each), on its vector-store path and on its element-store path (B % 4 !=
# 0), and of its statistics and the generate-then-radiate step
B_K8 = 2048
B_K8_ODD = 2051
MCICA_CELLS = {2: "mcica_generate", 4: "mcica_generate_icld4"}


def k8_ops(icld, B, L, dtype):
    """K8's operations at (B, L): Philox calls (one a (g, column) at icld
    3, else one a block of 4 (float32) or 2 (float64) layers, twice at
    icld 4/5) and the overlap walk."""
    from rrtmg_lw_torch.ops import mcica
    per = mcica.per_call(dtype)
    calls = B * 140 * (1 if icld == 3 else -(-L // per)
                       * (2 if icld in (4, 5) else 1))
    return calls * PHILOX_OPS + B * 140 * L * MCICA_OPS


def k8_build_info(log_path):
    """Registers and spill stores of K8's 64 instantiations (input
    type, mask type, overlap, given uniforms, vector or element stores)
    from the build log."""
    from rrtmg_lw_torch import _build
    names = dict(f="f32", d="f64", a="int8")
    return _build.ptxas_info(
        log_path, r"mcica_kernelI(f|d)(a|f|d)Li(\d)ELb([01])ELb([01])E",
        lambda m: f"{names[m.group(1)]} {names[m.group(2)]} mask ovl"
                  f"{m.group(3)}{' given' if m.group(4) == '1' else ''}"
                  f"{' vec' if m.group(5) == '1' else ' scalar'}")


def k8_fields(B, L, dtype, device, seed):
    """make_cloud_profile_fields' cloud fraction with random fractions,
    zeros, ones and values below CLDMIN in a third of the cells (every
    branch of the overlap walk), and a random alpha."""
    from rrtmg_lw_torch.utils.synthetic import make_cloud_profile_fields
    gen = torch.Generator(device=device).manual_seed(seed)
    cf = torch.as_tensor(make_cloud_profile_fields(B, L, seed=seed)
                         ["cldfrac"], device=device).to(dtype)
    r = torch.rand((B, L), generator=gen, device=device, dtype=dtype)
    cf = torch.where(r < 0.3, torch.where(r < 0.03, 1e-25, (r * 4).clamp(
        max=1.0)), cf)
    return cf, torch.rand((B, L), generator=gen, device=device, dtype=dtype)


def k8_statistics(device):
    """tests/test_mcica.py's statistics on K8's output at B=16384:
    per-layer cloudy fraction within 0.02 (icld 1-5; icld 3 level-uniform
    decks), pairwise overlap of adjacent and separated decks (icld 1, 2,
    3, 5), the compact binomial envelope (icld 1-3)."""
    from rrtmg_lw_torch.ops import mcica
    B = B_MAIN

    def mask(icld, cf, alpha=None, seed=0):
        return mcica.mcica_subcol_lw_compact(
            mcica.key(seed), icld, cf, cf, cf, cf, cf, alpha=alpha,
            mask_dtype=torch.int8).cldfmc[:, :140].bool()
    cf = torch.zeros((B, 20), device=device)
    cf[:, 4:8], cf[:, 12:14] = 0.6, 0.3
    alpha = torch.full((B, 20), 0.8, device=device)
    for icld in (1, 2, 3, 4, 5):
        m = mask(icld, cf, alpha)
        frac = m.float().mean(dim=(1, 2))
        need(float((frac[4:8] - 0.6).abs().max()) <= 0.02
             and float((frac[12:14] - 0.3).abs().max()) <= 0.02
             and frac[0] == 0 and frac[-1] == 0,
             f"K8 icld={icld}: per-layer cloudy fraction {frac.tolist()}")
        need(icld != 3 or bool((m[4:8] == m[4:5]).all()),
             "K8 icld=3: the deck's mask differs between layers")
    cf = torch.zeros((B, 9), device=device)
    cf[:, 1:3] = cf[:, 5:7] = 0.6
    joint = {}
    for icld, within, across in ((1, 0.36, 0.36), (2, 0.60, 0.36),
                                 (3, 0.60, 0.60), (5, 0.552, None)):
        m = mask(icld, cf, torch.full((B, 9), 0.8, device=device), seed=3)
        w = float((m[1] & m[2]).float().mean())
        a = float((m[2] & m[5]).float().mean())
        need(abs(w - within) <= 0.02
             and (across is None or abs(a - across) <= 0.02),
             f"K8 icld={icld}: joint cloudy fraction {w:.4f} within a deck, "
             f"{a:.4f} across, expected {within}, {across}")
        joint[icld] = (w, a)
    gen = torch.Generator(device=device).manual_seed(3)
    cf = torch.rand((B, 12), generator=gen, device=device).clamp(0.05, 0.95)
    sig = (cf * (1 - cf) / 140).sqrt()
    for icld in (1, 2, 3):
        m = mask(icld, cf, seed=11)
        frac = m.float().mean(dim=1).t()
        share = float(((frac - cf).abs() < 4.5 * sig + 1e-9).float().mean())
        need(share > 0.99, f"K8 icld={icld}: {share:.4f} of the cells "
             "inside the binomial envelope")
        if icld == 3:
            order = cf.t().argsort(dim=0)[:, None, :].expand(m.shape)
            mono = m.to(torch.int8).gather(0, order).diff(dim=0) >= 0
            need(bool(mono.all()),
                 "K8 icld=3: the mask is not monotone in the cloud fraction")
    print(f"mcica statistics at B={B}: per-layer fractions within 0.02, "
          "joint (within, across) " + ", ".join(
              f"icld {k} {w:.4f} {a:.4f}" for k, (w, a) in joint.items())
          + "; the binomial envelope holds")


def phase_mcica(device, counters):
    """K8 (csrc/mcica.cu) and the generate-then-radiate step.  -> (the
    summary entry, K8's launches on the main path, e2e rows)."""
    from rrtmg_lw_torch import _build, make_model
    from rrtmg_lw_torch.ops import mcica
    from rrtmg_lw_torch.ops.mcica_cuda import philox_words, subcol_mask
    from rrtmg_lw_torch.utils import profiling
    t0 = time.perf_counter()
    # (a) bitwise against the plain version: the draw, and the overlap walk
    # on given uniforms
    gen = torch.Generator(device=device).manual_seed(8)
    paths = {}
    for B, Ls in ((B_K8, (L_MAIN, L_DEEP)), (B_K8_ODD, (L_MAIN, L_DEEP)),
                  (B_MAIN, (L_MAIN,))):
        for L, dt in itertools.product(Ls, (torch.float32, torch.float64)):
            cf, al = k8_fields(B, L, dt, device, seed=L)
            u = torch.rand((L, 140, B), generator=gen, device=device,
                           dtype=dt)
            u2 = torch.rand((L, 140, B), generator=gen, device=device,
                            dtype=dt)
            for icld in (1, 2, 3, 4, 5):
                alpha = al if icld in (4, 5) else None
                k = mcica.fold_in(mcica.key(L), icld)
                for mdt in (torch.int8, dt):
                    n = {p: getattr(subcol_mask, p).launches
                         for p in ("vector", "scalar")}
                    got = mcica.mcica_subcol_lw_compact(
                        k, icld, cf, cf, cf, cf, cf, alpha=alpha,
                        mask_dtype=mdt).cldfmc
                    given = subcol_mask(None, icld, cf, alpha, mask_dtype=mdt,
                                        uniforms=(u, u2))
                    for p in n:
                        if getattr(subcol_mask, p).launches - n[p] == 2:
                            paths.setdefault(B, set()).add(p)
                    need(torch.equal(got, mcica.subcol_mask(
                        k, icld, cf, alpha, mask_dtype=mdt))
                         and torch.equal(given, mcica.mask_from_uniforms(
                             icld, cf, u, u2, alpha, mask_dtype=mdt)),
                         f"K8 B={B} icld={icld} L={L} {dt} -> {mdt}: not "
                         "bitwise the plain version")
            del u, u2
    want = {B: {"vector" if B % 4 == 0 else "scalar"}
            for B in (B_K8, B_K8_ODD, B_MAIN)}
    need(paths == want, f"K8's store paths {paths}, expected {want}")
    print(f"mcica: K8 bitwise the plain version at B={B_K8} and {B_K8_ODD} "
          f"(L={L_MAIN} and {L_DEEP}) and B={B_MAIN} (L={L_MAIN}), icld "
          "1-5, float32 and float64 in, int8 and float masks, drawing and "
          "on given uniforms; store paths " + ", ".join(
              f"B={B} {'/'.join(sorted(p))}" for B, p in paths.items()))
    # (b) the hand-written Philox against curand's and the plain version
    ctr = torch.randint(-2 ** 31, 2 ** 31 - 1, (4096, 4), generator=gen,
                        device=device, dtype=torch.int32)
    for k in ((0, 0), (0xA4093822, 0x299F31D0), mcica.key(2 ** 40 + 5)):
        hand = philox_words(ctr, k)
        need(torch.equal(hand, philox_words(ctr, k, curand=True))
             and torch.equal(hand.cpu().to(torch.int64) & mcica.M32,
                             philox_words(ctr.cpu(), k)),
             f"Philox4x32-10 under key {k}: K8's differs from curand's")
    print("mcica: the hand-written Philox4x32-10 equals curand_Philox4x32_10 "
          "and the plain version on 4096 counters under 3 keys")
    # (c) statistics of K8's own draws at full width
    k8_statistics(device)
    torch.cuda.empty_cache()

    # (d) the main path: generate then radiate at B=16384, L=60, each step
    # counted on every counter
    per_step = dict(FWD, rt_sweep=1, mcica=1)
    rows, out = [], {}
    for icld, cell in MCICA_CELLS.items():
        atm, f = profiling.cell_inputs(cell, device)
        cfg = profiling.CELLS[cell].config
        mk = make_model(cfg(impl="cuda"), device=device)
        me = make_model(cfg(impl="eager"), device=device)

        def sample(i):
            return mcica.mcica_subcol_lw_compact(
                mcica.fold_in(mcica.key(0), i), icld, **f,
                mask_dtype=torch.int8)
        mk(atm, sample(0))                          # warm-up
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        w0 = time.perf_counter()
        for i in range(1, STEPS + 1):
            clouds = sample(i)
            fk = mk(atm, clouds)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - w0) * 1e3 / STEPS
        counts = {k: fn.launches for k, fn in counters.items()}
        want = {k: per_step.get(k, 0) * STEPS for k in counters}
        need(counts == want, f"{cell}: launches {counts}, expected {want}")
        out.setdefault("launches", counts["mcica"])
        fe = me(atm, clouds)
        err = compare_models(cell, fk, fe, True)
        need(not torch.allclose(fk.uflx, fk.uflxc),
             f"{cell}: the clouds left the all-sky fluxes unchanged")
        print(f"{cell}: launches in its {STEPS} steps {counts}; flux err "
              f"cuda vs eager {err:.3g}; {ms:.2f} ms a step")
        if icld == 2:
            # K8 at the main path's shape: wrapper ms, plain ms (bitwise at
            # full width), torch.rand of the uniforms it draws, the bound
            cf = f["cldfrac"]
            k = mcica.key(1)
            mask = subcol_mask(k, 2, cf, mask_dtype=torch.int8)
            plain = mcica.subcol_mask(k, 2, cf, mask_dtype=torch.int8)
            need(torch.equal(mask, plain),
                 "K8 at B=16384: not bitwise the plain version")
            del plain
            out.update(
                max_abs_err=0.0,
                ms=cuda_ms(lambda: subcol_mask(k, 2, cf,
                                               mask_dtype=torch.int8), 20),
                plain_ms=cuda_ms(lambda: mcica.subcol_mask(
                    k, 2, cf, mask_dtype=torch.int8), 2),
                rand_ms=cuda_ms(lambda: torch.rand(
                    (L_MAIN, 140, B_MAIN), device=device), 20),
                **{f"ms_icld{n}": cuda_ms(lambda: subcol_mask(
                    k, n, cf, mask_dtype=torch.int8), 20) for n in (1, 3)},
                library_note="none: a scan with carries",
                **bound((cf,), (mask,), k8_ops(2, B_MAIN, L_MAIN,
                                               torch.float32)))
        else:
            fa = f["alpha"]
            out.update(ms_icld4=cuda_ms(lambda: subcol_mask(
                mcica.key(1), icld, f["cldfrac"], fa,
                mask_dtype=torch.int8), 20),
                rand_ms_icld4=cuda_ms(lambda: torch.rand(
                    (2, L_MAIN, 140, B_MAIN), device=device), 20))
        del mk, me, atm, f, fk, fe, clouds
        torch.cuda.empty_cache()
    # the steps profiled with nothing else held, beside the same forward
    # step on fixed McICA clouds (mcica_cloudy): K8's cost end to end
    for cell in ("mcica_cloudy", *MCICA_CELLS.values()):
        row = profiling.profile_cell(cell, device)
        rows.append(row)
        print(f"{cell}: profiled, wall {row['wall_ms_median']:.2f} ms (q1 "
              f"{row['wall_ms_q1']:.2f}, q3 {row['wall_ms_q3']:.2f}), busy "
              f"{row['busy_ms']:.2f} ms, idle {row['idle_share']:.3f}, "
              f"{row['launches_per_step']:.1f} launches a step, K8 "
              f"{row['kernel_ms'].get('K8', 0):.4f} ms, peak "
              f"{row['peak_gib']:.2f} GiB")
        torch.cuda.empty_cache()
    path, _ = _build.build()
    info = k8_build_info(path.parent / "build.log")
    need(len(info) == 64 and all(r.get("spill_bytes", 0) == 0
                                 for r in info.values()),
         f"K8: {len(info)} instantiations in the build log, or a spill")
    main = info["f32 int8 mask ovl2 vec"]
    out.update(registers=main["registers"], spill_bytes=0,
               registers_max=max(r["registers"] for r in info.values()))
    print(f"mcica (K8, f32 in, int8 mask, icld 2): wrapper {out['ms']:.4f} "
          f"ms (icld 1: {out['ms_icld1']:.4f}, icld 3: {out['ms_icld3']:.4f}, "
          f"icld 4: {out['ms_icld4']:.4f}), plain {out['plain_ms']:.2f} "
          f"ms, torch.rand of its uniforms {out['rand_ms']:.4f} ms (icld 4: "
          f"{out['rand_ms_icld4']:.4f}), bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}), {main['registers']} registers (at most "
          f"{out['registers_max']} of 64 instantiations), no spills; "
          f"phase {time.perf_counter() - t0:.1f} s")
    return out, rows


def phase_cli(device):
    """The column-mode CLI on the card: ``run_case`` on a clear AUTLAY
    deck and a McICA deck (icld=2, nmca=2) written to a temporary
    directory, the model's tensors on the card, its raws within 1e-10 of
    the same run on the CPU."""
    import tempfile
    from rrtmg_lw_torch import cli
    from rrtmg_lw_torch.io import read_input_rrtm
    from rrtmg_lw_torch.utils.synthetic import write_column_deck
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in (("clear", {}), ("mcica", dict(icld=2, imca=1))):
            case = read_input_rrtm(write_column_deck(
                pathlib.Path(tmp) / name, **kw))
            gpu, raws = cli.run_case(case, nmca=2, return_raw=True)
            cpu, ref = cli.run_case(case, nmca=2, return_raw=True,
                                    device="cpu")
            need(all(r["device"].startswith("cuda") for r in raws)
                 and all(r["device"] == "cpu" for r in ref),
                 f"cli {name}: ran on {[r['device'] for r in raws]}")
            err = max(float(np.abs(a[k] - b[k]).max()) for a, b in
                      zip(raws, ref) for k in ("uflx", "dflx", "fnet",
                                               "htr"))
            need(err <= 1e-10 and len(gpu) == len(cpu) == 1,
                 f"cli {name}: card against CPU {err:.3g}")
            same = "text-identical" if gpu == cpu else "differ in print"
            print(f"cli {name} ({case.nlayers} layers): card against CPU "
                  f"{err:.3g}, the blocks {same}")
    print(f"cli: {time.perf_counter() - t0:.1f} s")


# 2e. the parallel layer (phase_parallel): entry point 1, the GCM step over
# make_sharded_step and run_epoch, and entry point 2, the wire stream, on a
# one-rank NCCL group; K9 (csrc/wire.cu) against its plain twin
B_GRAD_PAR = 4096       # columns of the sharded grad step's check
TOL_GRAD_PAR = 1e-6     # sharded vs one-device grad, of max |grad| per field
TOL_WIRE_ULP = 2        # K9's logratio (expf) against the plain twin's exp
B_WIRE_CHECK = (B_MAIN, 2051)   # K9 against the plain twin; 2051: a tail
#                                 off 4 and 8 columns
WIRE_OPS = 10           # K9's operations an element (convert, scale, add,
#                         exp, multiply, compare, select; the guards)
ATM_CORRUPT = ("nan_ref", "inf_lo", "nan_hi", "inverted", "zero_codes",
               "nan_uniform")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ulps(a, b):
    """Largest distance of ``a`` from ``b`` in ulps of the larger of the
    two (equal NaNs 0; a NaN against a number inf)."""
    a, b = a.double().flatten(), b.double().flatten()
    both = torch.isnan(a) & torch.isnan(b)
    m = torch.maximum(a.abs(), b.abs()).to(torch.float32)
    sp = (torch.nextafter(m, torch.full_like(m, float("inf"))) - m).double()
    d = torch.where(both, 0.0, (a - b).abs() / sp)
    return float(d.nan_to_num(nan=float("inf")).max()) if d.numel() else 0.0


def corrupt(enc, which, cols=slice(None, None, 3)):
    """``enc`` (a host atmosphere WireBatch) with one corruption of
    tests/test_wire.py:434-526: play's refs (NaN row, -inf lo, NaN hi,
    inverted range), play's codes zero (0 hPa) in ``cols``, or a NaN in a
    uniform channel's row (co2vmr)."""
    from rrtmg_lw_torch.parallel import wire as w
    cols_, refs = dict(enc.cols), dict(enc.refs)
    if which == "zero_codes":
        p = np.array(cols_["play"])
        p[cols] = 0
        cols_["play"] = p
    elif which == "nan_uniform":
        row = np.array(refs["co2vmr"]["uniform"])
        row[1] = np.nan
        refs["co2vmr"] = {"uniform": row}
    else:
        ref, lo, hi = refs["play"]
        refs["play"] = {"nan_ref": (np.full_like(np.asarray(ref), np.nan),
                                    lo, hi),
                        "inf_lo": (ref, np.float32(-np.inf), hi),
                        "nan_hi": (ref, lo, np.float32(np.nan)),
                        "inverted": (ref, hi, lo)}[which]
    return w.WireBatch(cols_, refs)


@contextlib.contextmanager
def plain_decode():
    """K9's wrappers (``ops.wire_cuda.wire_decode``, ``wire_unpack_mask``)
    swapped for their plain twins (``parallel.wire.decode_plain``,
    ``unpack_mask``) on every device: the decoders, and a step built on
    them, then run the reference K9 is held to.  Their launch counts do
    not move."""
    from rrtmg_lw_torch.ops import wire_cuda
    from rrtmg_lw_torch.parallel import wire as w
    saved = wire_cuda.wire_decode, wire_cuda.wire_unpack_mask
    wire_cuda.wire_decode, wire_cuda.wire_unpack_mask = (w.decode_plain,
                                                         w.unpack_mask)
    try:
        yield
    finally:
        wire_cuda.wire_decode, wire_cuda.wire_unpack_mask = saved


def abs_err(a, b):
    """Largest |a - b| (equal NaNs 0; a NaN against a number inf)."""
    a, b = a.double(), b.double()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, (a - b).abs())
    return float(d.nan_to_num(nan=float("inf")).max()) if d.numel() else 0.0


def k9_against_plain(mesh, B, L=L_MAIN):
    """K9 against its plain twin on the same device tensors at (B, L):
    every channel of an atmosphere (coded schema; auto with uniform and
    zero channels) and of the cloud profiles, float32 and float64, plain
    and sanitized, and the sanitized atmosphere on each corruption of
    ``ATM_CORRUPT``: logratio within TOL_WIRE_ULP, the other codecs and
    every ok flag bitwise; the mask unpack bitwise.  -> (the largest
    distance from the plain twin in ulps, the largest |difference|)."""
    from rrtmg_lw_torch.parallel import shard_batch, wire as w
    from rrtmg_lw_torch.utils.synthetic import (make_atmosphere,
                                                make_cloud_profile_fields,
                                                make_mcica_clouds)
    atm = make_atmosphere(B, L, seed=B, dtype=np.float32)
    cp = make_cloud_profile_fields(B, L, seed=L)
    coded = w.encode_atmosphere(atm, schema="coded")
    auto = w.encode_atmosphere(atm._replace(covmr=np.zeros_like(atm.covmr)))
    need(any(isinstance(r, dict) for r in auto.refs.values())
         and any(r is None for r in auto.refs.values()),
         "k9: the auto-schema batch has no uniform or no zero channel")
    taua = torch.zeros((B, L, 16), device=mesh.device)
    worst, worst_abs = 0.0, 0.0
    cases = [("coded", coded, False), ("auto", auto, False),
             ("coded", coded, True), ("auto", auto, True)] + [
        (c, corrupt(auto if c == "nan_uniform" else coded, c), True)
        for c in ATM_CORRUPT]
    for (tag, enc, san), dt in itertools.product(
            cases, (torch.float32, torch.float64)):
        ea = shard_batch(enc, mesh)
        got = w.decode_atmosphere(ea, taua, dt, sanitize=san)
        with plain_decode():
            ref = w.decode_atmosphere(ea, taua, dt, sanitize=san)
        if san:
            (got, ok), (ref, rok) = got, ref
            need(torch.equal(ok, rok), f"k9 {tag} B={B} {dt}: ok differs")
            need(tag in ("coded", "auto") or not ok.all(),
                 f"k9 {tag} B={B}: the corruption left every column ok")
        for name, kind in w.ATM_FIELDS.items():
            a, b = getattr(got, name), getattr(ref, name)
            need(a.is_contiguous() and a.shape == b.shape,
                 f"k9 {name}: not contiguous or mis-shaped")
            worst_abs = max(worst_abs, abs_err(a, b))
            if kind == "logratio" and enc.refs[name] is not None \
                    and not isinstance(enc.refs[name], dict):
                u = ulps(a, b)
                worst = max(worst, u)
                need(u <= TOL_WIRE_ULP, f"k9 {tag} B={B} {dt} {name}: "
                     f"{u} ulps from the plain twin")
            else:
                need(torch.equal(a.nan_to_num(), b.nan_to_num())
                     and torch.equal(a.isnan(), b.isnan()),
                     f"k9 {tag} B={B} {dt} {name}: not bitwise the plain "
                     "twin")
    for dt, san in itertools.product((torch.float32, torch.float64),
                                     (False, True)):
        ec = shard_batch(w.encode_cloud_profiles(cp, schema="coded"), mesh)
        got = w.decode_cloud_profiles(ec, dt, sanitize=san)
        with plain_decode():
            ref = w.decode_cloud_profiles(ec, dt, sanitize=san)
        if san:
            (got, ok), (ref, rok) = got, ref
            need(torch.equal(ok, rok), f"k9 clouds B={B}: ok differs")
        for name in got:
            u = ulps(got[name], ref[name])
            worst = max(worst, u)
            worst_abs = max(worst_abs, abs_err(got[name], ref[name]))
            need(u == 0 or (w.CLOUD_FIELDS[name] == "logratio"
                            and u <= TOL_WIRE_ULP),
                 f"k9 clouds B={B} {dt} {name}: {u} ulps")
    cw = shard_batch(w.encode_compact_clouds(make_mcica_clouds(
        B, L, seed=4, dtype=np.float32, mask_dtype=np.int8)), mesh)
    got = w.decode_compact_clouds(cw)
    with plain_decode():
        ref = w.decode_compact_clouds(cw)
    need(torch.equal(got.cldfmc, ref.cldfmc)
         and all(ulps(a, b) <= TOL_WIRE_ULP for a, b in zip(got[1:], ref[1:])),
         f"k9 unpack B={B}: the mask or fields differ from the plain twin")
    for a, b in zip(got[1:], ref[1:]):
        worst = max(worst, ulps(a, b))
        worst_abs = max(worst_abs, abs_err(a, b))
    return worst, worst_abs


def k9_build_info(log_path):
    """Registers and spill stores of K9's instantiations (output type,
    sanitize) and of its unpack, from the build log."""
    from rrtmg_lw_torch import _build
    info = _build.ptxas_info(
        log_path, r"wire_decode_kernelI(f|d)Lb([01])E",
        lambda m: f"decode {'f32' if m.group(1) == 'f' else 'f64'}"
                  f"{' sanitize' if m.group(2) == '1' else ''}")
    info.update(_build.ptxas_info(log_path, r"wire_unpack_kernel",
                                  lambda m: "unpack"))
    return info


def k9_times(mesh):
    """K9 at the main path's shape (B=16384, L=60): the sanitized decode
    of the coded atmosphere (the streamed step's), of the cloud profiles,
    and the mask unpack: wrapper ms, device ms, plain twin ms, the bound."""
    from rrtmg_lw_torch.parallel import shard_batch, wire as w
    from rrtmg_lw_torch.ops.wire_cuda import wire_unpack_mask
    from rrtmg_lw_torch.utils.synthetic import (make_atmosphere,
                                                make_cloud_profile_fields,
                                                make_mcica_clouds)
    atm = make_atmosphere(B_MAIN, L_MAIN, seed=0, dtype=np.float32)
    ea = shard_batch(w.encode_atmosphere(atm, schema="coded"), mesh)
    ec = shard_batch(w.encode_cloud_profiles(
        make_cloud_profile_fields(B_MAIN, L_MAIN, 0), schema="coded"), mesh)
    bits = shard_batch(w.encode_compact_clouds(make_mcica_clouds(
        B_MAIN, L_MAIN, seed=2, dtype=np.float32,
        mask_dtype=np.int8)), mesh).mask_bits
    taua = torch.zeros((B_MAIN, L_MAIN, 16), device=mesh.device)

    def atm_dec():
        return w.decode_atmosphere(ea, taua, sanitize=True)

    def cloud_dec():
        return w.decode_cloud_profiles(ec, like=taua[..., 0], sanitize=True)

    def plain(fn):
        def run():
            with plain_decode():
                return fn()
        return run
    a, ok = atm_dec()
    codes = [t for t in ea.cols.values()]
    outs = [getattr(a, n) for n in w.ATM_FIELDS] + [ok]
    n_atm = sum(t.numel() for t in codes)
    c, ok_c = cloud_dec()
    mask = wire_unpack_mask(bits)
    out = dict(
        codes=n_atm, ms=cuda_ms(atm_dec, 20),
        device_ms=device_ms(atm_dec, symbol="wire_decode_kernel"),
        plain_ms=cuda_ms(plain(atm_dec), 5),
        ms_unsanitized=cuda_ms(lambda: w.decode_atmosphere(ea, taua), 20),
        library_note="none: one PyTorch call does not decode a channel set",
        **bound(codes, outs, WIRE_OPS * n_atm))
    cb = bound(list(ec.cols.values()), [*c.values(), ok_c],
               WIRE_OPS * sum(t.numel() for t in ec.cols.values()))
    ub = bound((bits,), (mask,), 8 * bits.numel())
    out.update(
        cloud_ms=cuda_ms(cloud_dec, 20),
        cloud_device_ms=device_ms(cloud_dec, symbol="wire_decode_kernel"),
        cloud_plain_ms=cuda_ms(plain(cloud_dec), 5),
        cloud_bound_ms=cb["bound_ms"],
        unpack_ms=cuda_ms(lambda: wire_unpack_mask(bits), 20),
        unpack_device_ms=device_ms(lambda: wire_unpack_mask(bits),
                                   symbol="wire_unpack_kernel"),
        unpack_plain_ms=cuda_ms(lambda: w.unpack_mask(bits), 5),
        unpack_bound_ms=ub["bound_ms"])
    for k in ("", "cloud_", "unpack_"):
        nbytes = (out["bytes_once"] if not k else
                  (cb if k == "cloud_" else ub)["bytes_once"])
        out[f"{k}gbps"] = nbytes / (out[f"{k}device_ms"] * 1e-3) / 1e9
    return out


def phase_parallel(device, counters):
    """The parallel layer on a one-rank NCCL process group (a TCP store on
    a free port), destroyed at the end, also on failure.  (a) Entry point
    1 (``examples/gcm_step``): ``make_sharded_step`` over ``run_epoch`` on
    STEPS host batches at B=16384, counted on every counter, its last
    fluxes bitwise ``model(atm, clouds)`` on the same batch;
    ``make_metrics_fn`` against torch reductions of the same fluxes;
    ``make_sharded_grad_step`` against ``make_grad_step`` at B=4096
    (deterministic algorithms; at one rank the gather is the identity:
    this checks its plumbing on NCCL, not the world-size factor).  (b) K9
    against its plain twin (``k9_against_plain``) at B=16384 and 2051;
    the C++ encoder required, its codes bitwise the numpy encoder's.
    (c) Entry point 2 (``examples/wire_streaming``): STEPS streamed steps
    counted, within TOL_FLUX of the same step through the plain decode; a
    sanitized step on a batch whose play codes are zero in every seventh
    column: finite fluxes, ``wire_ok`` False in exactly those columns.
    (d) The ``gcm_step`` and ``wire_stream`` cells profiled.  -> (K9's
    summary entry, its launches on the main path, e2e rows)."""
    import os
    import torch.distributed as dist
    from rrtmg_lw_torch import Atmosphere, _build, make_model, native
    from rrtmg_lw_torch import parallel as par
    from rrtmg_lw_torch.examples import gcm_step, wire_streaming
    from rrtmg_lw_torch.parallel import wire as w
    from rrtmg_lw_torch.utils import profiling
    from rrtmg_lw_torch.utils.synthetic import make_atmosphere
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = par.make_mesh()
        one = torch.ones(1, device=mesh.device)
        dist.all_reduce(one, group=mesh.group)
        need(mesh.world == 1 and mesh.group is not None
             and mesh.device == device and float(one) == 1.0,
             f"nccl: a one-rank mesh {mesh}")
        # (a) entry point 1
        model, step = gcm_step.build(mesh)
        batches = list(gcm_step.host_batches(B_MAIN, L_MAIN, STEPS))
        step(*par.shard_batch(batches[0], mesh))          # warm-up
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        out = par.run_epoch(step, iter(batches), mesh, depth=2)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        per_step = dict(FWD, rt_sweep=1)
        want = {k: per_step.get(k, 0) * STEPS for k in counters}
        need(counts == want, f"gcm_step: launches {counts}, expected {want}")
        ref = model(*par.shard_batch(batches[-1], mesh))
        names = ("uflx", "dflx", "hr", "uflxc", "dflxc", "hrc")
        need(all(torch.equal(getattr(out, n), getattr(ref, n))
                 for n in names) and torch.isfinite(out.uflx).all(),
             "gcm_step: the sharded stream's fluxes differ from the model's "
             "on the same batch")
        m = par.make_metrics_fn(mesh, with_reference=True)(out, ref)
        olr = out.uflx[:, -1]
        direct = dict(ncol=float(B_MAIN), olr_mean=float(olr.sum() / B_MAIN),
                      olr_min=float(olr.min()), olr_max=float(olr.max()),
                      hr_min=float(out.hr.min()), hr_max=float(out.hr.max()),
                      uflx_maxabs=0.0, uflx_rms=0.0)
        need(all(float(m[k]) == v for k, v in direct.items())
             and abs(float(m["olr_mean"]) - float(olr.mean()))
             <= 1e-6 * float(olr.mean()),
             f"metrics: {({k: float(m[k]) for k in direct})} against torch "
             f"reductions {direct}")
        print(f"gcm_step: {STEPS} batches of {B_MAIN} through "
              f"make_sharded_step / run_epoch on a one-rank NCCL mesh, "
              f"launches {counts}; the fluxes bitwise the model's on the "
              f"same batch; metrics equal torch reductions (OLR mean "
              f"{float(m['olr_mean']):.4f} W/m2)")
        del out, ref, batches
        atm, clouds = next(gcm_step.host_batches(B_GRAD_PAR, L_MAIN, 1))
        atm, clouds = par.shard_batch((atm, clouds), mesh)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            ls, gs = par.make_sharded_grad_step(model, mesh)(atm, clouds)
            l1, g1 = par.make_grad_step(model)(atm, clouds)
        finally:
            torch.use_deterministic_algorithms(False)
        gerr = max(float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)) for a, b in zip(gs, g1))
        lerr = float((ls - l1).abs() / l1.abs())
        need(lerr <= TOL_GRAD_PAR and gerr <= TOL_GRAD_PAR,
             f"make_sharded_grad_step: loss {float(ls)} vs {float(l1)}, "
             f"gradients {gerr:.3g} of max |grad|")
        print(f"make_sharded_grad_step at B={B_GRAD_PAR}: loss within "
              f"{lerr:.3g} (the gathered fluxes are summed in another "
              f"order), gradients within {gerr:.3g} of make_grad_step's per "
              f"field ({len(Atmosphere._fields)} fields)")
        del model, step, atm, clouds, gs, g1
        torch.cuda.empty_cache()

        # (b) K9 against its plain twin; the C++ encoder
        errs = [k9_against_plain(mesh, B) for B in B_WIRE_CHECK]
        worst, worst_abs = (max(e) for e in zip(*errs))
        print(f"k9: bitwise the plain twin at B={B_WIRE_CHECK} (logratio "
              f"within {worst:.0f} ulps, largest |difference| "
              f"{worst_abs:.3g}), float32 and float64, plain and "
              f"sanitized, on {len(ATM_CORRUPT)} corruptions (ok flags "
              "bitwise); the mask unpack bitwise")
        need(native.wire_native_available(),
             "the C++ wire encoder did not build (native/wirecodec.cc)")
        hb = make_atmosphere(B_MAIN, L_MAIN, seed=3, dtype=np.float32)
        nat = w.encode_atmosphere(hb, schema="coded")
        os.environ["RRTMG_WIRE_NATIVE"] = "0"
        try:
            ref_enc = w.encode_atmosphere(hb, schema="coded")
        finally:
            del os.environ["RRTMG_WIRE_NATIVE"]
        need(all(np.array_equal(nat.cols[k], ref_enc.cols[k])
                 and all(np.array_equal(np.asarray(a), np.asarray(b))
                         for a, b in zip(nat.refs[k], ref_enc.refs[k]))
                 for k in nat.cols),
             "the C++ wire encoder's codes differ from the numpy encoder's")
        print("wire encoder: C++ (native/wirecodec.cc) built, its codes and "
              f"refs bitwise the numpy encoder's at B={B_MAIN}")

        # (c) entry point 2
        model = make_model(wire_streaming.CONFIG, device=mesh.device)
        step = wire_streaming.make_step(model, mesh, B_MAIN, L_MAIN)
        host = list(wire_streaming.host_batches(B_MAIN, L_MAIN, STEPS + 1))
        step(*par.shard_batch(host[0], mesh))             # warm-up
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        for b in par.prefetch(iter(host[1:]), mesh, depth=2):
            fl = step(*b)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        per_step = dict(FWD, rt_sweep=1, mcica=1, wire_decode=2)
        want = {k: per_step.get(k, 0) * STEPS for k in counters}
        need(counts == want, f"wire_stream: launches {counts}, expected "
             f"{want}")
        need(bool(fl.wire_ok.all()) and torch.isfinite(fl.uflx).all(),
             "wire_stream: a clean batch flagged, or non-finite fluxes")
        launches = counts["wire_decode"]
        dev_batch = par.shard_batch(host[-1], mesh)
        fk = wire_streaming.make_step(model, mesh, B_MAIN, L_MAIN)(*dev_batch)
        with plain_decode():
            fp = wire_streaming.make_step(model, mesh, B_MAIN,
                                          L_MAIN)(*dev_batch)
        err = max(flux_err(getattr(fk, n).t(), getattr(fp, n).t())
                  for n in ("uflx", "dflx", "uflxc", "dflxc"))
        need(err <= TOL_FLUX, f"wire_stream: K9's step against the plain "
             f"decode's {err:.3g}")
        bad = torch.zeros(B_MAIN, dtype=torch.bool)
        bad[::7] = True
        ea = corrupt(host[-1][0], "zero_codes", bad.numpy())
        fc = wire_streaming.make_step(model, mesh, B_MAIN, L_MAIN)(
            *par.shard_batch((ea, host[-1][1]), mesh))
        need(torch.equal(fc.wire_ok.cpu(), ~bad)
             and all(torch.isfinite(getattr(fc, n)).all() for n in names),
             "wire_stream: the sanitized step on zeroed play codes: wire_ok "
             "not False in exactly those columns, or non-finite fluxes")
        print(f"wire_stream: {STEPS} streamed steps, launches {counts}; "
              f"against the plain decode's step {err:.3g}; a batch with "
              f"play's codes zero in {int(bad.sum())} columns: finite "
              "fluxes, wire_ok False in exactly those")
        del model, step, host, dev_batch, fk, fp, fc
        torch.cuda.empty_cache()
        res = k9_times(mesh)
        torch.cuda.empty_cache()
        # (d) the stream cells
        rows = []
        for cell in ("gcm_step", "wire_stream"):
            rows.append(profiling.profile_cell(cell, device))
            r = rows[-1]
            print(f"{cell}: wall {r['wall_ms']:.1f} ms a batch (depth 0 "
                  f"{r['wall_ms_depth0']:.1f}: prefetch gain "
                  f"{r['prefetch_gain']:.3f}), host batch "
                  f"{r['host_batch_ms']:.1f} ms, busy {r['busy_ms']:.2f} ms, "
                  f"idle {r['idle_share']:.3f}, {r['launches_per_step']:.1f} "
                  f"launches ({r['copies_per_step']:.1f} copies) a step, "
                  f"{r['bytes_per_col']:.0f} B a column, peak "
                  f"{r['peak_gib']:.2f} GiB, kernels {r['kernel_ms']}")
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    path, _ = _build.build()
    info = k9_build_info(path.parent / "build.log")
    need(len(info) == 5 and all(r.get("spill_bytes", 0) == 0
                                for r in info.values()),
         f"K9: {len(info)} instantiations in the build log, or a spill: "
         f"{info}")
    res.update(max_abs_err=worst_abs, max_ulps=worst,
               registers=info["decode f32 sanitize"]["registers"],
               spill_bytes=0, instantiations=info, launches_per_step=2)
    print(f"wire_decode (K9, sanitized atmosphere, {res['codes']} codes): "
          f"wrapper {res['ms']:.4f} ms (unsanitized "
          f"{res['ms_unsanitized']:.4f}), device {res['device_ms']:.4f} ms "
          f"({res['gbps']:.0f} GB/s), bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}), plain {res['plain_ms']:.3f} ms; clouds "
          f"{res['cloud_ms']:.4f} / {res['cloud_device_ms']:.4f} / bound "
          f"{res['cloud_bound_ms']:.4f} / plain {res['cloud_plain_ms']:.3f}; "
          f"unpack {res['unpack_ms']:.4f} / {res['unpack_device_ms']:.4f} / "
          f"bound {res['unpack_bound_ms']:.4f} / plain "
          f"{res['unpack_plain_ms']:.3f}; against the plain twin "
          f"{res['max_ulps']:.0f} ulps, |difference| "
          f"{res['max_abs_err']:.3g}; registers "
          f"{ {k: v['registers'] for k, v in info.items()} }, no spills; "
          f"phase {time.perf_counter() - t0:.1f} s")
    return res, launches, rows


# the sensitivities pass's launches (clear, idrv=1, the gradient with
# respect to tlay, h2ovmr and tsfc): K3b only on the layer temperatures
SENS_LAUNCHES = dict(taumol=1, planck=2, rt_sweep=1, rt_sweep_idrv=1,
                     rt_sweep_save=1, rt_adjoint=1, taumol_bwd=1,
                     planck_bwd=1)
SENS_FIELDS = ("kernel_T", "kernel_q", "d_tsfc", "duflx_dt_toa")
METER_STEPS = 10


def phase_verify(device, counters):
    """2f: the verification tool, the sensitivities entry point, device
    time and the meters (see the module docstring).  -> e2e rows."""
    from rrtmg_lw_torch import Atmosphere, make_model
    from rrtmg_lw_torch.examples import sensitivities as sens
    from rrtmg_lw_torch.tools import gpu_verify
    from rrtmg_lw_torch.utils import profiling
    from rrtmg_lw_torch.utils.device_time import device_seconds_per_iter
    from rrtmg_lw_torch.utils.profiling import (ThroughputMeter,
                                                device_memory_stats)
    from rrtmg_lw_torch.utils.synthetic import make_atmosphere
    t0 = time.perf_counter()
    # (a) the verification tool at its defaults
    out = gpu_verify.verify(device)
    bad = [c["check"] for c in out["checks"] if not c["ok"]]
    need(out["all_ok"] and not bad and len(out["checks"]) ==
         len(gpu_verify.TOLS), f"gpu_verify: failing checks {bad}")
    print(f"gpu_verify: {len(out['checks'])} checks pass at B="
          f"{out['batch']} on {out['device']} ({out['nvidia_smi']}) in "
          f"{out['elapsed_s']} s", flush=True)
    torch.cuda.empty_cache()

    # (b) the sensitivities entry point against eager
    cfg = sens.CONFIG.replace(dtype="float32")
    atm = Atmosphere.from_numpy(make_atmosphere(B_MAIN, L_MAIN,
                                                dtype=np.float32),
                                device, torch.float32)
    kern = make_model(cfg.replace(impl="cuda"), device=device)
    sens.sensitivities(kern, atm)                       # warm-up
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    sk = sens.sensitivities(kern, atm)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {k: SENS_LAUNCHES.get(k, 0) for k in counters}
    need(counts == want, f"sensitivities: launches {counts}, expected "
         f"{want}")
    eager = make_model(cfg.replace(impl="eager"), device=device)
    parts = [sens.sensitivities(eager, columns(atm, None, slice(
        i, i + B_CHUNK))[0]) for i in range(0, B_MAIN, B_CHUNK)]
    errs = {}
    for k in SENS_FIELDS:
        e = torch.cat([p[k] for p in parts])
        errs[k] = float((sk[k] - e).abs().max() / e.abs().max())
    olr_e = float(sum(float(p["olr"]) for p in parts) / len(parts))
    need(all(torch.isfinite(sk[k]).all() for k in SENS_FIELDS)
         and max(errs.values()) <= TOL_STEP
         and abs(float(sk["olr"]) - olr_e) <= TOL_FLUX * olr_e,
         f"sensitivities against eager: {errs}, OLR {float(sk['olr'])} "
         f"vs {olr_e}")
    d_tsfc, ddt = sk["d_tsfc"], sk["duflx_dt_toa"]
    print(f"sensitivities (B={B_MAIN}, L={L_MAIN}): launches {counts}; "
          f"against eager (of max |eager|) {errs}; OLR mean "
          f"{float(sk['olr']):.3f} W/m2; dOLR/dTsfc adjoint "
          f"{float(d_tsfc.mean()):+.5f}, idrv-path {float(ddt.mean()):+.5f} "
          f"(max |diff| {float((d_tsfc - ddt).abs().max()):.2e})")
    del parts, eager
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        sens.sensitivities(kern, atm)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    sec, detail = device_seconds_per_iter(
        lambda: sens.sensitivities(kern, atm))
    mem = device_memory_stats(device)
    row = dict(cell="sensitivities", ncol=B_MAIN, nlay=L_MAIN,
               wall_ms_median=float(np.median(walls)), busy_ms=sec * 1e3,
               cols_per_sec=B_MAIN / (np.median(walls) * 1e-3),
               launches_per_step=detail["launches_per_iter"],
               kernel_ms=detail["kernel_ms"], glue_ops=detail["glue_ops"],
               peak_gib=mem["peak_bytes_in_use"] / 2 ** 30, rel_err=errs)
    print(f"sensitivities step: wall {row['wall_ms_median']:.2f} ms "
          f"(median of 5), device busy {row['busy_ms']:.2f} ms, "
          f"{row['launches_per_step']:.0f} launches, peak "
          f"{row['peak_gib']:.2f} GiB, kernels {detail['kernel_ms']}")
    del kern, atm, sk
    torch.cuda.empty_cache()

    # (c) device time of the mcica_cloudy step beside profile_cell's busy
    model = profiling.CELLS["mcica_cloudy"].make_model(device)
    atm, clouds = inputs("mcica_cloudy", device)
    model(atm, clouds)
    torch.cuda.synchronize()
    sec, detail = device_seconds_per_iter(lambda: model(atm, clouds))
    need(sec is not None and sec > 0, f"device_seconds_per_iter: {sec}, "
         f"{detail}")
    prof_row = profiling.profile_cell("mcica_cloudy", device)
    print(f"device_seconds_per_iter (mcica_cloudy): {sec * 1e3:.3f} ms a "
          f"step ({detail['launches_per_iter']:.1f} launches), "
          f"profile_cell's busy {prof_row['busy_ms']:.3f} ms, glue "
          f"{prof_row['glue_ms']:.3f} ms; largest glue ops "
          f"{detail['glue_ops']}")

    # (d) the meters
    meter = ThroughputMeter()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(METER_STEPS):
        with meter.step(ncols=B_MAIN) as h:
            h["result"] = model(atm, clouds)
    mem = device_memory_stats(device)
    rep = meter.report()
    need(rep["steps"] == METER_STEPS and rep["columns"] == METER_STEPS
         * B_MAIN and rep["columns_per_sec"] > 0
         and mem["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
         and 0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"]
         < mem["bytes_limit"], f"meters: {rep}, {mem}")
    print(f"ThroughputMeter (mcica_cloudy, {METER_STEPS} steps): {rep}; "
          f"device_memory_stats {mem}; phase {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    del model, atm, clouds
    torch.cuda.empty_cache()
    return [row, prof_row]


def launch_counters():
    """(counters, fwd_counters): the launch counters (the wrappers, whose
    ``launches`` each counts) of K2, K3, K4 and K1 clear / compact, and
    of every kernel a step can launch."""
    from rrtmg_lw_torch.ops.cldcoef_cuda import (ice_liq_coeffs_blocked,
                                                 ice_liq_coeffs_vjp)
    from rrtmg_lw_torch.ops.planck_cuda import (planck_interp_blocked,
                                                planck_interp_vjp)
    from rrtmg_lw_torch.ops.rtrn_cuda import (DDT_LAUNCHES,
                                              rt_fluxes_banded,
                                              rt_fluxes_blocked,
                                              rt_fluxes_cldf_od,
                                              rt_fluxes_fused,
                                              rt_fluxes_maxrand,
                                              rt_sweep_banded_vjp,
                                              rt_sweep_g_vjp,
                                              rt_sweep_maxrand_vjp,
                                              rt_sweep_vjp)
    from rrtmg_lw_torch.ops.mcica_cuda import subcol_mask
    from rrtmg_lw_torch.ops.rtrnmr_cuda import overlap_rows, overlap_rows_vjp
    from rrtmg_lw_torch.ops.wire_cuda import wire_decode, wire_unpack_mask
    from rrtmg_lw_torch.ops.taumol_cuda import taumol_blocked, taumol_vjp
    counters = {"taumol": taumol_blocked, "planck": planck_interp_blocked,
                "cldcoef": ice_liq_coeffs_blocked,
                "rt_sweep": rt_fluxes_blocked}
    # the backward kernels and K1's launches that keep the radiances: 0 in
    # every forward cell
    bwd_counters = dict(rt_sweep_save=rt_fluxes_blocked.save,
                        rt_sweep_save_maxrand=rt_fluxes_maxrand.save,
                        rt_sweep_save_banded=rt_fluxes_banded.save,
                        rt_sweep_save_fused=rt_fluxes_fused.save,
                        rt_sweep_save_cldf_od=rt_fluxes_cldf_od.save,
                        overlap_bwd=overlap_rows_vjp,
                        rt_adjoint_maxrand=rt_sweep_maxrand_vjp,
                        rt_adjoint_banded=rt_sweep_banded_vjp,
                        rt_adjoint_fused=rt_sweep_g_vjp.fused,
                        rt_adjoint_cldf_od=rt_sweep_g_vjp.cldf_od,
                        cldcoef_bwd=ice_liq_coeffs_vjp,
                        taumol_bwd=taumol_vjp, planck_bwd=planck_interp_vjp,
                        rt_adjoint=rt_sweep_vjp,
                        **{f"rt_adjoint_ddt_{m}": DDT_LAUNCHES[m]
                           for m in DDT_MODES})
    fwd_counters = dict(counters, **bwd_counters,
                        rt_sweep_banded=rt_fluxes_banded,
                        rt_sweep_maxrand=rt_fluxes_maxrand,
                        overlap_rows=overlap_rows, mcica=subcol_mask,
                        wire_decode=wire_decode,
                        wire_unpack=wire_unpack_mask,
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
    return counters, fwd_counters


def main() -> int:
    # importing the port first: from a directory without it this fails
    # before anything is printed
    from rrtmg_lw_torch import _build
    from rrtmg_lw_torch.ops.planck_cuda import planck_interp_vjp
    from rrtmg_lw_torch.ops.rtrn_cuda import (k1_info, rt_fluxes_blocked,
                                              rt_sweep_vjp)
    from rrtmg_lw_torch.ops.taumol_cuda import taumol_vjp
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
    new_build = new_build_info(path.parent / "build.log")
    for key, r in new_build.items():
        print(f"{key}: {r['registers']} registers, {r['spill_bytes']} B "
              "spill stores" + (f", {r['smem_bytes']} B shared memory, "
                                f"{r['blocks_per_sm']} blocks per SM"
                                if "smem_bytes" in r else ""))
    ddt_build = ddt_build_info(path.parent / "build.log")
    for key, r in ddt_build.items():
        print(f"{key}: {r['registers']} registers, {r['spill_bytes']} B "
              f"spill stores, {r['local_bytes']} B local memory, "
              f"{r['smem_bytes']} B shared memory at L={L_MAIN} "
              f"({r['smem_bytes_deep']} B at L={L_DEEP}), "
              f"{r['blocks_per_sm']} blocks per SM ({r['blocks_per_sm_deep']} "
              f"at L={L_DEEP}), {r['threads']} threads of {r['columns']} "
              "columns")
    k5_build = k5_build_info(path.parent / "build.log")
    print(f"K5: {k5_build['registers']} registers, "
          f"{k5_build['spill_bytes']} B spill stores, "
          f"{k5_build['local_bytes']} B local memory, "
          f"{k5_build['smem_bytes']} B shared memory, "
          f"{k5_build['blocks_per_sm']} blocks per SM (launch bounds "
          f"{k5_build['min_blocks']})")

    counters, fwd_counters = launch_counters()

    # the configurations whose sweep is plain or whose cloud optics are
    # closed forms or the running ncbands, first: the device busy of its
    # steps comes from torch.profiler, whose traces lose launches in a
    # long process
    phase_configs(device, fwd_counters)
    torch.cuda.empty_cache()
    # 2c. K8 and the generate-then-radiate step; 2d. the column-mode CLI
    mcica_res, mcica_rows = phase_mcica(device, fwd_counters)
    torch.cuda.empty_cache()
    phase_cli(device)
    # 2e. the parallel layer: both entry points, K9
    torch.cuda.empty_cache()
    wire_res, wire_launches, wire_rows = phase_parallel(device, fwd_counters)
    torch.cuda.empty_cache()
    # 2f. the verification tool, the sensitivities entry point, device
    # time and the meters
    verify_rows = phase_verify(device, fwd_counters)
    torch.cuda.empty_cache()

    # 3. kernels vs plain versions; then K2 and K1 in reduced storage
    res = phase_kernels(device)
    res["mcica"] = mcica_res
    res["wire_decode"] = wire_res
    torch.cuda.empty_cache()
    res["rt_sweep"].update(k1_deep(device))
    torch.cuda.empty_cache()
    grad_dev = grad_device_times()
    torch.cuda.empty_cache()
    res.update(phase_storage_kernels(device))
    torch.cuda.empty_cache()

    # 4. end to end, each cell with its own launch counts: clear and
    # McICA, then the deterministic clouds
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
    launches["mcica"] = mcica_res.pop("launches")
    rows += mcica_rows
    launches["wire_decode"] = wire_launches
    rows += wire_rows + verify_rows

    # 5. deep
    rows += phase_deep(device, counters)
    torch.cuda.empty_cache()

    # 6. grad: backward kernels vs plain vjps, then the gradient step
    res.update(phase_grad_kernels(device))
    torch.cuda.empty_cache()
    res.update(ddt_grad_kernels(device))
    for name, ms in grad_dev.items():
        res[name].update(ms if isinstance(ms, dict) else dict(device_ms=ms))
    torch.cuda.empty_cache()
    save_paths = k1_save_cases(device)
    for name in ("rt_sweep_save", *(f"rt_sweep_save_{m}"
                                    for m in ("maxrand", *G_MODES))):
        mode = name.removeprefix("rt_sweep_save").lstrip("_") or "compact"
        res[name]["store_paths"] = {k.split(" ", 1)[1]: v for k, v
                                    in save_paths.items()
                                    if k.split()[0] == mode}
    torch.cuda.empty_cache()
    counters.update(taumol_bwd=taumol_vjp, planck_bwd=planck_interp_vjp,
                    rt_adjoint=rt_sweep_vjp,
                    rt_sweep_save=rt_fluxes_blocked.save)
    grad_launches, grad_rows = phase_grad_step(device, counters)
    rows += grad_rows
    # the maxrand gradient step, the banded gradient step
    # (band_cloudy_grad), the fused and cldf-odcld ones, then the d/dT
    # gradient steps (``*_ddt_grad``), each counted alone
    # on every counter
    cell_grad = {}
    for tag in GRAD_CELLS:
        cell_grad[tag], row = grad_cell(device, fwd_counters, tag)
        rows.append(row)
        torch.cuda.empty_cache()
    phase_grad_idrv(device)
    storage_grad_raises(device)
    torch.cuda.empty_cache()
    launches.update({k: grad_launches[k] for k in (
        "taumol_bwd", "planck_bwd", "rt_adjoint", "rt_sweep_save")})
    for tag, names in (
            ("maxrand_cloudy_grad", ("overlap_bwd", "rt_sweep_save_maxrand",
                                     "rt_adjoint_maxrand")),
            ("band_cloudy_grad", ("rt_sweep_save_banded",
                                  "rt_adjoint_banded", "cldcoef_bwd")),
            ("mcica_blocked_grad", ("rt_sweep_save_fused",
                                    "rt_adjoint_fused")),
            ("mcica_tauc_grad", ("rt_sweep_save_cldf_od",
                                 "rt_adjoint_cldf_od"))):
        launches.update({k: cell_grad[tag][k] for k in names})
    for counts in cell_grad.values():
        for k, n in counts.items():
            if k.startswith("rt_adjoint_ddt_") and n:
                launches.setdefault(k, n)

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
    for name in ("overlap_rows", "overlap_bwd", "rt_adjoint_maxrand",
                 *(f"rt_adjoint_{m}" for m in G_MODES), "cldcoef_bwd"):
        r = res[name]
        r.update(new_build[name],
                 gbps=r["bytes_once"] / (r["device_ms"] * 1e-3) / 1e9)
        print(f"{name}: device {r['device_ms']:.4f} ms, {r['gbps']:.0f} GB/s "
              f"of its bytes read once, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        if "bytes_moved" in r:
            r["gbps_moved"] = r["bytes_moved"] / (r["device_ms"] * 1e-3) / 1e9
            r["staging"] = k6g_staging(name.removeprefix("rt_adjoint_"))
            print(f"{name}: {r['gbps_moved']:.0f} GB/s of the "
                  f"{r['bytes_moved'] / 1e9:.2f} GB it moves; tile "
                  f"{r['columns']} columns x {r['threads'] // r['columns']} "
                  f"g-lanes ({r['threads']} threads), ring of "
                  f"{r['ring_slots']} slots, {r['smem_bytes']} B shared "
                  f"memory at L={L_MAIN} ({r['smem_bytes_deep']} B at "
                  f"L={L_DEEP}), {r['blocks_per_sm']} blocks per SM "
                  f"({r['blocks_per_sm_deep']} at L={L_DEEP}), "
                  f"{r['registers']} registers, {r['spill_bytes']} B "
                  f"spill stores; staging: {r['staging']}")
    for mode in DDT_MODES:
        name = f"rt_adjoint_ddt_{mode}"
        r = res[name]
        r.update(ddt_build[name],
                 gbps=r["bytes_once"] / (r["device_ms"] * 1e-3) / 1e9)
        print(f"{name}: device {r['device_ms']:.3f} ms "
              f"({r['device_ms_deep']:.3f} at L={L_DEEP}), {r['gbps']:.0f} "
              f"GB/s of its bytes read once, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}; its scratch {r['scratch_gb']:.2f} GB "
              f"besides), {r['registers']} registers, {r['spill_bytes']} B "
              f"spill stores, {r['smem_bytes']} B shared memory "
              f"({r['smem_bytes_deep']} at L={L_DEEP}), "
              f"{r['blocks_per_sm']} blocks per SM")
        # the d/dT step's pair: K1 SAVE at idrv=1 (in KEEPS_DDT keeping the
        # derivatives K6 reads) and K6 with the d/dT adjoint
        r.update(ddt_pair_ms=r["k1_save_idrv_ms"] + r["device_ms"],
                 ddt_pair_ms_deep=r["k1_save_idrv_ms_deep"]
                 + r["device_ms_deep"])
        k1 = k1_info(mode, 1, save="bulk")
        r.update(k1_save_idrv_registers=k1["registers"],
                 k1_save_idrv_blocks_per_sm=k1["blocks_per_sm"])
        print(f"ddt pair {mode}: K1 SAVE idrv=1 {r['k1_save_idrv_ms']:.3f} "
              f"ms ({k1['registers']} registers, {k1['local_bytes']} B "
              f"local memory, {k1['blocks_per_sm']} blocks per SM) + K6 "
              f"d/dT {r['device_ms']:.3f} ms = "
              f"{r['ddt_pair_ms']:.3f} ms (L={L_DEEP}: "
              f"{r['k1_save_idrv_ms_deep']:.3f} + "
              f"{r['device_ms_deep']:.3f} = {r['ddt_pair_ms_deep']:.3f}); "
              f"K6 {r['registers']} registers, {r['blocks_per_sm']} blocks "
              f"per SM ({r['blocks_per_sm_deep']} at L={L_DEEP})")
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
    r = res["mcica"]
    r["gbps"] = r["bytes_once"] / (r["device_ms"] * 1e-3) / 1e9
    print(f"mcica (K8): device {r['device_ms']:.4f} ms (icld 4 "
          f"{r['device_ms_icld4']:.4f}, L={L_DEEP} {r['device_ms_deep']:.4f}),"
          f" {r['gbps']:.0f} GB/s of its bytes, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); wrapper {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.2f} ms, torch.rand of its uniforms "
          f"{r['rand_ms']:.4f} ms")
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
