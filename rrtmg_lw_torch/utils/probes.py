"""Probes of the card's row-selection rates and launch latency.

    python -m rrtmg_lw_torch.utils.probes [--out probes.json]

The counterparts of the archived Pallas probes (``tools/archive/``),
which measured on the TPU whether a one-hot selection product beat a
row gather; these measure both on the H100 (``csrc/probes.cu``):

* ``onehot_select``: ``out (C, dout) = onehot(idx, R) @ tbl (R, D)[:,
  :dout]`` on the tensor cores (``mma.sync``, bf16 in, float32
  accumulate), the table as one bf16 plane (``nsplit=1``, the rows of
  ``test_mxu_rate.py``) or three (``nsplit=3``, hi + mid + lo: equal to
  ``tbl[idx]`` bit for bit, the check of ``calib.py:45``);
* ``gather_rows``: ``out (C, D) = tbl (R, D)[idx]``, a SIMT gather
  (``test_pallas_gather.py``), also on the one-hot's own rows (the (C,
  128) selection from the (65, 128) table), the comparison the archived
  probes were made for;
* launch latency: host time per iteration of n back-to-back one-hot
  launches, n = 1, 10, 100, 400, and of a chain whose next indices
  depend on the last output (``test_timing_sanity.py``,
  ``chained_timing.py``);
* the matmul rate of one 4096^3 product in float32 (TF32 off) and bf16,
  independent and chained (``calib.py``, ``chained_timing.py``): a plain
  large product, so ``torch.matmul``, the library call.

Each kernel's wrapper counts its launches in ``.launches``; on a CPU
tensor it runs its plain version (``onehot_plain``, ``gather_plain``).
``measure`` needs a CUDA device and prints nothing; ``main`` prints it
as JSON.  Shapes are the archived probes': C = 245760 (= 4096 x 60), R =
65, D = 1656, dout = 128; the gather table 1760 x 16.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from .. import _build

C_PROBE, R_PROBE, D_PROBE, DOUT_PROBE = 245760, 65, 1656, 128
R_GATHER, D_GATHER = 1760, 16
KMAX = 128                      # largest R of the one-hot kernel
MATMUL_N = 4096
LATENCY_NS = (1, 10, 100, 400)


def bf16_split(tbl: torch.Tensor, nsplit: int) -> list:
    """float32 ``tbl`` -> ``nsplit`` bf16 planes hi, mid, lo (the first
    ``nsplit``), each the round-to-nearest bf16 of what the earlier ones
    leave; (lo + mid) + hi is ``tbl`` exactly for nsplit = 3."""
    planes, rest = [], tbl
    for _ in range(nsplit):
        p = rest.to(torch.bfloat16)
        planes.append(p)
        rest = rest - p.float()
    return planes


def onehot_plain(idx, tbl, dout, nsplit):
    """The plain version of ``onehot_select``: the one-hot matrix times
    each plane, summed from the last plane to the first in float32."""
    onehot = torch.nn.functional.one_hot(idx.long(), tbl.shape[0]).float()
    acc = torch.zeros((idx.shape[0], dout), dtype=torch.float32,
                      device=tbl.device)
    for plane in reversed(bf16_split(tbl[:, :dout], nsplit)):
        acc = acc + onehot @ plane.float()
    return acc


def onehot_select(idx, tbl, dout=None, nsplit=3):
    """idx (C,) int32 in [0, R); tbl (R, D) float32, R <= 128 -> (C,
    dout) float32, the rows ``idx`` of ``tbl[:, :dout]`` selected by a
    one-hot product (nsplit 1: of bf16(tbl); 3: exact)."""
    dout = tbl.shape[1] if dout is None else dout
    if nsplit not in (1, 3):
        raise ValueError(f"nsplit must be 1 or 3, got {nsplit}")
    if idx.device.type == "cpu":
        return onehot_plain(idx, tbl, dout, nsplit)
    C, (R, D) = idx.shape[0], tbl.shape
    if not 1 <= R <= KMAX or not 1 <= dout <= D:
        raise ValueError(f"table rows {R} (1..{KMAX}), dout {dout} (1..{D})")
    _build.check(idx, "idx", torch.int32, (C,), tbl.device)
    _build.check(tbl, "tbl", torch.float32, (R, D), tbl.device)
    out = torch.empty((C, dout), dtype=torch.float32, device=tbl.device)
    _build.launch("rrtm_probe_onehot", idx, tbl, out, C, R, D, dout, nsplit)
    onehot_select.launches += 1
    return out


def gather_plain(idx, tbl):
    """The plain version of ``gather_rows``: ``tbl[idx]``."""
    return tbl[idx.long()]


def gather_rows(idx, tbl):
    """idx (C,) int32 in [0, R); tbl (R, D) float32 -> tbl[idx] (C, D)."""
    if idx.device.type == "cpu":
        return gather_plain(idx, tbl)
    C, (R, D) = idx.shape[0], tbl.shape
    _build.check(idx, "idx", torch.int32, (C,), tbl.device)
    _build.check(tbl, "tbl", torch.float32, (R, D), tbl.device)
    out = torch.empty((C, D), dtype=torch.float32, device=tbl.device)
    _build.launch("rrtm_probe_gather", idx, tbl, out, C, R, D)
    gather_rows.launches += 1
    return out


onehot_select.launches = 0
gather_rows.launches = 0


def probe_inputs(device, C=C_PROBE, R=R_PROBE, D=D_PROBE, seed=0):
    """(idx (C,) int32, tbl (R, D) float32) as the archived probes make
    them: numpy's default_rng(seed) integers, then random()."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, R, C).astype(np.int32)
    tbl = rng.random((R, D)).astype(np.float32)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(tbl).to(device))


def _cuda_ms(fn, reps):
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


def _host_ms(fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def measure(device) -> dict:
    """Every probe on ``device`` (a CUDA device): the kernels' bitwise
    checks against ``tbl[idx]`` (raising on a mismatch), their CUDA-event
    ms beside the plain versions' and ``tbl[idx]``'s, the rates, the
    launch latencies and the matmul rates."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("the probes measure a CUDA device")
    res = {}
    idx, tbl = probe_inputs(device)
    idx_l = idx.long()
    want = {1: tbl.to(torch.bfloat16).float(), 3: tbl}
    for nsplit, dout in ((3, DOUT_PROBE), (1, DOUT_PROBE), (3, D_PROBE),
                         (1, D_PROBE)):
        tag = f"onehot_{'exact' if nsplit == 3 else 'bf16'}_{dout}"
        out = onehot_select(idx, tbl, dout, nsplit)
        ref = want[nsplit][:, :dout][idx_l]
        plain = onehot_plain(idx, tbl, dout, nsplit)
        nbad = int((out != ref).sum())
        if nbad or not torch.equal(plain, ref):
            raise RuntimeError(f"{tag}: {nbad} elements differ from "
                               f"tbl[idx]; plain equal: "
                               f"{torch.equal(plain, ref)}")
        ms = _cuda_ms(lambda: onehot_select(idx, tbl, dout, nsplit), 20)
        sliced = tbl[:, :dout]
        res[tag] = dict(
            ms=ms, plain_ms=_cuda_ms(
                lambda: onehot_plain(idx, tbl, dout, nsplit), 3),
            library_ms=_cuda_ms(lambda: sliced[idx_l], 20),
            # test_mxu_rate.py:47 counts the whole (C, R) x (R, D) product
            tflops_as_archived=C_PROBE * R_PROBE * D_PROBE * 2 / ms / 1e9,
            tflops_done=C_PROBE * ((R_PROBE + 15) // 16 * 16) * dout * 2
            * nsplit / ms / 1e9,
            gbps_written=C_PROBE * dout * 4 / ms / 1e6, bitwise=True)
    # the one-hot's own function, (C, 128) rows of the (65, 128) table,
    # as a gather: the comparison the archived probes were made for
    sliced = tbl[:, :DOUT_PROBE].contiguous()
    if not torch.equal(gather_rows(idx, sliced), sliced[idx_l]):
        raise RuntimeError("gather of the one-hot's rows: differs")
    ms = _cuda_ms(lambda: gather_rows(idx, sliced), 20)
    res[f"gather_onehot_{DOUT_PROBE}"] = dict(
        ms=ms, gbps_written=C_PROBE * DOUT_PROBE * 4 / ms / 1e6,
        bitwise=True)
    gidx, gtbl = probe_inputs(device, R=R_GATHER, D=D_GATHER)
    gidx_l = gidx.long()
    out = gather_rows(gidx, gtbl)
    if not torch.equal(out, gtbl[gidx_l]):
        raise RuntimeError("gather: differs from tbl[idx]")
    ms = _cuda_ms(lambda: gather_rows(gidx, gtbl), 50)
    res["gather"] = dict(
        ms=ms, plain_ms=_cuda_ms(lambda: gather_plain(gidx, gtbl), 50),
        library_ms=_cuda_ms(lambda: gtbl[gidx_l], 50),
        gbps_written=out.numel() * 4 / ms / 1e6,
        rows_per_s=C_PROBE / ms * 1e3, bitwise=True)

    res["latency_ms_per_iter"] = {
        n: _host_ms(lambda: onehot_select(idx, tbl, DOUT_PROBE, 1), n)
        for n in LATENCY_NS}
    state = {"idx": idx}

    def chain():
        out = onehot_select(state["idx"], tbl, DOUT_PROBE, 3)
        state["idx"] = ((state["idx"] + (out[:, 0] > 10.0).sum().to(
            torch.int32)) % R_PROBE).to(torch.int32)
    chain()
    res["chained_onehot_ms_per_iter"] = _host_ms(chain, 50)

    a32 = torch.ones((MATMUL_N, MATMUL_N), device=device)
    flop = 2 * MATMUL_N ** 3
    for name, a in (("f32", a32), ("bf16", a32.to(torch.bfloat16))):
        ms = _cuda_ms(lambda: torch.matmul(a, a), 50)
        b = a * 1e-3
        cur = {"x": b}

        def step():
            cur["x"] = torch.matmul(cur["x"], b) * 1e-3 + b
        step()
        ms_chain = _host_ms(step, 20)
        res[f"matmul_{name}"] = dict(ms=ms, tflops=flop / ms / 1e9,
                                     chained_ms=ms_chain,
                                     chained_tflops=flop / ms_chain / 1e9)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probes need a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = dict(device=torch.cuda.get_device_name(0),
               **measure(torch.device("cuda", 0)))
    print(json.dumps(res))
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()
