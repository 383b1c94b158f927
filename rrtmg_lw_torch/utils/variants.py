"""One kernel's source and variant copies of it against a parent
checkout's, on the card: bitwise equality and device times in turns.
The harness behind ``k5_variants`` and ``k6_variants``, which give it
their kernel (a ``Kernel``).

Each source (the parent's ``csrc/<source>``, this checkout's, and each
named variant, written under ``build/<module>/``) is built alone into a
small library with the package's flags (a variant may change them), one
nvcc each, all started together beside the builds of both checkouts'
packages, so a variant costs seconds.  Every entry function's ptxas line
(registers, spill stores) of the two package builds is compared.  On the
kernel's cases, every library's outputs, and the package wrapper's, are
held bitwise against the parent's (but the outputs the kernel names
loose, whose largest difference is printed) and against a second run of
their own; then each library is timed with CUDA events (mean of 5 launches
after one) on the kernel's first ``ntimed`` cases (two unless it says)
in turns, parent, this, variants, variants, this, parent.  A library
that exports the kernel's debug symbol (a ``prof`` variant: per-phase
clock sums) has its sums printed as shares.  Exits non-zero unless this
checkout's kernel is bitwise the parent's.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A kernel the harness holds against its parent."""
    module: str        # the variants module's name (its build directory)
    source: str        # the kernel's file under csrc/
    # name -> ([(old, new) replacements in the source], nvcc flags in
    # place of the package's -fmad=false, or None)
    variants: dict
    cases: Callable    # device -> [(tag, case)]
    run: Callable      # (library, case) -> [output tensors]
    package: Callable  # case -> [output tensors] of the package's wrapper
    info: Callable     # library -> its launch configuration, or None
    dbg: str = ""      # debug symbol (out, reset), in a prof variant
    phases: tuple = ()  # the debug symbol's clock sums, one row
    dbg_row: Callable = lambda tag: 0   # case tag -> row of the sums
    ntimed: int = 2    # the first cases, timed
    # (case tag, output index) -> may this output differ from the
    # parent's (a sum the design takes in another order): its largest
    # difference is printed instead
    loose: Callable = lambda tag, i: False


def event_ms(fn, n=5):
    """Mean CUDA-event ms of ``n`` calls of ``fn`` after one."""
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def lib_info(lib, entry, keys, *args):
    """``keys`` -> int from ``lib``'s launch-info entry point ``entry``,
    or None where the library has none (a parent's)."""
    if not hasattr(lib, entry):
        return None
    buf = (ctypes.c_int * len(keys))()
    if getattr(lib, entry)(*args, ctypes.cast(buf, ctypes.c_void_p)):
        raise RuntimeError(f"{entry} failed")
    return dict(zip(keys, buf))


def build_all(kernel, srcs, out_dir, parent):
    """({name: ctypes library} of each (source, include dir, flags), the
    parent package's build log or None): each source built alone, all
    at once, beside this package's build and the parent checkout's."""
    from rrtmg_lw_torch import _build
    th = threading.Thread(target=_build.build)
    th.start()
    pbuild = subprocess.Popen(
        [sys.executable, "-c", "from rrtmg_lw_torch import _build; "
         "print(_build.build()[0].parent / 'build.log')"], cwd=parent,
        env={**os.environ, "PYTHONPATH": str(parent)},
        stdout=subprocess.PIPE, text=True)
    jobs = {}
    for name, (src, inc, flags) in srcs.items():
        lib = out_dir / f"{name}.so"
        nv = [f for f in _build.NVCC_FLAGS
              if not (flags and f.startswith("-fmad="))] + list(flags or ())
        cmd = [_build.nvcc(), *nv, "-shared", "-I", str(inc), "-o", str(lib),
               str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        print(f"--- {name}: nvcc rc {proc.returncode}")
        for line in out.splitlines():
            if "Used" in line or "spill" in line or "error" in line:
                print("  " + line.strip())
        if proc.returncode:
            continue
        L = ctypes.CDLL(str(lib))
        for fn, argtypes in _build.SIGNATURES.items():
            if hasattr(L, fn):
                getattr(L, fn).argtypes = list(argtypes)
                getattr(L, fn).restype = ctypes.c_int
        if kernel.dbg and hasattr(L, kernel.dbg):
            getattr(L, kernel.dbg).argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = L
    th.join()
    plog = pbuild.communicate()[0].strip().splitlines()
    return libs, (pathlib.Path(plog[-1]) if pbuild.returncode == 0 else None)


def entry_lines(log):
    """{entry function: {"registers", "spill_bytes"}} of a package build
    log (``_build.ptxas_info``; anonymous namespaces, named after a hash
    of their file, under one name)."""
    from rrtmg_lw_torch import _build
    return _build.ptxas_info(log, r".+", lambda m: re.sub(
        r"__N__[0-9a-f]{8}", "__N__", m.group(0)))


def main(kernel, argv=None, doc=None) -> int:
    ap = argparse.ArgumentParser(description=(doc or __doc__).splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout holding the parent's rrtmg_lw_torch/")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(kernel.variants),
                    help="variants to build too")
    ap.add_argument("--out", help="write the times here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit(f"{kernel.module} needs a CUDA device")
    root = pathlib.Path(__file__).resolve().parents[2]
    csrc = root / "rrtmg_lw_torch" / "csrc"
    pcsrc = pathlib.Path(args.parent).resolve() / "rrtmg_lw_torch" / "csrc"
    srcs = {"parent": (pcsrc / kernel.source, pcsrc, None),
            "this": (csrc / kernel.source, csrc, None)}
    out_dir = root / "build" / kernel.module
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in args.variants:
        reps, flags = kernel.variants[name]
        text = (csrc / kernel.source).read_text()
        for old, new in reps:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name} no longer applies")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        srcs[name] = (out_dir / f"{name}.cu", csrc, flags)
    libs, plog = build_all(kernel, srcs, out_dir, args.parent)
    from rrtmg_lw_torch import _build
    a = entry_lines(plog) if plog else {}
    b = entry_lines(_build.build()[0].parent / "build.log")
    diff = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
    print(f"ptxas, parent's package against this: "
          f"{len(a.keys() | b.keys()) - len(diff)} entries equal; "
          "differing or in one build only:")
    for k in diff:
        print(f"  {k}: {a.get(k)} -> {b.get(k)}")
    for name, lib in libs.items():
        print("info", name, kernel.info(lib))
    dev = torch.device("cuda", 0)
    cs = kernel.cases(dev)
    ok = True
    def same(tag, got, ref):
        return all(torch.equal(g, r) for i, (g, r) in enumerate(zip(got, ref))
                   if not kernel.loose(tag, i))

    def max_rel(got, ref, idx):
        return max((float((got[i] - ref[i]).abs().max()
                          / ref[i].abs().max()) for i in idx), default=0.0)

    for tag, case in cs:
        ref = kernel.run(libs["parent"], case)
        loose = [i for i in range(len(ref)) if kernel.loose(tag, i)]
        res = {"package": same(tag, kernel.package(case), ref)}
        for name, lib in libs.items():
            got, again = (kernel.run(lib, case) for _ in range(2))
            res[name] = same(tag, got, ref)
            res[name + " rerun"] = all(torch.equal(g, h)
                                       for g, h in zip(got, again))
            if not res[name]:
                res[name + " max rel"] = max_rel(got, ref, range(len(ref)))
            if loose:
                res[name + " loose max rel"] = max_rel(got, ref, loose)
        ok &= res["package"] and res["this"]
        print(tag, json.dumps(res), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    names = list(libs)
    times = {}
    for tag, case in cs[:kernel.ntimed]:
        for name in names + names[::-1]:
            t = event_ms(lambda: kernel.run(libs[name], case))
            times.setdefault(tag, {}).setdefault(name, []).append(t)
        print(tag, "ms", json.dumps(times[tag]), flush=True)
    n = len(kernel.phases)
    for name, lib in libs.items():
        if not (kernel.dbg and hasattr(lib, kernel.dbg)):
            continue
        dbg = getattr(lib, kernel.dbg)
        buf = (ctypes.c_ulonglong * 64)()
        for tag, case in cs[:kernel.ntimed]:
            dbg(buf, 1)
            kernel.run(lib, case)
            torch.cuda.synchronize()
            dbg(buf, 0)
            r = kernel.dbg_row(tag)
            row = list(buf)[r * n:(r + 1) * n]
            print(name, tag, "clock shares", {
                p: round(x / sum(row), 4) for p, x in zip(kernel.phases,
                                                          row)})
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            dict(device=smi, times=times), indent=1))
    print(f"{kernel.module}:", "this kernel bitwise the parent's" if ok
          else "this kernel DIFFERS from the parent's")
    return 0 if ok else 1
