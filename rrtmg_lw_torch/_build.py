"""Builds the hand-written CUDA kernels and binds them with ctypes.

``csrc/*.cu`` compile with ``nvcc``, one process per source, all
started together, and link into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), at first
use, into ``build/rrtmg_lw_torch/<hash>/`` beside the package;
the hash covers the sources and the flags, so an edited kernel
rebuilds.  Every entry point takes raw device pointers and the CUDA
stream as ``c_void_p`` and returns ``cudaGetLastError()`` after its
launch; ``launch`` raises on a non-zero code.

Nothing here runs at import: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "rrtmg_lw_torch"
LIB_NAME = "librrtmg_lw_torch.so"

# -fmad=false: the taumol and cloud-coefficient kernels truncate computed
# floats to table indices; a contracted FMA could flip a bin against the
# plain PyTorch version, which rounds op by op.  No --use_fast_math: it
# changes expf and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")

P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "rrtm_planck": (P, P, P, I, I, P),
    "rrtm_planck_bwd": (P, P, P, P, I, I, P),
    "rrtm_cldcoef": (P, P, P, P, P, P, I, I, I, P),
    "rrtm_cldcoef_bwd": (P,) * 8 + (I, I, I, P),
    "rrtm_taumol": (P, P, P, P, P, P, P, I, I, I, P),
    "rrtm_taumol_info": (I, P),
    "rrtm_taumol_shape": (P,),
    "rrtm_taumol_bwd": (P, P, P, P, P, P, P, I, I, P),
    "rrtm_taumol_bwd_info": (P,),
    "rrtm_rt": (P,) * 19 + (I,) * 5 + (P, P, I, P, P),
    "rrtm_rt_info": (I, I, I, I, P),
    "rrtm_rt_save_path": (I,),
    "rrtm_overlap": (P, P, I, I, P),
    "rrtm_overlap_bwd": (P, P, P, I, I, P),
    "rrtm_rt_bwd_mr": (P,) * 21 + (I, I, I, P),
    "rrtm_rt_bwd_mr_scratch": (I, I, P),
    "rrtm_rt_bwd_mr_layout": (P,),
    "rrtm_rt_bwd_mr_info": (I, P),
    "rrtm_rt_bwd_mr_ddt": (P,) * 22 + (I, I, I, P),
    "rrtm_rt_bwd_mr_ddt_info": (I, P),
    "rrtm_rt_bwd_g": (P,) * 29 + (I, I, I, P),
    "rrtm_rt_bwd_g_scratch": (I, I, I, P),
    "rrtm_rt_bwd_g_layout": (I, I, P),
    "rrtm_rt_bwd_g_info": (I, I, P),
    "rrtm_rt_bwd_g_ddt": (P,) * 30 + (I, I, I, P),
    "rrtm_rt_bwd_g_ddt_info": (I, I, P),
    "rrtm_rt_bwd": (P,) * 21 + (I, I, I, P),
    "rrtm_rt_bwd_info": (I, P),
    "rrtm_rt_bwd_ddt": (P,) * 23 + (I, I, I, P),
    "rrtm_rt_bwd_ddt_info": (I, P),
    "rrtm_taumol_ndesc": (),
    "rrtm_probe_onehot": (P, P, P, I, I, I, I, I, P),
    "rrtm_probe_gather": (P, P, P, I, I, I, P),
    "rrtm_mcica": (P,) * 5 + (U, U) + (I,) * 6 + (P,),
    "rrtm_mcica_path": (),
    "rrtm_philox": (P, P, U, U, I, I, P),
    "rrtm_wire_decode": (P, I, I, I, P, P),
    "rrtm_wire_unpack": (P, P, I, I, I, P),
    "rrtm_wire_desc_size": (),
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([pathlib.Path(home) / "bin" / "nvcc"] if home else []) + \
            [pathlib.Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the rrtmg_lw_torch kernels")
    return found


def build() -> tuple[pathlib.Path, float]:
    """Compile csrc/ unless this hash is built; returns (library path,
    build seconds, 0.0 when it was already built)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    t0 = time.perf_counter()
    # one nvcc per source, all at once, then one link
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out[-4000:])
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        cmd = [nvcc(), "-shared", "-gencode", NVCC_FLAGS[1], "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr[-4000:])
    secs = time.perf_counter() - t0
    (out_dir / "build.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)                # atomic against a parallel build
    return lib, secs


def ptxas_info(log_path, symbol_re, key_fn):
    """Registers and spill stores of each instantiation of a kernel
    (ptxas -v in the build log) whose mangled name matches ``symbol_re``:
    {key_fn(the match): {"registers": n, "spill_bytes": n}}."""
    out, key = {}, None
    for line in pathlib.Path(log_path).read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([^' ]+)", line)
        if m:
            cur = re.search(symbol_re, m.group(1))
            key = key_fn(cur) if cur else None
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(key, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.rrtm_error_string.argtypes = [ctypes.c_int]
    lib.rrtm_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call entry point ``name`` with tensors (as device pointers) and
    ints, on the current CUDA stream; raise if the launch failed."""
    lib = library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else
            (None if a is None else int(a)) for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*conv, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.rrtm_error_string(err).decode()}")


class Launches:
    """A launch counter: ``launches`` goes up by one per kernel launch."""

    def __init__(self):
        self.launches = 0


def check(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, kernel takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
