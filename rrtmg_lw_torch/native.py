"""The C++ wire encoders (``native/wirecodec.cc``), loaded with ctypes.

The port's own loader, after ``rrtmg_lw_tpu/native/__init__.py:120-182``:
at first use ``native/wirecodec.cc`` compiles with ``g++ -O2 -shared
-fPIC`` into ``build/rrtmg_lw_torch/<hash>/libwirecodec.so`` (the hash
covers the source and the flags, as ``_build`` does for the kernels); the
shared object committed beside the source is never loaded.  The encoders
run on the host, per batch, on the prefetch thread, and are bit-identical
to the numpy reference encoders of ``parallel.wire`` (same median, same
operation order, round-half-even), which stay the reference and run
where the library does not build or with ``RRTMG_WIRE_NATIVE=0``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

from ._build import BUILD_ROOT

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "native" / \
    "wirecodec.cc"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()


def _compile(out: pathlib.Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)                # atomic against a parallel build
    return True


@functools.lru_cache(maxsize=None)
def _library():
    """The encoders' library, built on first use; None where it does not
    build."""
    if not SOURCE.exists():
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    so = BUILD_ROOT / h.hexdigest()[:16] / "libwirecodec.so"
    with _LOCK:
        if not so.exists() and not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:                 # built elsewhere: build it here
            if not _compile(so):
                return None
            lib = ctypes.CDLL(str(so))
    pd = ctypes.POINTER(ctypes.c_double)
    pu = ctypes.POINTER(ctypes.c_uint16)
    for name in ("wc_enc_logratio", "wc_enc_delta"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = [pd, ctypes.c_longlong, ctypes.c_longlong, pd, pd, pu]
    return lib


def _call(fn_name, x):
    """x (B, ...) float64 -> (codes uint16, ref float64 (inner...), lo,
    hi, the function's count), or None where the library is missing."""
    lib = _library()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float64)
    B = x.shape[0]
    inner = x.shape[1:]
    K = int(np.prod(inner, dtype=np.int64)) if inner else 1
    ref = np.empty(max(K, 1), np.float64)
    rng = np.empty(2, np.float64)
    u = np.empty((B, max(K, 1)), np.uint16)
    pd = ctypes.POINTER(ctypes.c_double)
    pu = ctypes.POINTER(ctypes.c_uint16)
    res = getattr(lib, fn_name)(
        x.reshape(B, K).ctypes.data_as(pd), B, K,
        ref.ctypes.data_as(pd), rng.ctypes.data_as(pd),
        u.ctypes.data_as(pu))
    return (u.reshape((B,) + inner), ref.reshape(inner),
            float(rng[0]), float(rng[1]), res)


def wire_enc_logratio(x):
    """The logratio encoder (``wc_enc_logratio``), or None."""
    return _call("wc_enc_logratio", x)


def wire_enc_delta(x):
    """The delta encoder (``wc_enc_delta``), or None."""
    return _call("wc_enc_delta", x)


def wire_native_available() -> bool:
    """True where the C++ encoders built and loaded."""
    return _library() is not None
