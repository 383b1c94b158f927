"""Static configuration for the PyTorch port of the LW radiation model.

Same fields as ``rrtmg_lw_tpu.config.LWConfig`` (the reference's flag
system, doc/rrtmg_lw_instructions.txt:72-143), except that the JAX
package's three backend switches (``taumol_impl``, ``rt_impl``,
``pallas_interpret``) collapse into one ``impl``:

  "cuda"   the hand-written CUDA kernels (needs a CUDA device, float32)
  "eager"  the plain PyTorch versions of those kernels, on any device
  "auto"   "cuda" on a CUDA device in float32, else "eager" (the JAX
           package's "auto" picks Pallas only in float32,
           models/radiation.py:56-69)

Which stages a "cuda" step runs on the kernels also follows from the
config (``models.radiation``): the RT sweep kernel only for
``use_lut=False`` over all 16 bands.

The entry points (``make_model``, the ``from_numpy`` of the input
types, ``load_tables``) run on the card unless the caller names another
device: ``resolve_device`` turns their ``device=None`` into CUDA, and
raises where there is none.
"""

from __future__ import annotations

import dataclasses

import torch

IMPLS = ("auto", "cuda", "eager")


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when it is None; raises
    RuntimeError when None is given and no CUDA device exists."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class LWConfig:
    icld: int = 0
    idrv: int = 0
    iaer: int = 0
    inflag: int = 2
    iceflag: int = 3
    liqflag: int = 1
    irng: int = 2
    imca: int = 1
    idcor: int = 0
    istart: int = 1
    iend: int = 16
    use_lut: bool = True
    impl: str = "auto"
    dtype: str = "float64"     # torch dtype name: "float32" | "float64"
    cpdair: float = 1.004e3

    @property
    def torch_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown torch dtype {self.dtype!r}")
        return dt

    def resolve_impl(self, device) -> str:
        """The implementation this config runs on ``device``; raises
        ValueError for ``impl="cuda"`` off a CUDA device or outside
        float32."""
        device = torch.device(device)
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")
        f32 = self.torch_dtype == torch.float32
        if self.impl == "auto":
            return "cuda" if device.type == "cuda" and f32 else "eager"
        if self.impl == "cuda" and device.type != "cuda":
            raise ValueError(f"impl='cuda' needs a CUDA device, got {device}")
        if self.impl == "cuda" and not f32:
            raise ValueError("the CUDA kernels run in float32; use "
                             "dtype='float32' or impl='eager'")
        return self.impl

    def replace(self, **kw) -> "LWConfig":
        return dataclasses.replace(self, **kw)
