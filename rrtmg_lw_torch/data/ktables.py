"""k-distribution and static tables for the PyTorch port.

The tables are the JAX package's ``.npz`` assets in
``rrtmg_lw_tpu/assets/``, read by file path: importing
``rrtmg_lw_tpu.data.ktables`` would import JAX through that package's
``__init__``.  Resolution order matches
``rrtmg_lw_tpu.data.ktables.load_ktables``: ``ktables_real.npz``, then
``ktables_synthetic.npz``.

``tables_from_numpy`` carries a set of numpy tables (for example a JAX
model's ``model.ktables`` and ``model.static_np``) across to tensors on
a device, plus the flat float32 table buffer and region descriptors of
the taumol CUDA kernel.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from ..config import resolve_device

ASSET_DIR = (pathlib.Path(__file__).resolve().parents[2]
             / "rrtmg_lw_tpu" / "assets")

# static arrays the port uses as tensors (the rest stay numpy)
STATIC_TENSORS = ("totplnk", "totplnkderiv", "totplk16", "totplk16deriv",
                  "preflog", "tref", "chi_mls", "absice0", "absice1",
                  "absice2", "absice3", "absliq0", "absliq1", "abscld1")


def load_static() -> dict:
    """The in-source static tables (Planck, reference atmosphere, cloud
    optics, g-point maps)."""
    with np.load(ASSET_DIR / "static_tables.npz") as z:
        return {k: z[k] for k in z.files}


def load_ktables() -> tuple[dict, bool]:
    """Packed k-tables ``{'b01': {name: array}, ...}`` and whether they
    are the real (not synthetic) data."""
    real = ASSET_DIR / "ktables_real.npz"
    if real.exists():
        return _load_npz(real), True
    synth = ASSET_DIR / "ktables_synthetic.npz"
    if synth.exists():
        return _load_npz(synth), False
    raise FileNotFoundError(f"no k-table asset in {ASSET_DIR}")


def _load_npz(path) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            bk, name = key.split("/", 1)
            out.setdefault(bk, {})[name] = z[key]
    return out


@dataclasses.dataclass
class Tables:
    """Every table the port reads, on one device.

    ``bands`` and ``static_t`` hold the model dtype; ``kernel_tabs`` /
    ``kernel_desc`` are the taumol kernel's flat float32 buffer and int32
    region descriptors (``ops.taumol_cuda.pack_tables``)."""
    ktables: dict                  # numpy, as given
    static: dict                   # numpy, as given
    bands: dict                    # 'b01' -> name -> tensor
    static_t: dict                 # name -> tensor
    kernel_tabs: torch.Tensor      # (N,) float32
    kernel_desc: torch.Tensor      # (16, 2, NDESC) int32
    kernel_offsets: dict           # ('b01', name) -> offset into kernel_tabs
    is_real: bool = True

    def to_numpy(self) -> tuple[dict, dict]:
        """(ktables, static) rebuilt from the tensors."""
        kt = {bk: {k: v.cpu().numpy() for k, v in tabs.items()}
              for bk, tabs in self.bands.items()}
        st = dict(self.static)
        st.update({k: v.cpu().numpy() for k, v in self.static_t.items()})
        return kt, st


def tables_from_numpy(ktables: dict, static: dict, device=None,
                      dtype=torch.float64, is_real: bool = True) -> Tables:
    """Tensors on ``device`` (the CUDA device when None) for numpy
    ``ktables`` and ``static``."""
    from ..ops.taumol_cuda import pack_tables

    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device, dtype)

    bands = {bk: {k: t(v) for k, v in tabs.items()}
             for bk, tabs in ktables.items()}
    static_t = {k: t(static[k]) for k in STATIC_TENSORS}
    flat, desc, offsets = pack_tables(ktables, static)
    return Tables(ktables=ktables, static=static, bands=bands,
                  static_t=static_t,
                  kernel_tabs=torch.as_tensor(flat).to(device),
                  kernel_desc=torch.as_tensor(desc).to(device),
                  kernel_offsets=offsets, is_real=is_real)


def load_tables(device=None, dtype=torch.float64) -> Tables:
    """load_ktables + load_static, carried to ``device`` (the CUDA device
    when None)."""
    ktables, is_real = load_ktables()
    return tables_from_numpy(ktables, load_static(), device, dtype,
                             is_real=is_real)
