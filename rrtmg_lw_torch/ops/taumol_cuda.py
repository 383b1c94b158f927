"""Taumol forward kernel (K2), csrc/taumol.cu, and its backward (K5),
csrc/taumol_bwd.cu.

K2 replaces ``rrtmg_lw_tpu/ops/taumol_pallas.py::PallasTaumol._build.kernel``,
K5 its ``kernel_bwd``.  The TPU kernels selected table rows with one-hot
matmuls over bf16 splits inside 64-row pressure windows; on the H100 a
gather from the ~1 MB table set is native, so both gather directly, in
float32.

``pack_tables`` compiles ``taumol.BAND_SPECS`` once into
  * one flat float32 buffer holding every band's tables (row-major,
    ``ng`` floats per row, each table starting on ``TAB_ALIGN`` floats)
    plus chi_mls and the per-g rescale vectors,
  * an int32 descriptor of ``len(DESC_FIELDS)`` words per (band,
    region); float constants are stored bit-cast.
K2 runs one thread per (column, layer), walking the 16 bands with each
(band, region)'s structure compiled in (``shape_words``, written into
csrc/taumol.cu by ``python -m rrtmg_lw_torch.ops.taumol_cuda``) and
reading table rows 8 bytes at a time; K5 one thread per (column, layer) reading
the descriptor of the band and region.
``DESC_FIELDS``, ``FLOAT_FIELDS`` and ``INT_FIELDS`` must match the
enums in csrc/taumol.cuh (a CPU test compares them).

``taumol_blocked`` consumes the port's setcoef outputs, exactly as
``TaumolEngine.forward`` does, and packs them into (NF, L, B) float and
(NI, L, B) int fields outside ``TaumolFn``, so autograd carries the
fields' cotangents back through the packing and the plain setcoef.  On
a CPU tensor the Function runs the plain versions, ``taumol_packed``
(``TaumolEngine.blocked`` on the unpacked fields) and
``taumol_packed_vjp``.

With a reduced ``spec_dtype`` (``spec_codec``: bfloat16, float16, or
uint16 for logu16 codes) K2 stores taug and fracs in that dtype, encoded
at the store (K7); the plain version encodes ``taumol_packed``'s output
with ``spec_codec.spec_store``.  The backward then raises
NotImplementedError, as the JAX package's does.  Launches in reduced
storage also count in ``taumol_blocked.spec.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..types import NGPT, Profile, SetcoefOut
from ._autograd import plain_vjp
from .spec_codec import GRAD_MESSAGE, REDUCED, SPEC_CODES, spec_store
from .taumol import (_GAS_CHI, BAND_SPECS, NBANDS, NG, NSPA, NSPB,
                     postscale_vector, refrat)

# per-cell float inputs, packed (NF, L, B)
FLOAT_FIELDS = (
    "colh2o", "colco2", "colo3", "coln2o", "colco", "colch4", "colo2",
    "colbrd", "fac00", "fac01", "fac10", "fac11",
    "rat_h2oco2", "rat_h2oco2_1", "rat_h2oo3", "rat_h2oo3_1",
    "rat_h2on2o", "rat_h2on2o_1", "rat_h2och4", "rat_h2och4_1",
    "rat_n2oco2", "rat_n2oco2_1", "rat_o3co2", "rat_o3co2_1",
    "selffac", "selffrac", "forfac", "forfrac", "minorfrac", "scaleminor",
    "scaleminorn2", "coldry", "wx0", "wx1", "wx2", "wx3", "pavel")
# per-cell int inputs, packed (NI, L, B)
INT_FIELDS = ("laytrop", "jp", "jt", "jt1", "indself", "indfor", "indminor")

MAX_MINORS = 3
MAX_CFCS = 2
_MINOR_FIELDS = ("KIND", "OFF", "NK", "COLA", "COLB", "ADJ_GAS", "ADJ_CHI",
                 "ADJ_THRESH", "ADJ_BASE", "ADJ_EXPNT", "ADJ_CHICONST",
                 "REF_G1", "REF_G2", "REFRAT")
DESC_FIELDS = (
    ("ZERO", "GOFF", "NGB", "KEY1", "KEY2", "RAT0", "RAT1", "NSP", "ETA4",
     "ABS_OFF", "NROW", "NA", "SELF_OFF", "FOR_OFF", "NMINOR")
    + tuple(f"M{i}_{f}" for i in range(MAX_MINORS) for f in _MINOR_FIELDS)
    + ("NCFC",)
    + tuple(f"C{i}_{f}" for i in range(MAX_CFCS) for f in ("WX", "OFF"))
    + ("CORR", "POST_OFF", "FRAC_OFF", "FRAC_ETA", "FRAC_NROW", "FRAC_G1",
       "FRAC_G2", "FRAC_REFRAT"))
_D = {name: i for i, name in enumerate(DESC_FIELDS)}
_F = {name: i for i, name in enumerate(FLOAT_FIELDS)}
_CORR = {None: 0, "b1l": 1, "b1u": 2, "b2": 3}
# BIN_SLOTS of TaumolEngine.bins, written when the kernel gets a bins buffer
NBIN = 4
# every table of pack_tables starts on this many floats (8 bytes): K2
# reads a row of ng floats (ng even) 8 bytes at a time
TAB_ALIGN = 2


def _f32_bits(x: float) -> int:
    return int(np.array(x, np.float32).view(np.int32))


def _col(gas: str) -> int:
    return _F["col" + gas]


def pack_tables(ktables: dict, static: dict):
    """(flat float32 tables, (16, 2, NDESC) int32 descriptors, offsets
    {(band key, table name): offset})."""
    chunks, offsets = [], {}
    size = 0

    def put(key, arr):
        nonlocal size
        arr = np.ascontiguousarray(arr, np.float32).reshape(-1)
        pad = -size % TAB_ALIGN
        if pad:
            chunks.append(np.zeros(pad, np.float32))
            size += pad
        offsets[key] = size
        chunks.append(arr)
        size += arr.size
        return offsets[key]

    chi = np.asarray(static["chi_mls"], np.float64)
    chi_off = put(("chi", "chi_mls"), chi)
    desc = np.zeros((NBANDS, 2, len(DESC_FIELDS)), np.int32)
    goff = 0
    for bspec in BAND_SPECS:
        b = bspec.band
        bk = f"b{b:02d}"
        tabs = ktables[bk]
        ng = NG[b - 1]
        for name in sorted(set(tabs) - {"absa", "absb"}):
            put((bk, name), tabs[name])
        absa, absb = tabs["absa"], tabs.get("absb")
        fused = absa if absb is None else np.concatenate([absa, absb], 0)
        abs_off = put((bk, "_abs"), fused)
        for r, (spec, lower) in enumerate(((bspec.lower, True),
                                           (bspec.upper, False))):
            d = desc[b - 1, r]

            def setf(name, value):
                d[_D[name]] = value

            setf("GOFF", goff)
            setf("NGB", ng)
            setf("ZERO", int(spec.zero))
            if spec.zero:
                continue
            setf("NSP", NSPA[b - 1] if lower else NSPB[b - 1])
            setf("KEY1", _col(spec.key1) if spec.key1 else -1)
            setf("KEY2", _col(spec.key2) if spec.key2 else -1)
            setf("RAT0", _F["rat_" + spec.rat] if spec.rat else -1)
            setf("RAT1", _F["rat_" + spec.rat + "_1"] if spec.rat else -1)
            setf("ETA4", int(lower and spec.key2 is not None))
            setf("ABS_OFF", abs_off)
            setf("NROW", fused.shape[0])
            setf("NA", absa.shape[0])
            setf("SELF_OFF", offsets[bk, "selfref"] if spec.tauself else -1)
            setf("FOR_OFF", offsets[bk, "forref"] if spec.taufor else -1)
            if len(spec.minors) > MAX_MINORS or len(spec.cfcs) > MAX_CFCS:
                raise ValueError(f"band {b}: too many minor/CFC terms")
            setf("NMINOR", len(spec.minors))
            for i, m in enumerate(spec.minors):
                p = f"M{i}_"
                setf(p + "KIND", int(m.kind == "eta"))
                setf(p + "OFF", offsets[bk, m.table])
                setf(p + "NK", tabs[m.table].shape[1]
                     if m.kind == "eta" else 0)
                cola, colb = {
                    "scale_n2": ("colbrd", "scaleminorn2"),
                    "scale_o2": ("colo2", "scaleminor"),
                    "scale_brd": ("colbrd", "scaleminor"),
                }.get(m.col, (m.col if m.col.startswith("col") else None,
                              None))
                setf(p + "COLA", _F[cola] if cola else -1)
                setf(p + "COLB", _F[colb] if colb else -1)
                setf(p + "ADJ_GAS", _col(m.adj.gas) if m.adj else -1)
                setf(p + "ADJ_CHI", -1)
                if m.adj is not None:
                    if m.adj.chi_const is None:
                        setf(p + "ADJ_CHI", chi_off
                             + (_GAS_CHI[m.adj.gas] - 1) * chi.shape[1])
                    else:
                        setf(p + "ADJ_CHICONST", _f32_bits(m.adj.chi_const))
                    setf(p + "ADJ_THRESH", _f32_bits(m.adj.threshold))
                    setf(p + "ADJ_BASE", _f32_bits(m.adj.base))
                    setf(p + "ADJ_EXPNT", _f32_bits(m.adj.expnt))
                if m.refrat is not None:
                    g1, g2, plev = m.refrat
                    setf(p + "REF_G1", _col(g1))
                    setf(p + "REF_G2", _col(g2))
                    setf(p + "REFRAT", _f32_bits(refrat(chi, g1, g2, plev)))
            setf("NCFC", len(spec.cfcs))
            for i, (wx_i, vec) in enumerate(spec.cfcs):
                setf(f"C{i}_WX", _F[f"wx{wx_i - 1}"])
                setf(f"C{i}_OFF", offsets[bk, vec])
            setf("CORR", _CORR[spec.corradj])
            setf("POST_OFF", put((bk, f"_post{r}"),
                                 postscale_vector(spec, ng))
                 if spec.postscale else -1)
            ftab = tabs[spec.frac]
            setf("FRAC_OFF", offsets[bk, spec.frac])
            if spec.frac_eta is not None:
                g1, g2, plev = spec.frac_eta
                setf("FRAC_ETA", 1)
                setf("FRAC_NROW", ftab.shape[0])
                setf("FRAC_G1", _col(g1))
                setf("FRAC_G2", _col(g2))
                setf("FRAC_REFRAT", _f32_bits(refrat(chi, g1, g2, plev)))
        goff += ng
    if goff != NGPT:
        raise ValueError(f"bands cover {goff} g-points, expected {NGPT}")
    return np.concatenate(chunks), desc, offsets


# The words of a (band, region) descriptor that BAND_SPECS alone fixes
# (flags, counts, g offsets, field indices): K2 compiles them in (the
# Shape tables between SHAPE_BEGIN and SHAPE_END in csrc/taumol.cu) and
# reads the rest (table offsets and shapes, float constants) from the
# descriptor it is given.  The words of SHAPE_SIGNS only say, by their
# sign, whether a table is there.
SHAPE_WORDS = frozenset(
    ("ZERO", "GOFF", "NGB", "KEY1", "KEY2", "RAT0", "RAT1", "NSP", "ETA4",
     "NMINOR", "NCFC", "CORR", "FRAC_ETA", "FRAC_G1", "FRAC_G2")
    + tuple(f"M{i}_{f}" for i in range(MAX_MINORS)
            for f in ("KIND", "COLA", "COLB", "ADJ_GAS", "REF_G1", "REF_G2"))
    + tuple(f"C{i}_WX" for i in range(MAX_CFCS)))
SHAPE_SIGNS = frozenset(("SELF_OFF", "FOR_OFF", "POST_OFF")
                        + tuple(f"M{i}_ADJ_CHI" for i in range(MAX_MINORS)))
SHAPE_SOURCE = _build.CSRC / "taumol.cu"
SHAPE_BEGIN, SHAPE_END = "// BEGIN SHAPES\n", "// END SHAPES\n"


def shape_words(desc) -> np.ndarray:
    """The (16, 2, NDESC) descriptors with every word outside SHAPE_WORDS
    zero, and those of SHAPE_SIGNS -1 where absent, else 0."""
    out = np.zeros_like(np.asarray(desc, np.int32))
    for name, i in _D.items():
        if name in SHAPE_WORDS:
            out[..., i] = desc[..., i]
        elif name in SHAPE_SIGNS:
            out[..., i] = np.where(desc[..., i] >= 0, 0, -1)
    return out


def shape_section(desc) -> str:
    """csrc/taumol.cu's Shape tables, SHAPE_BEGIN to SHAPE_END, for
    pack_tables' ``desc``."""
    lines = [
        SHAPE_BEGIN.rstrip(),
        "// Generated by python -m rrtmg_lw_torch.ops.taumol_cuda from",
        "// pack_tables' descriptors (ops/taumol_cuda.py::shape_words): the",
        "// words that BAND_SPECS alone fixes, per (band, region); the other",
        "// words are 0, and table presence words -1 (absent) or 0.  Do not",
        "// edit: tests/test_torch_port.py holds it equal to the generator.",
        "template <int BAND, int REGION> struct Shape;",
    ]
    for b, regions in enumerate(shape_words(desc)):
        for r, words in enumerate(regions):
            lines.append(f"template <> struct Shape<{b}, {r}> {{")
            lines.append("    static constexpr int w[NDESC] = {")
            row = "       "
            for x in words:
                item = f" {int(x)},"
                if len(row) + len(item) > 76:
                    lines.append(row)
                    row = "       "
                row += item
            lines.append(row)
            lines.append("    };")
            lines.append("};")
    return "\n".join(lines) + "\n" + SHAPE_END


def source_shape_section(text: str) -> str:
    """The SHAPE_BEGIN ... SHAPE_END section of csrc/taumol.cu's ``text``."""
    a = text.index(SHAPE_BEGIN)
    return text[a:text.index(SHAPE_END, a) + len(SHAPE_END)]


def _pack_inputs(sc, prof):
    """(NF, L, B) float and (NI, L, B) int32 per-cell inputs."""
    named = sc._asdict()
    named.update(coldry=prof.coldry, pavel=prof.pavel,
                 **{f"wx{i}": prof.wx[..., i] for i in range(4)})
    named["laytrop"] = sc.laytrop_mask
    fld = torch.stack([named[k].t() for k in FLOAT_FIELDS]).to(
        sc.fac00.dtype).contiguous()
    ifld = torch.stack([named[k].t().to(torch.int32)
                        for k in INT_FIELDS]).contiguous()
    return fld, ifld


def _unpack_inputs(fld, ifld):
    """The (SetcoefOut, Profile) that ``TaumolEngine`` reads, as (B, L)
    tensors from the packed fields (Profile fields it does not read are
    None)."""
    f = {k: fld[i].t().contiguous() for i, k in enumerate(FLOAT_FIELDS)}
    n = {k: ifld[i].t().contiguous() for i, k in enumerate(INT_FIELDS)}
    named = {**f, **n, "laytrop_mask": n["laytrop"] != 0}
    sc = SetcoefOut(**{k: named.get(k) for k in SetcoefOut._fields})
    prof = Profile(**{**dict.fromkeys(Profile._fields),
                      "coldry": f["coldry"], "pavel": f["pavel"],
                      "wx": torch.stack([f[f"wx{i}"] for i in range(4)], -1)})
    return sc, prof


def taumol_packed(engine, fld, ifld):
    """taug, fracs (L, 140, B) from the packed fields: the plain version
    of K2."""
    return engine.blocked(*_unpack_inputs(fld, ifld))


def taumol_packed_vjp(engine, fld, ifld, ct_taug, ct_fracs):
    """ct_taug, ct_fracs (L, 140, B) -> the cotangent of fld (NF, L, B):
    the plain version of K5."""
    return plain_vjp(lambda f: taumol_packed(engine, f, ifld), (fld,),
                     (True,), (ct_taug, ct_fracs))[0]


def _check_packed(fld, ifld, kernel_tabs, kernel_desc):
    _, L, B = fld.shape
    dev = fld.device
    _build.check(fld, "fld", torch.float32, (len(FLOAT_FIELDS), L, B), dev)
    _build.check(ifld, "ifld", torch.int32, (len(INT_FIELDS), L, B), dev)
    _build.check(kernel_tabs, "kernel_tabs", torch.float32,
                 kernel_tabs.shape, dev)
    _build.check(kernel_desc, "kernel_desc", torch.int32,
                 (NBANDS, 2, len(DESC_FIELDS)), dev)
    ndesc = _build.library().rrtm_taumol_ndesc()
    if ndesc != len(DESC_FIELDS):
        raise RuntimeError(f"taumol.cuh has {ndesc} descriptor words, "
                           f"pack_tables {len(DESC_FIELDS)}")
    return L, B


def _check_shape(kernel_desc):
    """Raise unless ``kernel_desc``'s BAND_SPECS words are those K2 was
    built with (``rrtm_taumol_shape``); once per descriptor tensor, and
    again after an in-place change to it."""
    if getattr(kernel_desc, "_k2_shape_version", None) == \
            kernel_desc._version:
        return
    built = np.zeros(tuple(kernel_desc.shape), np.int32)
    _build.library().rrtm_taumol_shape(built.ctypes.data)
    want = shape_words(kernel_desc.cpu().numpy())
    if not np.array_equal(built, want):
        band, region, word = np.argwhere(built != want)[0]
        raise RuntimeError(
            f"kernel_desc's {DESC_FIELDS[word]} of band {band + 1} "
            f"({('lower', 'upper')[region]}) is {want[band, region, word]}, "
            f"K2 was built with {built[band, region, word]}: regenerate "
            "csrc/taumol.cu's shapes (python -m rrtmg_lw_torch.ops."
            "taumol_cuda)")
    kernel_desc._k2_shape_version = kernel_desc._version


class TaumolFn(torch.autograd.Function):
    """(fld, ifld, engine, kernel_tabs, kernel_desc, bins, spec_dtype) ->
    taug, fracs (L, 140, B) in ``spec_dtype``.  Backward K5, to fld only
    (float32 storage; otherwise it raises); ``bins`` (or None) is filled
    as ``taumol_blocked`` says."""

    @staticmethod
    def forward(ctx, fld, ifld, engine, kernel_tabs, kernel_desc, bins,
                spec_dtype=torch.float32):
        ctx.reduced = spec_dtype in REDUCED
        if ctx.needs_input_grad[0] and not ctx.reduced:
            ctx.save_for_backward(fld, ifld, kernel_tabs, kernel_desc)
            ctx.engine = engine
        if fld.device.type == "cpu":
            if bins is not None:
                bins.copy_(engine.bins(*_unpack_inputs(fld, ifld)))
            taug, fracs = taumol_packed(engine, fld, ifld)
            if ctx.reduced:
                return (spec_store(taug, spec_dtype, "tg"),
                        spec_store(fracs, spec_dtype, "fr"))
            return taug, fracs
        L, B = _check_packed(fld, ifld, kernel_tabs, kernel_desc)
        _check_shape(kernel_desc)
        if bins is not None:
            _build.check(bins, "bins", torch.int32, (NBANDS, NBIN, L, B),
                         fld.device)
        taug = torch.empty((L, NGPT, B), dtype=spec_dtype, device=fld.device)
        fracs = torch.empty_like(taug)
        _build.launch("rrtm_taumol", fld, ifld, kernel_tabs, kernel_desc,
                      taug, fracs, bins, L, B, SPEC_CODES[spec_dtype])
        taumol_blocked.launches += 1
        if ctx.reduced:
            taumol_blocked.spec.launches += 1
        return taug, fracs

    @staticmethod
    def backward(ctx, ct_taug, ct_fracs):
        if ctx.reduced:
            raise NotImplementedError(GRAD_MESSAGE)
        fld, ifld, tabs, desc = ctx.saved_tensors
        return (taumol_vjp(fld, ifld, ctx.engine, tabs, desc,
                           ct_taug.contiguous(), ct_fracs.contiguous()),
                None, None, None, None, None, None)


def taumol_blocked(sc, prof, engine, kernel_tabs, kernel_desc, bins=None,
                   spec_dtype=torch.float32):
    """taug, fracs (L, 140, B) for all bands, stored in ``spec_dtype``
    (a key of ``spec_codec.SPEC_CODES``).

    ``engine`` is the plain ``TaumolEngine`` (used for CPU tensors);
    ``kernel_tabs`` / ``kernel_desc`` come from ``pack_tables`` on the
    device.  ``bins``, if given, is a (16, NBIN, L, B) int32 tensor the
    kernel fills with the interpolation bins it used (the layout of
    ``TaumolEngine.bins``)."""
    if spec_dtype not in SPEC_CODES:
        raise ValueError(f"no spectral storage {spec_dtype}")
    fld, ifld = _pack_inputs(sc, prof)
    return TaumolFn.apply(fld, ifld, engine, kernel_tabs, kernel_desc, bins,
                          spec_dtype)


K2_INFO = ("registers", "local_bytes", "static_smem", "dynamic_smem",
           "blocks_per_sm", "threads", "columns")


def k2_info(spec_dtype=torch.float32):
    """K2's launch configuration with taug / fracs in ``spec_dtype``:
    ``K2_INFO`` -> int, from the CUDA runtime (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the card."""
    buf = (ctypes.c_int * len(K2_INFO))()
    lib = _build.library()
    err = lib.rrtm_taumol_info(SPEC_CODES[spec_dtype],
                               ctypes.cast(buf, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError("rrtm_taumol_info: "
                           + lib.rrtm_error_string(err).decode())
    return dict(zip(K2_INFO, buf))


def taumol_vjp(fld, ifld, engine, kernel_tabs, kernel_desc, ct_taug,
               ct_fracs):
    """K5: ct_taug, ct_fracs (L, 140, B) -> the cotangent of fld
    (NF, L, B)."""
    if fld.device.type == "cpu":
        return taumol_packed_vjp(engine, fld, ifld, ct_taug, ct_fracs)
    L, B = _check_packed(fld, ifld, kernel_tabs, kernel_desc)
    for name, ct in (("ct_taug", ct_taug), ("ct_fracs", ct_fracs)):
        _build.check(ct, name, torch.float32, (L, NGPT, B), fld.device)
    ct_fld = torch.empty_like(fld)
    _build.launch("rrtm_taumol_bwd", fld, ifld, kernel_tabs, kernel_desc,
                  ct_taug, ct_fracs, ct_fld, L, B)
    taumol_vjp.launches += 1
    return ct_fld


taumol_blocked.launches = 0
taumol_blocked.spec = _build.Launches()
taumol_vjp.launches = 0


if __name__ == "__main__":
    from ..data.ktables import load_ktables, load_static
    text = SHAPE_SOURCE.read_text()
    SHAPE_SOURCE.write_text(text.replace(
        source_shape_section(text),
        shape_section(pack_tables(load_ktables()[0], load_static())[1])))
    print(f"wrote the shapes of {SHAPE_SOURCE}")
