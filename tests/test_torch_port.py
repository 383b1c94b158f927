"""The PyTorch port's scaffold against the JAX package: no JAX import,
the same band descriptions, constants, tables and synthetic inputs, the
taumol kernel's descriptor layout, the CPU dispatch of every CUDA
kernel wrapper (no nvcc here: a CPU tensor must reach the plain
version and never the kernel library), and the entry points' default
device (the card, or an error where there is none)."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import rrtmg_lw_tpu.constants as jconst
from rrtmg_lw_tpu.data import ktables as jkt
from rrtmg_lw_tpu.ops import taumol as jtaumol
from rrtmg_lw_tpu.utils import synthetic as jsyn

import rrtmg_lw_torch.constants as tconst
from rrtmg_lw_torch import LWConfig, make_model
from rrtmg_lw_torch import _build
from rrtmg_lw_torch.data import ktables as tkt
from rrtmg_lw_torch.ops import taumol as ttaumol
from rrtmg_lw_torch.ops import taumol_cuda
from rrtmg_lw_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = ("import sys, pkgutil, importlib, rrtmg_lw_torch\n"
            "for m in pkgutil.walk_packages(rrtmg_lw_torch.__path__, "
            "'rrtmg_lw_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'rrtmg_lw_tpu'))]\n"
            "assert not bad, bad\n"
            "for m in ('rrtmg_lw_torch.parallel.api', "
            "'rrtmg_lw_torch.ops._autograd'):\n"
            "    assert m in sys.modules, m\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _spec_dicts(specs):
    return [dataclasses.asdict(s) for s in specs]


def test_band_specs_equal_jax():
    assert _spec_dicts(ttaumol.BAND_SPECS) == _spec_dicts(jtaumol.BAND_SPECS)
    assert (ttaumol.NG, ttaumol.NSPA, ttaumol.NSPB) == \
        (jtaumol.NG, jtaumol.NSPA, jtaumol.NSPB)
    assert ttaumol._GAS_CHI == jtaumol._GAS_CHI


def test_constants_equal_jax():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names
    for n in names:
        np.testing.assert_array_equal(getattr(tconst, n), getattr(jconst, n),
                                      err_msg=n)
    assert tconst.heatfac(1003.5) == jconst.heatfac(1003.5)


def test_assets_load_like_jax():
    kt_t, real_t = tkt.load_ktables()
    kt_j, real_j = jkt.load_ktables()
    assert real_t == real_j
    assert kt_t.keys() == kt_j.keys()
    for bk in kt_j:
        assert kt_t[bk].keys() == kt_j[bk].keys()
        for name, arr in kt_j[bk].items():
            np.testing.assert_array_equal(kt_t[bk][name], arr)
    st_t, st_j = tkt.load_static(), jkt.load_static()
    assert st_t.keys() == st_j.keys()
    for k in st_j:
        np.testing.assert_array_equal(st_t[k], st_j[k])


def test_tables_from_numpy_round_trips():
    from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
    jm = jmake_model(JConfig(taumol_impl="xla", rt_impl="xla"))
    kt, static = jm.ktables, jm.static_np
    tabs = tkt.tables_from_numpy(kt, static, "cpu", torch.float64)
    kt2, st2 = tabs.to_numpy()
    for bk in kt:
        for name, arr in kt[bk].items():
            np.testing.assert_array_equal(kt2[bk][name], arr)
    for k in static:
        np.testing.assert_array_equal(st2[k], static[k])
    # the kernel's flat float32 buffer holds every table at its offset
    flat = tabs.kernel_tabs.numpy()
    assert flat.dtype == np.float32
    for (bk, name), off in tabs.kernel_offsets.items():
        if bk == "chi":
            src = static["chi_mls"]
        elif name == "_abs":
            src = np.concatenate([kt[bk]["absa"]]
                                 + ([kt[bk]["absb"]] if "absb" in kt[bk]
                                    else []))
        elif name.startswith("_post"):
            continue
        else:
            src = kt[bk][name]
        np.testing.assert_array_equal(
            flat[off:off + src.size], src.astype(np.float32).reshape(-1),
            err_msg=f"{bk}/{name}")
    # and a model built from them runs
    model = make_model(LWConfig(icld=0, use_lut=False), device="cpu",
                       tables=tabs)
    assert model.is_real_kdata


@pytest.mark.parametrize("seed,clear_frac", [(0, 0.0), (3, 0.25)])
def test_synthetic_bitwise_equal_jax(seed, clear_frac):
    for dt in (np.float64, np.float32):
        a_t = tsyn.make_atmosphere(ncol=6, nlay=17, seed=seed, dtype=dt,
                                   aod=0.1)
        a_j = jsyn.make_atmosphere(ncol=6, nlay=17, seed=seed, dtype=dt,
                                   aod=0.1)
        for name in a_j._fields:
            x, y = getattr(a_t, name), getattr(a_j, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        for layout, kw in (("compact", dict(mask_dtype=np.int8)),
                           ("compact", {}), ("blocked", {}), ("batch", {})):
            c_t = tsyn.make_mcica_clouds(ncol=6, nlay=17, seed=seed + 2,
                                         dtype=dt, clear_frac=clear_frac,
                                         **(dict(layout=layout, **kw)
                                            if layout != "compact" else kw))
            c_j = jsyn.make_mcica_clouds(ncol=6, nlay=17, seed=seed + 2,
                                         dtype=dt, layout=layout,
                                         clear_frac=clear_frac, **kw)
            assert c_t._fields == c_j._fields
            assert type(c_t).__name__ == type(c_j).__name__
            for name in c_j._fields:
                x, y = getattr(c_t, name), getattr(c_j, name)
                assert x.dtype == y.dtype and x.shape == y.shape, name
                np.testing.assert_array_equal(x, y, err_msg=name)
        for nlay in (17, 2):            # decks past the top layer pile up
            b_t = tsyn.make_band_clouds(ncol=6, nlay=nlay, seed=seed + 1,
                                        dtype=dt)
            b_j = jsyn.make_band_clouds(ncol=6, nlay=nlay, seed=seed + 1,
                                        dtype=dt)
            assert b_t._fields == b_j._fields
            for name in b_j._fields:
                x, y = getattr(b_t, name), getattr(b_j, name)
                assert x.dtype == y.dtype and x.shape == y.shape, name
                np.testing.assert_array_equal(x, y, err_msg=name)


def _c_enum(src, name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
    return [t.strip() for t in body.replace("\n", " ").split(",")
            if t.strip()]


def test_rt_modes_match_cuda_source():
    """The K1 mode numbers of the wrappers are the kernel's enum Mode."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    src = open(os.path.join(REPO, "rrtmg_lw_torch", "csrc",
                            "rtrn.cuh")).read()
    names = [t.split("=")[0].strip() for t in _c_enum(src, "Mode")]
    values = [int(t.split("=")[1]) for t in _c_enum(src, "Mode")]
    assert values == list(range(len(names)))
    assert names == [m.upper() for m in rtrn_cuda.MODES]
    assert list(rtrn_cuda.MODES.values()) == values
    assert set(rtrn_cuda.CLOUD_INPUTS) | {"clear", "compact"} == \
        set(rtrn_cuda.MODES)


def test_taumol_descriptor_layout_matches_cuda_source():
    src = "".join(open(os.path.join(REPO, "rrtmg_lw_torch", "csrc", f)).read()
                  for f in ("taumol.cuh", "taumol.cu"))
    assert _c_enum(src, "FloatField") == \
        ["F_" + f.upper() for f in taumol_cuda.FLOAT_FIELDS] + ["NF"]
    assert _c_enum(src, "IntField") == \
        ["I_" + f.upper() for f in taumol_cuda.INT_FIELDS] + ["NI"]
    assert _c_enum(src, "Desc") == \
        ["D_" + f for f in taumol_cuda.DESC_FIELDS] + ["NDESC"]
    assert re.search(r"NBIN = %d;" % taumol_cuda.NBIN, src)
    assert len(ttaumol.BIN_SLOTS) == taumol_cuda.NBIN


def test_taumol_descriptors_cover_band_specs():
    kt, _ = jkt.load_ktables()
    _, desc, _ = taumol_cuda.pack_tables(kt, jkt.load_static())
    D = {n: i for i, n in enumerate(taumol_cuda.DESC_FIELDS)}
    goff = 0
    for bspec in ttaumol.BAND_SPECS:
        for r, spec in enumerate((bspec.lower, bspec.upper)):
            d = desc[bspec.band - 1, r]
            assert d[D["GOFF"]] == goff and d[D["NGB"]] == ttaumol.NG[
                bspec.band - 1]
            assert d[D["ZERO"]] == int(spec.zero)
            if spec.zero:
                continue
            assert d[D["NMINOR"]] == len(spec.minors)
            assert d[D["NCFC"]] == len(spec.cfcs)
            assert d[D["FRAC_ETA"]] == int(spec.frac_eta is not None)
            assert (d[D["POST_OFF"]] >= 0) == bool(spec.postscale)
        goff += ttaumol.NG[bspec.band - 1]
    # band 16 upper keeps nspb = 0 (taumol.f90:195-196)
    assert desc[15, 1, D["NSP"]] == 0
    assert goff == 140


def test_taumol_kernel_launch_fits_the_card():
    """K2's tile and thread constants, read from csrc/taumol.cu: its
    shared memory (the tile's NF + NI input rows and the 32 descriptors,
    static, the same in every storage) fits the 48 KB of static shared
    memory a block may hold (so also the 227 KB of dynamic), and
    MIN_BLOCKS blocks fit an SM's 228 KB, 2048 threads and 65536
    registers (at least 32 a thread); its table alignment is
    pack_tables', and a row load (VW floats) divides every band's ng."""
    src = open(os.path.join(REPO, "rrtmg_lw_torch", "csrc",
                            "taumol.cu")).read()

    def const(name):
        return int(re.search(r"\nconstexpr int %s = (\d+);" % name,
                             src).group(1))

    tb, min_blocks = const("TB"), const("MIN_BLOCKS")
    assert "constexpr int THREADS = TB;" in src
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in src
    assert const("TAB_ALIGN") == taumol_cuda.TAB_ALIGN
    assert all(ng % const("VW") == 0 for ng in ttaumol.NG)
    assert taumol_cuda.TAB_ALIGN % const("VW") == 0
    shared = re.findall(r"__shared__ (float|int) (\w+)\[(.*?)\];", src)
    assert [name for _, name, _ in shared] == ["sfld", "sifld", "sdesc"]
    assert [size for _, _, size in shared] == \
        ["NF * TB", "NI * TB", "NDESC_ALL"]
    assert "constexpr int NDESC_ALL = rrtm::NBAND * 2 * NDESC;" in src
    nf, ni = len(taumol_cuda.FLOAT_FIELDS), len(taumol_cuda.INT_FIELDS)
    smem = 4 * ((nf + ni) * tb
                + ttaumol.NBANDS * 2 * len(taumol_cuda.DESC_FIELDS))
    assert re.search(r"taumol_kernel<SPEC><<<grid, THREADS, 0, s>>>", src)
    assert smem <= 48 * 1024 <= 227 * 1024
    assert min_blocks * (smem + 1024) <= 228 * 1024
    assert tb % 32 == 0 and tb * min_blocks <= 2048
    assert 65536 // (tb * min_blocks) >= 32


def test_taumol_bwd_launch_fits_the_card():
    """K5's tile and thread constants, read from csrc/taumol_bwd.cu: its
    shared memory (the tile's NF float input rows, its NF rows of field
    sums and its NI int input rows as 16-bit, static) fits the 48 KB of
    static shared memory a block may hold, and MIN_BLOCKS blocks fit an
    SM's 228 KB, 2048 threads and 65536 registers (at least 32 a
    thread); its table alignment is pack_tables', a row load (VW floats)
    divides every band's ng, and setcoef's bins fit the 16 bits the int
    inputs are staged in."""
    src = open(os.path.join(REPO, "rrtmg_lw_torch", "csrc",
                            "taumol_bwd.cu")).read()

    def const(name):
        return int(re.search(r"\nconstexpr int %s = (\d+);" % name,
                             src).group(1))

    tb, min_blocks, vw = const("TB"), const("MIN_BLOCKS"), const("VW")
    assert "constexpr int THREADS = TB;" in src
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in src
    assert const("TAB_ALIGN") == taumol_cuda.TAB_ALIGN
    assert all(ng % vw == 0 for ng in ttaumol.NG)
    assert taumol_cuda.TAB_ALIGN % vw == 0
    shared = re.findall(r"__shared__ (float|short|int) (\w+)\[(.*?)\];", src)
    assert [(ty, size) for ty, _, size in shared] == [
        ("float", "NF * TB"), ("float", "NF * TB"), ("short", "NI * TB")]
    nf, ni = len(taumol_cuda.FLOAT_FIELDS), len(taumol_cuda.INT_FIELDS)
    smem = 4 * 2 * nf * tb + 2 * ni * tb
    assert "taumol_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>" \
        in src
    assert smem <= 48 * 1024
    assert min_blocks * (smem + 1024) <= 228 * 1024
    assert tb % 32 == 0 and tb * min_blocks <= 2048
    assert 65536 // (tb * min_blocks) >= 32
    # the int inputs are setcoef's bins, clamped far below 2**15
    setcoef_src = open(os.path.join(REPO, "rrtmg_lw_torch", "ops",
                                    "setcoef.py")).read()
    highs = [int(x) for x in re.findall(r"torch\.clamp\(_trunc_int\(.*?\), "
                                        r"\d+, (\d+)\)", setcoef_src)]
    assert highs and max(highs) < 2 ** 15


def test_taumol_bwd_bound_counts_only_the_cotangents_it_needs():
    """chip_smoke.taumol_bwd_work's bytes: a lower cell needs the
    cotangents of its 140 taug rows and of the 86 fraction rows that
    depend on its eta (FRAC_ETA), an upper cell those of the 130 taug
    rows that are not zero (bands 12 and 15) and of 46 fraction rows."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kt, static = jkt.load_ktables()[0], jkt.load_static()
    desc = torch.as_tensor(taumol_cuda.pack_tables(kt, static)[1])
    ifld = torch.zeros((len(taumol_cuda.INT_FIELDS), 3, 5), dtype=torch.int32)
    ifld[taumol_cuda.INT_FIELDS.index("laytrop"), :2] = 1   # 10 lower cells
    ops, nbytes = smoke.taumol_bwd_work(desc, ifld)
    assert nbytes == 4 * (10 * (140 + 86) + 5 * (130 + 46))
    ops_lower = smoke.taumol_bwd_work(desc, torch.ones_like(ifld))[0]
    ops_upper = smoke.taumol_bwd_work(desc, torch.zeros_like(ifld))[0]
    assert ops * 15 == 10 * ops_lower + 5 * ops_upper


def test_rt_adjoint_launch_fits_the_card():
    """K6's tile, ring and shared memory, read from csrc/rtrn_bwd.cu and
    csrc/rtrn.cuh: blocks of 16 columns x 16 g-lanes launched two to an
    SM (``__launch_bounds__(256, 2)``), which leaves 65536 / 512 = 128
    registers a thread; each instantiation's stated shared memory (the
    header's budget, which the source's static_assert holds to its
    layout) fits a block's 227 KB, and two blocks of it, with the 1 KB
    reserved each, an SM's 228 KB; a ring of at least two levels."""
    csrc = os.path.join(REPO, "rrtmg_lw_torch", "csrc")
    tile = open(os.path.join(csrc, "rtrn.cuh")).read()
    src = open(os.path.join(csrc, "rtrn_bwd.cu")).read()

    def const(text, name):
        return re.search(r"\nconstexpr int %s = (.+?);" % name,
                         text).group(1)

    kx, ky = int(const(tile, "KX")), int(const(tile, "KY"))
    assert const(tile, "KT") == "KX * KY"
    threads, blocks = kx * ky, int(const(tile, "BLOCKS_PER_SM"))
    assert (kx, threads, blocks) == (16, 256, 2)
    assert "__launch_bounds__(KT, BLOCKS_PER_SM)\nrt_bwd_kernel(" in src
    assert "const dim3 block(KX, KY);" in src
    assert int(const(src, "RING")) >= 2
    assert 65536 // (threads * blocks) >= 128
    sm, reserved = int(const(tile, "SMEM_SM")), int(const(tile,
                                                            "SMEM_RESERVED"))
    assert (sm, reserved) == (228 * 1024, 1024)
    smem = [int(x) for x in re.search(
        r"constexpr int SMEM_BWD\[2\] = \{(\d+), (\d+)\};", src).groups()]
    table = re.search(r"total \(SMEM_BWD\) +([\d,]+) +([\d,]+)\n", src)
    assert [int(x.replace(",", "")) for x in table.groups()] == smem
    for bytes_ in smem:
        assert bytes_ <= 227 * 1024
        assert blocks * (bytes_ + reserved) <= sm


def test_taumol_shape_header_matches_pack_tables():
    """csrc/taumol.cuh's Shape tables, the descriptor words K2 and K5
    compile in, are what ``python -m rrtmg_lw_torch.ops.taumol_cuda``
    writes from pack_tables' descriptors: the BAND_SPECS words equal, the
    presence words' signs equal, every other word zero.  Both kernels
    include the header, and neither holds a Shape section of its own."""
    kt, static = jkt.load_ktables()[0], jkt.load_static()
    desc = taumol_cuda.pack_tables(kt, static)[1]
    csrc = os.path.join(REPO, "rrtmg_lw_torch", "csrc")
    assert taumol_cuda.SHAPE_SOURCE.name == "taumol.cuh"
    assert str(taumol_cuda.SHAPE_SOURCE.parent) == csrc
    with open(taumol_cuda.SHAPE_SOURCE) as f:
        assert taumol_cuda.source_shape_section(f.read()) == \
            taumol_cuda.shape_section(desc)
    for name in ("taumol.cu", "taumol_bwd.cu"):
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        assert '#include "taumol.cuh"' in text, name
        assert taumol_cuda.SHAPE_BEGIN not in text, name
        assert "struct Shape" not in text, name
    words = taumol_cuda.shape_words(desc)
    for name, i in zip(taumol_cuda.DESC_FIELDS, range(desc.shape[-1])):
        if name in taumol_cuda.SHAPE_WORDS:
            np.testing.assert_array_equal(words[..., i], desc[..., i])
        elif name in taumol_cuda.SHAPE_SIGNS:
            np.testing.assert_array_equal(words[..., i] < 0,
                                          desc[..., i] < 0)
        else:
            assert not words[..., i].any(), name
    # the words the kernel reads at run time vary with the tables only
    assert {"ABS_OFF", "NROW", "NA", "FRAC_OFF", "FRAC_NROW",
            "FRAC_REFRAT"}.isdisjoint(taumol_cuda.SHAPE_WORDS)


def test_taumol_tables_read_back_from_packed_layout():
    """Every table of pack_tables' flat buffer starts on TAB_ALIGN floats
    (K2 reads rows of ng floats 8 bytes at a time) and reads back
    equal to the plain engine's buffer of it; the descriptors point at
    them."""
    model = make_model(LWConfig(dtype="float32", use_lut=False),
                       device="cpu")
    kt, static = jkt.load_ktables()[0], jkt.load_static()
    flat, desc, offsets = taumol_cuda.pack_tables(kt, static)
    assert flat.dtype == np.float32
    assert all(off % taumol_cuda.TAB_ALIGN == 0 for off in offsets.values())
    chi = np.asarray(static["chi_mls"], np.float32)
    off = offsets["chi", "chi_mls"]
    np.testing.assert_array_equal(flat[off:off + chi.size], chi.ravel())
    eng = model.engine
    D = {n: i for i, n in enumerate(taumol_cuda.DESC_FIELDS)}
    for bspec in ttaumol.BAND_SPECS:
        bk = f"b{bspec.band:02d}"
        for name in [n for n in kt[bk] if n not in ("absa", "absb")] + \
                ["_abs"]:
            ref = getattr(eng, f"{bk}_{name}").numpy()
            off = offsets[bk, name]
            got = flat[off:off + ref.size].reshape(ref.shape)
            np.testing.assert_array_equal(got, ref, err_msg=f"{bk} {name}")
        for r, spec in enumerate((bspec.lower, bspec.upper)):
            d = desc[bspec.band - 1, r]
            if spec.zero:
                continue
            assert d[D["ABS_OFF"]] == offsets[bk, "_abs"]
            assert d[D["FRAC_OFF"]] == offsets[bk, spec.frac]
            if spec.postscale:
                ng = ttaumol.NG[bspec.band - 1]
                np.testing.assert_array_equal(
                    flat[d[D["POST_OFF"]]:d[D["POST_OFF"]] + ng],
                    ttaumol.postscale_vector(spec, ng).astype(np.float32))
    np.testing.assert_array_equal(model.kernel_tabs.numpy(), flat)


def test_config_impl_resolution():
    assert LWConfig().resolve_impl("cpu") == "eager"
    assert LWConfig(impl="eager").resolve_impl("cpu") == "eager"
    with pytest.raises(ValueError):
        LWConfig(impl="cuda").resolve_impl("cpu")
    with pytest.raises(ValueError):
        LWConfig(impl="pallas").resolve_impl("cpu")
    assert LWConfig(dtype="float32").torch_dtype == torch.float32
    with pytest.raises(ValueError):
        make_model(LWConfig(impl="cuda", use_lut=False), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(use_lut=True, idrv=1), dict(use_lut=True),
    dict(icld=1, imca=0, iceflag=1), dict(icld=2, imca=0, liqflag=0),
    dict(icld=3, imca=0, liqflag=0), dict(istart=16),
    dict(istart=16, icld=1)])
def test_unported_configs_raise(kw):
    cfg = dict(use_lut=False)
    cfg.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_model(LWConfig(**cfg), device="cpu")


@pytest.mark.parametrize("icld", [1, 2])
def test_mcica_inflag1_raises_value_error(icld):
    """Grey cloud optics (inflag=1) are not available with McICA, as in
    the JAX package (rrtmg_lw_cldprmc.f90:191); per-band clouds take it."""
    with pytest.raises(ValueError, match="INFLAG=1"):
        make_model(LWConfig(icld=icld, imca=1, inflag=1, use_lut=False),
                   device="cpu")
    make_model(LWConfig(icld=icld, imca=0, inflag=1, use_lut=False),
               device="cpu")


def test_k1_edge_cases_cover_what_they_promise():
    """utils.snapshot's K1 edge cases (chip_smoke.py, the snapshot and the
    cuda tests run K1 on them): every column kind, runs across the
    16-column tiles, the g-point od exactly 0.06 in float32 where forced
    (some of it at a per-g cloud fraction in (0, 0.5)), and each mode's
    plain sweep finite on them."""
    from rrtmg_lw_torch import Atmosphere
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.rtrn_cuda import WRAPPERS
    from rrtmg_lw_torch.ops.setcoef import interp_planck_blocked, setcoef
    from rrtmg_lw_torch.utils.snapshot import (EDGE_KINDS, force_od,
                                               k1_edge_args,
                                               make_edge_clouds)
    e = make_edge_clouds(40, 6)
    assert set(e["kind"].tolist()) == set(range(len(EDGE_KINDS)))
    starts = np.flatnonzero(np.diff(e["kind"])) + 1
    assert (starts % 16 != 0).any()
    overcast = e["kind"] == 1
    assert (e["mask"][:, :140, overcast] == 1).all()
    assert not e["cldf_g"][:, :, e["kind"] == 0].any()
    top_bottom = e["cldf_g"][:, :140, e["kind"] == 2] > 0
    assert top_bottom[[0, -1]].all() and not top_bottom[1:-1].any()

    secd = 1.5 + 0.3 * torch.rand(16, 40, generator=torch.Generator()
                                  .manual_seed(0))
    ngb0 = torch.arange(140, dtype=torch.int32) % 16
    taut = torch.rand(6, 140, 40, generator=torch.Generator().manual_seed(1))
    got, hit = force_od(taut, secd, ngb0, torch.ones_like(taut, dtype=bool),
                        0.06)
    od = secd[ngb0.long()] * got
    assert hit.float().mean() > 0.3
    assert (od[hit] == torch.tensor(0.06)).all()
    assert torch.equal(got[~hit], taut[~hit])

    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False), device="cpu")
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(40, 6), "cpu",
                                torch.float32)
    prof = inatm(atm, torch.float32)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    play, plev = (interp_planck_blocked(t.t().contiguous(), model.totplnk)
                  for t in (prof.tavel, prof.tz))
    args = (tg, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
            model.ngb0, model.wg)
    eargs, modes, low = k1_edge_args("cpu", static, args)
    assert low > 0 and set(modes) == {"clear", "compact", "banded",
                                      "maxrand", "fused", "cldf_od"}
    for name, (w, cl) in modes.items():
        out = rtrn.FLUXES[w](*eargs, *cl)
        assert out.shape == (4, 7, 40) and torch.isfinite(out).all(), name
        assert torch.equal(out, WRAPPERS[w](*eargs, *cl)), name


@pytest.mark.parametrize("held, want", [
    ([[1000, 2000, 3000, 4000, 5000]], 3.0),   # every launch
    ([[2000, 4000, 6000]], 4.0),               # 3 of 5: their mean
    ([[], [], [500]], 0.5),                    # none twice, then one
    ([[], [], []], None),                      # none three times: raises
    ([[1000] * 6], None),                      # more than one a call
])
def test_kernel_ms_averages_the_launches_a_trace_holds(monkeypatch, held,
                                                      want):
    """snapshot.kernel_ms (chip_smoke.py's device ms) on stand-in traces:
    the mean over the launches of ``symbol`` the trace holds, other
    kernels ignored, a trace with none taken again up to three times."""
    from rrtmg_lw_torch.utils import snapshot

    class Event:
        def __init__(self, name, us):
            self.name = name
            self.time_range = type("R", (), {"elapsed_us": lambda s: us})()

    traces = iter(held)

    class Profile:
        def __init__(self, activities):
            self.held = next(traces)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [Event("other_kernel", 7)] + [
                Event("_Z9rt_kernelILi1E", us) for us in self.held]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    if want is None:
        with pytest.raises(RuntimeError, match="launches of rt_kernel"):
            snapshot.kernel_ms(lambda: calls.append(1), "rt_kernel")
    else:
        assert snapshot.kernel_ms(lambda: calls.append(1),
                                  "rt_kernel") == want
    assert len(calls) == 1 + 5 * min(len(held), 3)


def test_ptxas_info_reads_each_instantiation(tmp_path):
    """_build.ptxas_info on ptxas -v lines: registers and spill stores
    per instantiation matched by its mangled name, other kernels' lines
    skipped."""
    log = """\
ptxas info    : Compiling entry function '_Z13rt_bwd_kernelILb1EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z13rt_bwd_kernelILb1EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12planck_kernelPKf' for 'sm_90a'
ptxas info    : Function properties for _Z12planck_kernelPKf
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 32 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13rt_bwd_kernelILb0EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z13rt_bwd_kernelILb0EEvPKf
    288 bytes stack frame, 288 bytes spill stores, 288 bytes spill loads
ptxas info    : Used 128 registers, 560 bytes cmem[0]
"""
    path = tmp_path / "build.log"
    path.write_text(log)
    got = _build.ptxas_info(path, r"rt_bwd_kernelILb([01])E",
                            lambda m: ("clear", "compact")[int(m.group(1))])
    assert got == {"compact": {"spill_bytes": 0, "registers": 127},
                   "clear": {"spill_bytes": 288, "registers": 128}}


def test_build_hash_covers_sources():
    names = {p.name for p in _build.sources()}
    assert {"planck.cu", "cldcoef.cu", "taumol.cu", "rtrn.cu",
            "taumol_bwd.cu", "rtrn_bwd.cu", "overlap.cu", "rrtm.cuh",
            "taumol.cuh", "rtrn.cuh", "spec.cuh", "rtrn_kernel.cuh",
            "rtrn_bf16.cu", "rtrn_f16.cu", "rtrn_logu16.cu",
            "probes.cu"} <= names
    assert _build.source_hash() == _build.source_hash()
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_cuda_wrappers_send_cpu_tensors_to_plain_versions(monkeypatch):
    from rrtmg_lw_torch import (Atmosphere, BandClouds, McicaCloudsBlocked,
                                McicaCloudsCompact)
    from rrtmg_lw_torch.ops import cldcoef_cuda, cldprop, planck_cuda, rtrn
    from rrtmg_lw_torch.ops import rtrn_cuda, rtrnmr, rtrnmr_cuda, setcoef
    from rrtmg_lw_torch.ops.inatm import inatm

    def no_kernels(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel library")
    monkeypatch.setattr(_build, "library", no_kernels)
    monkeypatch.setattr(_build, "launch", no_kernels)
    wrappers = (planck_cuda.planck_interp_blocked,
                cldcoef_cuda.ice_liq_coeffs_blocked,
                taumol_cuda.taumol_blocked, rtrnmr_cuda.overlap_rows,
                *rtrn_cuda.WRAPPERS.values(),
                *(w.idrv for w in rtrn_cuda.WRAPPERS.values()),
                rtrn_cuda.rt_fluxes_blocked.save, rtrn_cuda.rt_sweep_vjp)
    before = [w.launches for w in wrappers]

    B, L = 5, 9
    model = make_model(LWConfig(icld=2, use_lut=False), device="cpu")
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu")
    cl = McicaCloudsCompact.from_numpy(
        tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8), "cpu")
    prof = inatm(atm)
    static = model.static_tensors()
    sc = setcoef.setcoef(prof, static, planck=False)

    temp = prof.tz.t().contiguous()
    assert torch.equal(planck_cuda.planck_interp_blocked(temp, model.totplnk),
                       setcoef.interp_planck_blocked(temp, model.totplnk))
    got = cldcoef_cuda.ice_liq_coeffs_blocked(cl.reicmc, cl.relqmc, 3, 1,
                                              static)
    ref = cldprop.ice_liq_coeffs_blocked(cl.reicmc, cl.relqmc, 3, 1, static)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    bins = torch.empty((16, taumol_cuda.NBIN, L, B), dtype=torch.int32)
    tg, fr = taumol_cuda.taumol_blocked(sc, prof, model.engine,
                                        model.kernel_tabs, model.kernel_desc,
                                        bins=bins)
    tg_p, fr_p = model.engine.blocked(sc, prof)
    assert torch.equal(tg, tg_p) and torch.equal(fr, fr_p)
    assert torch.equal(bins, model.engine.bins(sc, prof))
    play = setcoef.interp_planck_blocked(prof.tavel.t().contiguous(),
                                         model.totplnk)
    plev = setcoef.interp_planck_blocked(temp, model.totplnk)
    cw = torch.stack([cl.ciwp.t(), cl.clwp.t()], 1).contiguous()
    blk = McicaCloudsBlocked.from_numpy(
        tsyn.make_mcica_clouds(B, L, layout="blocked"), "cpu")
    tauc, cldf, _ = cldprop.cldprmc_blocked(blk, static, inflag=2,
                                            iceflag=3, liqflag=1)
    args = (tg, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
            model.ngb0, model.wg)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            a if isinstance(a, tuple) else (a,),
            b if isinstance(b, tuple) else (b,)))
    for mode, fields in (("blocked", None), ("blocked", (cl.cldfmc, cw, *ref)),
                         ("fused", (*blk[:4], *ref)),
                         ("cldf_od", (cldf, tauc))):
        for dpl in (None, sc.dplankbnd_dt):
            got = rtrn_cuda.WRAPPERS[mode](*args, fields, dplankbnd_dt=dpl)
            want = rtrn.FLUXES[mode](*args, fields, dplankbnd_dt=dpl)
            assert isinstance(got, tuple) == (dpl is not None)
            assert same(got, want), (mode, dpl is None)
    # K1 keeping the radiances, and K6 (which reads them on the card only)
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm, tg.dtype)
    for cf in ((None,) * 4, (cw, *ref, cl.cldfmc)):
        a = (tg, fr, play, plev, surf, *cf, model.ngb0, model.wg)
        fields = None if cf[3] is None else (cf[3], *cf[:3])
        assert same(rtrn_cuda.rt_sweep_radiances(*a),
                    rtrn.rt_sweep_blocked(*a[:5], model.ngb0, model.wg,
                                          fields, radiances=True))
        ct = torch.ones((4, L + 1, B), dtype=tg.dtype)
        got = rtrn_cuda.rt_sweep_vjp(*a, ct)
        assert all(g is None and r is None or torch.equal(g, r)
                   for g, r in zip(got, rtrn.rt_sweep_vjp(*a, ct)))
    bc = BandClouds.from_numpy(tsyn.make_band_clouds(B, L), "cpu")
    rows = rtrnmr_cuda.overlap_rows(bc.cldfrac)
    assert torch.equal(rows, rtrnmr.overlap_rows(bc.cldfrac))
    taucb, _ = cldprop.cldprop_banded_blocked(
        bc, static, inflag=2, iceflag=3, liqflag=1,
        coeffs=cldcoef_cuda.ice_liq_coeffs_blocked)
    args = (tg, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
            model.ngb0, model.wg)
    for kern, plain, cld in (
            (rtrn_cuda.rt_fluxes_banded, rtrn.rt_fluxes_banded,
             bc.cldfrac.t().contiguous()),
            (rtrn_cuda.rt_fluxes_maxrand, rtrn.rt_fluxes_maxrand, rows)):
        assert torch.equal(kern(*args, cld, taucb), plain(*args, cld, taucb))
        assert same(kern(*args, cld, taucb, dplankbnd_dt=sc.dplankbnd_dt),
                    plain(*args, cld, taucb, dplankbnd_dt=sc.dplankbnd_dt))
    assert [w.launches for w in wrappers] == before


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device the entry points take the CUDA device; where
    there is none they raise and never carry on on the CPU."""
    from rrtmg_lw_torch import Atmosphere, BandClouds, McicaCloudsCompact
    from rrtmg_lw_torch.config import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model(LWConfig(use_lut=False))
    for cls, arrays in ((Atmosphere, tsyn.make_atmosphere(2, 3)),
                        (McicaCloudsCompact, tsyn.make_mcica_clouds(2, 3)),
                        (BandClouds, tsyn.make_band_clouds(2, 3))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls.from_numpy(arrays)
        assert cls.from_numpy(arrays, "cpu")[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkt.load_tables()
    kt, _ = tkt.load_ktables()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkt.tables_from_numpy(kt, tkt.load_static())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cloud_types_must_match_imca():
    from rrtmg_lw_torch import Atmosphere, BandClouds, McicaCloudsCompact
    B, L = 2, 5
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu")
    band = BandClouds.from_numpy(tsyn.make_band_clouds(B, L), "cpu")
    mcica = McicaCloudsCompact.from_numpy(
        tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8), "cpu")
    with pytest.raises(TypeError):
        make_model(LWConfig(icld=2, imca=0, use_lut=False),
                   device="cpu")(atm, mcica)
    with pytest.raises(TypeError):
        make_model(LWConfig(icld=2, imca=1, use_lut=False),
                   device="cpu")(atm, band)


def test_spec_codes_and_constants_match_cuda_source():
    """The storage argument of the kernels is spec.cuh's enum Spec, and
    its float32 constants are the codec's, rounded as JAX rounds them."""
    import jax.numpy as jnp
    from rrtmg_lw_tpu.ops import taumol_pallas as jtp
    from rrtmg_lw_torch.ops import spec_codec
    src = open(os.path.join(REPO, "rrtmg_lw_torch", "csrc",
                            "spec.cuh")).read()
    names = [t.split("=")[0].strip() for t in _c_enum(src, "Spec")]
    values = [int(t.split("=")[1]) for t in _c_enum(src, "Spec")]
    assert names == ["SPEC_F32", "SPEC_BF16", "SPEC_F16", "SPEC_LOGU16"]
    assert values == [spec_codec.SPEC_CODES[d] for d in (
        torch.float32, torch.bfloat16, torch.float16, torch.uint16)]

    def cuda_const(name):
        lit = re.search(r"constexpr float " + name + r" = (\S+)f;",
                        src).group(1)
        return np.float32(float.fromhex(lit))
    assert spec_codec.SPEC_LOG_LO == jtp.SPEC_LOG_LO
    assert spec_codec._SPEC_LOG_SCALE == jtp._SPEC_LOG_SCALE
    for name, value in (("SPEC_LOG_LO", jtp.SPEC_LOG_LO),
                        ("SPEC_LOG_SCALE", jtp._SPEC_LOG_SCALE),
                        ("SPEC_INV_SCALE", 1.0 / jtp._SPEC_LOG_SCALE),
                        ("SPEC_INV_FRAC", 1.0 / 65535.0),
                        ("SPEC_FLOOR", 1e-9)):
        want = np.asarray(jnp.asarray(value, jnp.float32))
        assert cuda_const(name) == want, name


@pytest.mark.parametrize("spec", ["bf16", "f16", "logu16"])
def test_cuda_wrappers_plain_route_in_storage(monkeypatch, spec):
    """On CPU tensors the wrappers run the plain versions in reduced
    storage too: K2's store as spec_store of the plain K2, K1 as the
    decode + aerosol add + plain sweep; no kernel is reached, no launch
    counted."""
    from rrtmg_lw_torch import Atmosphere, McicaCloudsCompact
    from rrtmg_lw_torch.ops import rtrn, rtrn_cuda, setcoef, spec_codec
    from rrtmg_lw_torch.ops.inatm import inatm

    def no_kernels(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel library")
    monkeypatch.setattr(_build, "library", no_kernels)
    monkeypatch.setattr(_build, "launch", no_kernels)
    sdt = spec_codec.SPEC_DTYPES[spec]
    B, L = 4, 7
    model = make_model(LWConfig(icld=2, dtype="float32", use_lut=False),
                       device="cpu")
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L, dtype=np.float32),
                                "cpu", torch.float32)
    cl = McicaCloudsCompact.from_numpy(tsyn.make_mcica_clouds(
        B, L, dtype=np.float32, mask_dtype=np.int8), "cpu", torch.float32)
    prof = inatm(atm, torch.float32)
    sc = setcoef.setcoef(prof, model.static_tensors(), planck=False)
    counters = (taumol_cuda.taumol_blocked, taumol_cuda.taumol_blocked.spec,
                *rtrn_cuda.WRAPPERS.values(),
                *(w.spec for w in rtrn_cuda.WRAPPERS.values()))
    before = [c.launches for c in counters]
    tg, fr = taumol_cuda.taumol_blocked(sc, prof, model.engine,
                                        model.kernel_tabs, model.kernel_desc,
                                        spec_dtype=sdt)
    tg_p, fr_p = model.engine.blocked(sc, prof)
    assert tg.dtype == fr.dtype == sdt
    assert torch.equal(tg.view(torch.int16), spec_codec.spec_store(
        tg_p, sdt, "tg").view(torch.int16))
    assert torch.equal(fr.view(torch.int16), spec_codec.spec_store(
        fr_p, sdt, "fr").view(torch.int16))
    taua = prof.taua.permute(1, 2, 0).contiguous()
    play = setcoef.interp_planck_blocked(prof.tavel.t().contiguous(),
                                         model.totplnk)
    plev = setcoef.interp_planck_blocked(prof.tz.t().contiguous(),
                                         model.totplnk)
    rest = (play, plev, sc.plankbnd, prof.semiss, prof.pwvcm, model.ngb0,
            model.wg)
    got = rtrn_cuda.rt_fluxes_blocked(tg, fr, *rest, taua_t=taua)
    taut = spec_codec.spec_load_taut(tg) + taua[:, model.ngb0.long()]
    want = rtrn.rt_fluxes_blocked(taut, spec_codec.spec_load_frac(fr),
                                  *rest)
    assert torch.equal(got, want)
    assert [c.launches for c in counters] == before
