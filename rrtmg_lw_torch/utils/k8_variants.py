"""K8, the McICA sampler (csrc/mcica.cu), and variant copies of it against
a parent checkout's, on the card: bitwise equality and device times in
turns (``utils/variants.py``, which says how), and the SASS instructions a
cell of each library's drawing walk.

    python -m rrtmg_lw_torch.utils.k8_variants --parent build/base \\
        [--variants NAME ...] [--out times.json]

The cases: the generate-then-radiate cells' cloud profiles
(``profiling.cloud_profile``, B=16384, float32 in, int8 mask): icld 2 and
4 at L=60, icld 2 at L=140, icld 1 and 3, and float64 icld 2, all timed;
then icld 1-5 in float32 and float64, int8 and float masks, drawing and
on given uniforms, at B=2048 (vector stores) and B=2051 (element stores),
L=61, on cloud fractions with zeros, ones and values below CLDMIN.  Each
case's mask is allocated in ``run``, as the package's wrapper does.

The SASS counts (``info``): ``cuobjdump -sass`` of each library (kept
beside it, ``<library>.sass``); in each drawing instantiation of the int8
mask (vector stores where the library has the store path), the loop of
the walk (the smallest loop whose body holds nearly all the Philox multiplies;
icld 3: the smallest one holding a store) and its instructions by opcode
over the mask cells it stores.  Where the loop also holds the path of a
ragged last Philox block, its count is static, not the executed one: the
``full`` variant has no such path.
"""

from __future__ import annotations

import collections
import pathlib
import re
import subprocess
import sys

import torch

from rrtmg_lw_torch.utils import variants

# Variants of this commit's K8: (old, new) replacements in csrc/mcica.cu,
# with the package's nvcc flags; a replacement that no longer applies
# raises.
VARIANTS = {
    # element stores everywhere: what the whole-line stores buy
    "scalar": ([("const bool vec = B % 4 == 0 &&",
                 "const bool vec = false && B % 4 == 0 &&")], None),
    # no path for a last Philox block of fewer than PER layers (its layers
    # left unwritten: right only where L is a multiple of PER): the walk
    # loop's SASS is the executed one, for the counts
    "full": ([("""#pragma unroll
                    for (int jj = 0; jj < PER; ++jj)
                        if (lb + jj < l1) layer(wu, wv, jj, lb + jj);""",
               "")], None),
    # icld 1 stores the Philox words' sign bits in place of the compare
    # (not the mask): the draw and the stores alone
    "philox_only": ([("sw[j] = D::diff(wu[j][jj], th[j]);",
                      "sw[j] = (int)wu[j][jj];")], None),
    # two or four blocks an SM in the launch bounds (registers 128, 64);
    # icld 4/5 at three (80 registers: its walk spills)
    "minb2": ([("constexpr int MC_MIN_BLOCKS = 3;",
                "constexpr int MC_MIN_BLOCKS = 2;")], None),
    "minb4": ([("constexpr int MC_MIN_BLOCKS = 3;",
                "constexpr int MC_MIN_BLOCKS = 4;")], None),
    "minb3_2s": ([("constexpr int MC_MIN_BLOCKS_2S = 2;",
                   "constexpr int MC_MIN_BLOCKS_2S = 3;")], None),
    # fewer g-rows a warp (3 or 1 in place of 6): more blocks (768, 2304 at
    # B=16384), the staging shared by fewer g-rows
    "rounds3": ([("constexpr int MC_ROUNDS = 6;",
                  "constexpr int MC_ROUNDS = 3;")], None),
    "rounds1": ([("constexpr int MC_ROUNDS = 6;",
                  "constexpr int MC_ROUNDS = 1;")], None),
    # two Philox blocks an iteration: the next block's draws beside this
    # block's walk
    "unroll2": ([("            for (int lb = l0; lb < l1; lb += PER) {",
                  "#pragma unroll 2\n"
                  "            for (int lb = l0; lb < l1; lb += PER) {")],
                None),
    # icld 2's sign word by one PTX set (-1 where cdf < thr or unordered)
    # in place of a compare and a select
    "fset": ([("// four staged values of a lane, one or two vector loads",
               "__device__ __forceinline__ int below(float a, float b) {\n"
               "    int d;\n"
               "    asm(\"set.ltu.s32.f32 %0, %1, %2;\" : \"=r\"(d) : \"f\"(a),"
               " \"f\"(b));\n"
               "    return d;\n}\n"
               "__device__ __forceinline__ int below(double a, double b) {\n"
               "    int d;\n"
               "    asm(\"set.ltu.s32.f64 %0, %1, %2;\" : \"=r\"(d) : \"d\"(a),"
               " \"d\"(b));\n"
               "    return d;\n}\n\n"
               "// four staged values of a lane, one or two vector loads"),
              ("""                        sw[j] = cdf >= th[j] ? 0 : -1;
                        prev[j] = cdf;
                        tb[j] = th[j];""",
               """                        sw[j] = below(cdf, th[j]);
                        prev[j] = cdf;
                        tb[j] = th[j];""")], None),
}

NCOL = 16384
# the timed cases: (icld, layers, input type)
TIMED = ((2, 60, torch.float32), (4, 60, torch.float32),
         (2, 140, torch.float32), (1, 60, torch.float32),
         (3, 60, torch.float32), (2, 60, torch.float64))


def _fields(B, L, dtype, device, seed):
    """Cloud fractions with zeros, ones and values below CLDMIN, and
    alphas with zeros and ones."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = torch.rand((B, L), generator=gen, device=device, dtype=dtype)
    cf = torch.rand((B, L), generator=gen, device=device, dtype=dtype)
    cf = torch.where(r < 0.3, 0.0, torch.where(r > 0.9, 1.0, cf))
    cf = torch.where((r > 0.45) & (r < 0.5), 1e-25, cf)
    al = torch.rand((B, L), generator=gen, device=device, dtype=dtype)
    al = torch.where(r < 0.1, 0.0, torch.where(r > 0.95, 1.0, al))
    return cf, al


def cases(device):
    """[(tag, case)], case = (key, icld, cldfrac, alpha, mask dtype, g_pad,
    given uniforms or None)."""
    from rrtmg_lw_torch.ops import mcica
    from rrtmg_lw_torch.types import Atmosphere
    from rrtmg_lw_torch.utils.profiling import cloud_profile
    from rrtmg_lw_torch.utils.synthetic import make_atmosphere
    out = []
    for icld, L, dt in TIMED:
        atm = Atmosphere.from_numpy(make_atmosphere(NCOL, L), device, dt)
        f = cloud_profile(atm, icld, device)
        cf = f["cldfrac"].to(dt)
        al = None if f["alpha"] is None else f["alpha"].to(dt)
        name = "f64 " if dt == torch.float64 else ""
        out.append((f"{name}icld {icld} L={L}",
                    (mcica.key(0), icld, cf, al, torch.int8, 144, None)))
    gen = torch.Generator(device=device).manual_seed(1)
    L = 61
    for B in (2048, 2051):
        for dt in (torch.float32, torch.float64):
            cf, al = _fields(B, L, dt, device, B)
            u, u2 = (torch.rand((L, 140, B), generator=gen, device=device,
                                dtype=dt) for _ in range(2))
            for icld in (1, 2, 3, 4, 5):
                alpha = al if icld in (4, 5) else None
                for mdt in (torch.int8, dt):
                    for given in (None, (u, u2)):
                        out.append((
                            f"B={B} {dt} icld {icld} -> {mdt}"
                            f"{' given' if given else ''}",
                            (mcica.fold_in(mcica.key(B), icld), icld, cf,
                             alpha, mdt, 144, given)))
    return out


def run(lib, case):
    """``lib``'s K8 on a case: [the mask]."""
    k, icld, cf, alpha, mdt, g_pad, given = case
    B, L = cf.shape
    mask = torch.empty((L, g_pad, B), dtype=mdt, device=cf.device)
    u, u2 = given if given is not None else (None, None)
    if given is not None:
        k = (0, 0)
        u2 = u2 if icld in (4, 5) else None

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = lib.rrtm_mcica(ptr(cf), ptr(alpha), ptr(u), ptr(u2), mask.data_ptr(),
                         k[0], k[1], icld, int(cf.dtype == torch.float64),
                         int(mdt == torch.int8), L, B, g_pad,
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rrtm_mcica: error {err}")
    return [mask]


def package(case):
    """The package's K8 on a case, as ``run``."""
    from rrtmg_lw_torch.ops.mcica_cuda import subcol_mask
    k, icld, cf, alpha, mdt, g_pad, given = case
    return [subcol_mask(k, icld, cf, alpha, g_pad, mdt, uniforms=given)]


# a store's bytes by the suffix of STG
_STG_BYTES = {"U8": 1, "S8": 1, "U16": 2, "S16": 2, "64": 8, "128": 16}


def sass_loops(text):
    """[(function name, [(address, opcode, operands)])] of cuobjdump -sass
    output."""
    funcs = []
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        ins = []
        for addr, body in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                     part):
            tok = body.split()
            if tok and tok[0].startswith("@"):
                tok = tok[1:]
            if tok:
                ins.append((int(addr, 16), tok[0], " ".join(tok[1:])))
        funcs.append((name, ins))
    return funcs


def walk_counts(ins, ovl):
    """The walk's loop in one instantiation: {instructions, cells, per
    cell, opcodes (the 12 most frequent)}, or None."""
    loops = []
    for addr, op, args in ins:
        m = re.match(r"(0x[0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            body = [i for i in ins if int(m.group(1), 16) <= i[0] <= addr]
            loops.append(body)
    if not loops:
        return None

    def muls(body):
        return sum(op.startswith("IMAD.WIDE") or op.startswith("IMAD.HI")
                   for _, op, _ in body)

    def stores(body):
        return [op for _, op, _ in body if op.startswith("STG")]
    if ovl == 3:
        body = min((b for b in loops if stores(b)), key=len, default=None)
    else:
        # the innermost loop holding (nearly) all the Philox multiplies
        most = max(muls(b) for b in loops)
        body = min((b for b in loops if muls(b) >= 0.9 * most), key=len)
    if body is None:
        return None
    cells = sum(_STG_BYTES.get(op.split(".")[-1], 4) for op in stores(body))
    ops = collections.Counter(op for _, op, _ in body)
    return dict(instructions=len(body), cells=cells,
                per_cell=round(len(body) / max(cells, 1), 2),
                opcodes=dict(ops.most_common(12)))


def info(lib):
    """SASS instructions a cell of ``lib``'s drawing walks (float32 and
    float64 in, int8 mask, icld 1-4; the vector-store instantiation where
    the library has one)."""
    from rrtmg_lw_torch import _build
    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", lib._name],
                         capture_output=True, text=True)
    if res.returncode:
        return {"cuobjdump": res.stderr[-300:]}
    pathlib.Path(lib._name + ".sass").write_text(res.stdout)
    out = {}
    for name, ins in sass_loops(res.stdout):
        m = re.search(r"mcica_kernelI(f|d)aLi(\d)ELb0E(?:Lb([01])E)?", name)
        if not m or m.group(3) == "0":
            continue
        tag = f"{'f32' if m.group(1) == 'f' else 'f64'} ovl{m.group(2)}"
        out[tag] = walk_counts(ins, int(m.group(2)))
    return out


KERNEL = variants.Kernel(
    module="k8_variants", source="mcica.cu", variants=VARIANTS,
    cases=cases, run=run, package=package, info=info, ntimed=len(TIMED))


if __name__ == "__main__":
    sys.exit(variants.main(KERNEL, doc=__doc__))
