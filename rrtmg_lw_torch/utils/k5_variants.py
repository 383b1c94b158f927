"""K5 (csrc/taumol_bwd.cu) and variant copies of it against a parent
checkout's K5, on the card: bitwise equality and device times in turns
(``utils/variants.py``, which says how; its ptxas comparison of the two
package builds is where K2's lines are held to the parent's).

    python -m rrtmg_lw_torch.utils.k5_variants --parent build/base \\
        [--variants NAME ...] [--out times.json]

The cases: phase 3's inputs (``snapshot.k5_inputs``: B=16384, L=60),
the deep cell's (L=140), the boosted profile (``snapshot.K5_BOOST``)
and K2's edge inputs (``snapshot.k2_edge_args`` at every
``K2_EDGE_SHAPES``), with seeded cotangents; L=60 and L=140 are timed.
The ``prof`` variant's clock sums (``rrtm_k5_dbg``, each warp's lane 0:
per term of the bands taken a term at a time, its setup, loops and
chain-back, the key species' with the fraction's row; bands 1-2 whole)
are printed as shares.
"""

from __future__ import annotations

import sys

import torch

from rrtmg_lw_torch.utils import variants

PHASES = ("key", "continuum", "minors", "CFCs", "fraction",
          "bands 1-2")

# Variants of this commit's K5: (old, new) replacements in
# csrc/taumol_bwd.cu, and nvcc flags in place of the package's
# -fmad=false; a replacement that no longer applies raises.
_SIFLD = ("    __shared__ short sifld[NI * TB];"
          "           // (NI, TB) int inputs\n")
VARIANTS = {
    # the 32 descriptors staged in shared memory too (8,960 B more a
    # block), 4 blocks per SM
    "mb4": ([
        ("constexpr int MIN_BLOCKS = 5;", "constexpr int MIN_BLOCKS = 4;"),
        ("constexpr int VW = 2;           // floats a row load\n",
         "constexpr int VW = 2;           // floats a row load\n"
         "constexpr int NDESC_ALL = rrtm::NBAND * 2 * NDESC;\n"),
        (_SIFLD, _SIFLD + "    __shared__ int sdesc[NDESC_ALL];\n"),
        ("    for (int i = c; i < (NF + NI) * TB; i += THREADS) {",
         "    for (int i = c; i < NDESC_ALL; i += THREADS)"
         " sdesc[i] = desc[i];\n"
         "    for (int i = c; i < (NF + NI) * TB; i += THREADS) {"),
        ("    bands_from_bwd<0>(sifld[I_LAYTROP * TB + c] != 0, desc,",
         "    bands_from_bwd<0>(sifld[I_LAYTROP * TB + c] != 0, sdesc,"),
    ], None),
    # the int inputs in registers, 6 blocks per SM (37,888 B of shared
    # memory a block, 80 registers a thread)
    "mb6": ([
        ("constexpr int MIN_BLOCKS = 5;", "constexpr int MIN_BLOCKS = 6;"),
        (_SIFLD, ""),
        ("for (int i = c; i < (NF + NI) * TB; i += THREADS) {",
         "for (int i = c; i < NF * TB; i += THREADS) {"),
        ("        else sifld[i - NF * TB] = "
         "(short)ifld[(f - NF) * LB + cell0 + k];\n",
         ""),
        ("        if (f < NF) sfld[i] = fld[f * LB + cell0 + k];",
         "        sfld[i] = fld[f * LB + cell0 + k];"),
        ("    bands_from_bwd<0>(sifld[I_LAYTROP * TB + c] != 0, desc,"
         " sfld + c,\n"
         "                      sifld + c, T,",
         """    int ireg[NI];
#pragma unroll
    for (int f = 0; f < NI; ++f) ireg[f] = ifld[f * LB + cell0 + c];
    bands_from_bwd<0>(ireg[I_LAYTROP] != 0, desc, sfld + c, ireg, T,"""),
        ("const float* fin,\n" + " " * 46 + "const short* iin,",
         "const float* fin,\n" + " " * 46 + "const int* iin,"),
        ("const float* fin,\n" + " " * 47 + "const short* iin,",
         "const float* fin,\n" + " " * 47 + "const int* iin,"),
        ("    auto I = [&](int f) { return (int)iin[f * TB]; };",
         "    auto I = [&](int f) { return iin[f]; };"),
    ], None),
    # FMA contraction allowed (not bitwise: for the record only)
    "fma": ([], ("-fmad=true",)),
    # per-term clock sums of every warp's lane 0 (PHASES), read back by
    # rrtm_k5_dbg (instrumented: its times are not the kernel's)
    "prof": ([
        ("constexpr int MIN_BLOCKS = 5;",
         "__device__ unsigned long long k5_dbg[6];\n"
         "constexpr int MIN_BLOCKS = 5;"),
        ("        float s_corr = 0.0f;\n",
         "        const long long k5c = clock64();\n"
         "        float s_corr = 0.0f;\n"),
        ("""        if constexpr (FRAC_ETA) frac_back();
    } else {""", """        if constexpr (FRAC_ETA) frac_back();
        if ((threadIdx.x & 31) == 0)
            atomicAdd(&k5_dbg[5], (unsigned long long)(clock64() - k5c));
    } else {"""),
        ("        float ct[VW], u[VW], tau[VW] = {0.0f, 0.0f}, acc_r[VW];\n",
         """        float ct[VW], u[VW], tau[VW] = {0.0f, 0.0f}, acc_r[VW];
        long long k5t = clock64();
        auto tick = [&](int ph) {
            const long long now = clock64();
            if ((threadIdx.x & 31) == 0)
                atomicAdd(&k5_dbg[ph], (unsigned long long)(now - k5t));
            k5t = now;
        };
"""),
        ("            key_back();\n",
         "            key_back();\n            tick(0);\n"),
        ("            cont_back();\n",
         "            cont_back();\n            tick(1);\n"),
        ("            minor_back();\n",
         "            minor_back();\n            tick(2);\n"),
        ("            cfc_back();\n",
         "            cfc_back();\n            tick(3);\n"),
        ("            frac_back();\n",
         "            frac_back();\n            tick(4);\n"),
        ("""RRTM_API int rrtm_taumol_bwd_info(int* out) {""",
         """RRTM_API int rrtm_k5_dbg(unsigned long long* out, int reset) {
    if (reset) {
        unsigned long long z[6] = {};
        return (int)cudaMemcpyToSymbol(k5_dbg, z, sizeof(z));
    }
    return (int)cudaMemcpyFromSymbol(out, k5_dbg, sizeof(k5_dbg));
}

RRTM_API int rrtm_taumol_bwd_info(int* out) {"""),
    ], None),
}


def run(lib, case):
    """K5 of ``lib`` on a case (model, packed fields, cotangents):
    [ct_fld]."""
    model, fld, ifld, cts = case
    out = torch.empty_like(fld)
    _, L, B = fld.shape
    ptrs = [t.data_ptr() for t in (fld, ifld, model.kernel_tabs,
                                   model.kernel_desc, *cts, out)]
    err = lib.rrtm_taumol_bwd(*ptrs, L, B,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rrtm_taumol_bwd: error {err}")
    return [out]


def package(case):
    """The package's K5 (``taumol_vjp``) on a case, as ``run``."""
    from rrtmg_lw_torch.ops.taumol_cuda import taumol_vjp
    model, fld, ifld, cts = case
    return [taumol_vjp(fld, ifld, model.engine, model.kernel_tabs,
                       model.kernel_desc, *cts)]


def info(lib):
    """K5's launch configuration in ``lib`` (``taumol_cuda.K2_INFO``), or
    None (a parent's has none)."""
    from rrtmg_lw_torch.ops.taumol_cuda import K2_INFO
    return variants.lib_info(lib, "rrtm_taumol_bwd_info", K2_INFO)


def cases(device):
    """[(tag, (model, fld, ifld, cotangents))]: phase 3's inputs, the
    deep cell's, the boosted profile and K2's edge inputs."""
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.utils import snapshot
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False), device=device)
    out = []
    for tag, f in (("L=60", snapshot.k5_inputs(device, model)),
                   ("L=140", snapshot.k5_inputs(device, model,
                                                "mcica_cloudy_deep")),
                   ("boost", snapshot.k5_inputs(device, model,
                                                boost=snapshot.K5_BOOST))):
        out.append((tag, (model, *f, snapshot.k5_cotangents(f[0]))))
    for B, L in snapshot.K2_EDGE_SHAPES:
        f = snapshot.k2_edge_args(device, model, B, L)[:2]
        out.append((f"edge {B}x{L}",
                    (model, *f, snapshot.k5_cotangents(f[0]))))
    return out


KERNEL = variants.Kernel(
    module="k5_variants", source="taumol_bwd.cu", variants=VARIANTS,
    cases=cases, run=run, package=package, info=info, dbg="rrtm_k5_dbg",
    phases=PHASES)


if __name__ == "__main__":
    sys.exit(variants.main(KERNEL, doc=__doc__))


