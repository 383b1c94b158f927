"""K1 keeping the state K6 reads (csrc/rtrn_kernel.cuh, SAVE) and variant
copies of it against a parent checkout's, on the card: device ms of the
gradient step's K1 launch in every mode, in turns.

    python -m rrtmg_lw_torch.utils.k1save_variants --parent build/base \\
        [--variants NAME ...] [--out times.json]

A variant is this checkout's package with text replacements in
``csrc/rtrn_kernel.cuh`` (``VARIANTS``), written under
``build/k1save_variants/<name>/``.  The parent's package, this
checkout's and each variant's build at once, a process each (K1's
instantiations compile in every one of them, so a call takes the
package builds' ~2-5 min).  Each package is then timed in a process of
its own (``--time``, this file run by path with that package first on
``PYTHONPATH``): the profiler's device ms of ``rt_kernel`` in the K1
launch that keeps the state (``snapshot.kernel_ms``, the mean of 5
launches after one), every mode at idrv 0, on the inputs of
``snapshot.py --k6-times`` (phase 3's cells at L=60; the
mcica_cloudy_deep cell's atmosphere with ``snapshot.g_cloud_args``'
clouds at L=140, B=16384), in turns: parent, this, the variants, then
the same reversed.  The times are printed and written to ``--out``
with the card's name and power limit.  Variants that change what K1
writes (``nostore``) are timings only: hold a kept design bitwise with
``snapshot.py --compare``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys

import torch

KERNEL = "rrtmg_lw_torch/csrc/rtrn_kernel.cuh"

# name -> [(old, new)] replacements in this commit's rtrn_kernel.cuh; a
# replacement that no longer applies raises
VARIANTS = {
    # the elected thread stages taut and fracs by bulk loads at the end
    # of its g-loop, not at the step's start (the slot's mbarrier armed
    # there): its wait on the stores' shared-memory reads moves a step's
    # compute later, and the rows' lead shrinks by up to a step
    "defer": [
        ("""            if (tid == ELECT) {
                uint64_t* mb = &bar[j % RING];
                mbar_arrive_expect_tx(mb, 2 * KG * KX * 4);
                bulk_wait_all<true>();
                tma_load_2d(s + Sl::TAU, &kept.taut, bt, l * KG, mb);
                tma_load_2d(s + Sl::FR, &kept.fracs, bt, l * KG, mb);
            }""", """            if (tid == ELECT)
                mbar_arrive_expect_tx(&bar[j % RING], 2 * KG * KX * 4);"""),
        ("""    auto slot = [&](int j) -> unsigned char* {""",
         """    auto load_spec = [&](int j) {
        if constexpr (BULK) {
            if (tid != ELECT) return;
            const bool up = j >= L;
            const int l = up ? j - L : L - 1 - j;
            unsigned char* s = smem + (j % RING) * Lo::SLOT;
            uint64_t* mb = &bar[j % RING];
            bulk_wait_all<true>();
            tma_load_2d(s + Sl::TAU, &kept.taut, bt, l * KG, mb);
            tma_load_2d(s + Sl::FR, &kept.fracs, bt, l * KG, mb);
        }
    };
    auto slot = [&](int j) -> unsigned char* {"""),
        ("""        for (int j = j0; j < j0 + RING - 1 && j < j0 + n; ++j) stage_step(j);""",
         """        for (int j = j0; j < j0 + RING - 1 && j < j0 + n; ++j) {
            stage_step(j);
            load_spec(j);
        }"""),
        ("""            put_part(j, sacc);
            if (j + 1 < j0 + L) {""",
         """            if (j + RING - 1 < j0 + L) load_spec(j + RING - 1);
            put_part(j, sacc);
            if (j + 1 < j0 + L) {"""),
    ],
    # the bulk stores dropped (rads left unwritten): what the rest of the
    # bulk path costs, the loads by TMA, the shared-memory writes and
    # fences included
    "nostore": [
        ("""            tma_store_2d(&kept.rads, s + Sl::TAU, bt, y, pol);
            if constexpr (MODE != CLEAR)
                tma_store_2d(&kept.rads, s + Sl::FR, bt, y + 2 * L * KG, pol);""",
         """            (void)pol; (void)y; (void)s;"""),
    ],
    # the stores with the L2's evict-first policy (K6 reads the radiances
    # back only after K5 and K3b, far past the 50 MB L2)
    "evict": [
        ("""            const uint64_t pol = l2_policy(false);""",
         """            const uint64_t pol = l2_policy(true);"""),
    ],
}


def times(out):
    """``--time``: device ms of K1 keeping the state in every mode at
    L=60 and L=140 through the package first on the path, into ``out``
    (JSON rows {mode, nlay, k1_save_ms})."""
    from rrtmg_lw_torch.ops import rtrn, rtrn_cuda, rtrnmr
    from rrtmg_lw_torch.utils import snapshot as sn
    dev = torch.device("cuda", 0)
    rows = []
    for cell in ("mcica_cloudy", "mcica_cloudy_deep"):
        x = sn.sweep_inputs(dev, cell)
        a, st = x["args"], x["static"]
        L = a[0].shape[0]
        xs = (*a[:4], rtrn.surf_rows(*a[4:7], torch.float32))
        if cell == "mcica_cloudy":
            modes = {m: tuple(c) for m, (_, c)
                     in sn.k1_cloud_args(dev, st, x["mc"]).items()}
        else:
            g = sn.g_cloud_args(dev, st, L)
            modes = {"clear": (),
                     "compact": (sn.compact_args(st, x["mc"]),),
                     "banded": g["banded"],
                     "maxrand": (rtrnmr.overlap_rows(
                         g["banded"][0].t().contiguous()), g["banded"][1]),
                     "fused": (g["fused"],), "cldf_od": (g["cldf_od"],)}
        for mode, cl in modes.items():
            if mode in ("clear", "compact"):
                cf = (None,) * 4 if not cl else (*cl[0][1:], cl[0][0])

                def fn():
                    rtrn_cuda.rt_sweep_radiances(*xs, *cf, a[7], a[8])
            elif mode == "maxrand":
                def fn():
                    rtrn_cuda.rt_sweep_maxrand_radiances(*xs, *cl, a[7],
                                                         a[8])
            else:
                c = tuple(cl) if mode == "banded" else tuple(cl[0])

                def fn():
                    rtrn_cuda.rt_sweep_g_radiances(mode, *xs, c, a[7], a[8])
            rows.append(dict(mode=mode, nlay=L, k1_save_ms=sn.kernel_ms(
                fn, "rt_kernel", 5)))
            print(rows[-1], flush=True)
        del x, modes
        torch.cuda.empty_cache()
    pathlib.Path(out).write_text(json.dumps(rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout holding the parent's "
                    "rrtmg_lw_torch/ and rrtmg_lw_tpu/assets/")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(VARIANTS), help="variants to time too")
    ap.add_argument("--out", help="write the times here (JSON)")
    ap.add_argument("--time", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1save_variants needs a CUDA device")
    if args.time:
        times(args.time)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    root = pathlib.Path(__file__).resolve().parents[2]
    work = root / "build" / "k1save_variants"
    pkgs = {"parent": pathlib.Path(args.parent).resolve(), "this": root}
    for name in args.variants:
        d = work / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(root / "rrtmg_lw_torch", d / "rrtmg_lw_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copytree(root / "rrtmg_lw_tpu" / "assets",
                        d / "rrtmg_lw_tpu" / "assets")
        src = d / KERNEL
        text = src.read_text()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name} no longer applies")
            text = text.replace(old, new)
        src.write_text(text)
        pkgs[name] = d

    def env(pkg):
        return {**os.environ, "PYTHONPATH": str(pkg)}
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "from rrtmg_lw_torch import _build; "
         "print(_build.build()[1])"], cwd=pkg, env=env(pkg),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, pkg in pkgs.items()}
    for name, proc in builds.items():
        log = proc.communicate()[0]
        print(f"build {name}: rc {proc.returncode}, {log.strip()[-300:]}",
              flush=True)
        if proc.returncode:
            raise SystemExit(f"the {name} package did not build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    work.mkdir(parents=True, exist_ok=True)
    res = {}
    names = list(pkgs)
    for i, name in enumerate(names + names[::-1]):
        out = work / f"times_{name}_{i}.json"
        r = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                            "--time", str(out)], env=env(pkgs[name]),
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"timing {name} failed:\n{r.stderr[-3000:]}")
        row = {f"{x['mode']} L={x['nlay']}": x["k1_save_ms"]
               for x in json.loads(out.read_text())}
        res.setdefault(name, []).append(row)
        print(name, json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            dict(device=smi, times=res), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
