"""The port's on-card verification tool (``rrtmg_lw_torch.tools.
gpu_verify``), its harness run on the CPU: ``--device cpu`` drives the
kernel wrappers' plain versions (``model.impl = "cuda"`` on a CPU model)
against ``impl="eager"``.  It carries every check of the JAX package's
``tools/tpu_verify.py`` by name and tolerance, less the two B=16384
checks (which the JAX tool's ``--smoke`` skips too), in the JAX tool's
JSON layout; a check whose error exceeds its tolerance makes it return
1; without a GPU it runs only when asked for the CPU.
"""

import json
import pathlib
import re

import pytest
import torch

from rrtmg_lw_torch.tools import gpu_verify

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SPLIT = 4 * 2.0 ** -17
# tools/tpu_verify.py's tolerances, by check
JAX_TOLS = dict(
    taumol_kernel_taug_rel=SPLIT, taumol_kernel_fracs_abs=SPLIT,
    planck_blocked_rel=SPLIT, model_clear=2e-5, model_mcica_plain=2e-5,
    model_mcica_compact=2e-5, model_mcica_idrv=2e-5,
    model_banded_icld1=2e-5, model_maxrand_icld2=2e-5,
    invariant_isothermal_sfc_vs_blackbody=3e-4,
    invariant_isothermal_level_envelope=5e-4,
    model_wire_input_noise_abs_wm2=1e-2, model_wire_full_clear_abs_wm2=1e-2,
    model_wire_full_mean_abs_wm2=5e-3, model_mcica_deep_nlay140=2e-5,
    model_mcica_compact_i8_B16k=2e-5, model_maxrand_icld2_B16k=2e-5)
B16K = ("model_mcica_compact_i8_B16k", "model_maxrand_icld2_B16k")


def jax_check_names():
    text = (REPO / "tools" / "tpu_verify.py").read_text()
    return set(re.findall(r'"((?:taumol|planck|model|invariant)_\w+)"',
                          text))


def test_checks_are_the_jax_tools():
    assert jax_check_names() == set(JAX_TOLS) == set(gpu_verify.TOLS)
    for name, tol in JAX_TOLS.items():
        assert gpu_verify.TOLS[name] == tol, name
    # the taumol and Planck bound is chip_smoke.py's TOL_TAUMOL, rounded
    assert abs(SPLIT - 3.05e-5) < 1e-7


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("verify") / "GPU_VERIFY.json"
    rc = gpu_verify.main(["--device", "cpu", "--batch", "16", "--out",
                          str(out)])
    return rc, json.loads(out.read_text())


def test_cpu_run_passes_every_check(cpu_run):
    rc, out = cpu_run
    assert rc == 0
    assert set(out) >= {"backend", "device", "batch", "elapsed_s",
                        "split_tol", "flux_tol", "all_ok", "checks",
                        "nvidia_smi"}
    assert (out["backend"], out["device"], out["batch"]) == ("cpu", "cpu", 16)
    assert out["split_tol"] == 2.0 ** -17 and out["flux_tol"] == 2e-5
    assert out["all_ok"] is True
    names = [c["check"] for c in out["checks"]]
    assert len(names) == len(set(names))
    assert set(names) == jax_check_names() - set(B16K)
    for c in out["checks"]:
        assert set(c) >= {"check", "max_err", "tol", "ok"}
        assert c["ok"] is True and c["max_err"] <= c["tol"]
        assert c["tol"] == JAX_TOLS[c["check"]]
    iso = next(c for c in out["checks"]
               if c["check"] == "invariant_isothermal_sfc_vs_blackbody")
    assert 0 < iso["max_err"] and 300 < iso["anchor_wm2"] < 400


def test_a_failing_check_returns_one(monkeypatch, tmp_path):
    # the isothermal surface emission differs from the quadrature by
    # ~1e-4 (the 1 K Planck table): a tolerance below it fails
    monkeypatch.setitem(gpu_verify.TOLS,
                        "invariant_isothermal_sfc_vs_blackbody", 1e-9)
    out = tmp_path / "v.json"
    assert gpu_verify.main(["--device", "cpu", "--batch", "16", "--out",
                            str(out)]) == 1
    res = json.loads(out.read_text())
    assert res["all_ok"] is False
    bad = [c["check"] for c in res["checks"] if not c["ok"]]
    assert bad == ["invariant_isothermal_sfc_vs_blackbody"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_no_gpu_raises_unless_asked_for_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpu_verify.main(["--out", str(tmp_path / "v.json")])
