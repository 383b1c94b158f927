"""The variant harnesses of the port's kernels (``utils/k5_variants.py``,
``k6_variants.py``, ``k6g_variants.py``, ``k1save_variants.py``,
``k8_variants.py``) still apply to the sources: each variant is a list of (old, new) text
replacements of one file under ``csrc/``, and the harness stops where an
old text does not occur there exactly once.  One case per (harness,
variant), the computed anchors of the ``prof`` variants included; text
only, no nvcc and no card.
"""

import importlib
import pathlib

import pytest

CSRC = pathlib.Path(__file__).resolve().parents[1] / "rrtmg_lw_torch" / "csrc"

# harness module -> the source its variants replace text in
HARNESSES = {"k5_variants": "taumol_bwd.cu", "k6_variants": "rtrn_bwd.cu",
             "k6g_variants": "rtrn_bwd_g.cu",
             "k1save_variants": "rtrn_kernel.cuh",
             "k8_variants": "mcica.cu"}


def _variants(module):
    """{variant: ([(old, new)], nvcc flags or None)} of a harness (k1save's
    variants are a list of replacements each, with the package's flags)."""
    m = importlib.import_module(f"rrtmg_lw_torch.utils.{module}")
    return {name: (v, None) if isinstance(v, list) else v
            for name, v in m.VARIANTS.items()}


CASES = [(module, name) for module in HARNESSES
         for name in _variants(module)]


def test_every_harness_names_its_variants():
    """Each harness has variants, k6g's the ``fill`` one among them, and
    the cases cover every one of them."""
    for module in HARNESSES:
        assert _variants(module), module
    assert ("k6g_variants", "fill") in CASES
    assert all((m, "prof") in CASES
               for m in ("k5_variants", "k6_variants", "k6g_variants"))


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m}-{n}" for m, n in CASES])
def test_variant_applies_to_the_source(module, name):
    """Every replacement's old text occurs exactly once in the current
    source, and the variant changes the source or the nvcc flags."""
    text = (CSRC / HARNESSES[module]).read_text()
    reps, flags = _variants(module)[name]
    assert reps or flags, (module, name)
    for i, (old, new) in enumerate(reps):
        assert text.count(old) == 1, (module, name, i, old[:80])
        assert old != new, (module, name, i)
        text = text.replace(old, new)
