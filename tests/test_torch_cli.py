"""The port's column-mode CLI and input/output (``rrtmg_lw_torch.cli``,
``rrtmg_lw_torch.io``) against the JAX package's, on the CPU.

The decks are written here (tmp_path, ``synthetic.write_column_deck``),
in the layouts of tests/test_rrtatm.py: IATM=1 with AUTLAY layering
(clear), the same with XAMNTS cross sections, and the AUTLAY deck with
an IN_CLD_RRTM for per-band clouds (imca=0, icld=2) and McICA (imca=1,
icld 2 and 4, nmca=2, the reference Mersenne-Twister sub-columns).  Every ColumnCase field the
port reads equals JAX's; ``run_case(..., return_raw=True,
device="cpu")`` gives raws within 1e-10 of JAX's ``run_case`` and
text-identical blocks; OUTPUT_RRTM round-trips through
``golden.parse_output_rrtm``.  No test reads the reference's own decks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rrtmg_lw_tpu import cli as jcli
from rrtmg_lw_tpu.io import column_input as jin
from rrtmg_lw_tpu.io.fortran_format import fmt_f as jfmt_f

from rrtmg_lw_torch import cli as tcli
from rrtmg_lw_torch.io import golden, read_input_rrtm, write_output_rrtm
from rrtmg_lw_torch.io.column_output import version_footer
from rrtmg_lw_torch.io.fortran_format import fmt_f
from rrtmg_lw_torch.utils.synthetic import write_column_deck

torch.set_num_threads(1)


@pytest.mark.parametrize("value,width,decimals,want", [
    (0.067, 6, 5, ".06700"), (-0.5, 6, 4, "-.5000"),
    (281.5358, 8, 4, "281.5358"), (1013.0, 6, 1, "1013.0"),
    (775.25, 6, 1, " 775.3"), (12345.678, 6, 1, "******")])
def test_fmt_f_fortran_quirks(value, width, decimals, want):
    assert fmt_f(value, width, decimals) == want
    assert fmt_f(value, width, decimals) == jfmt_f(value, width, decimals)


DECKS = {"clear": {}, "xsec": dict(xsec=True),
         "band_cloud": dict(icld=2, imca=0),
         "mcica_icld2": dict(icld=2, imca=1),
         "mcica_icld4": dict(icld=4, imca=1)}


def _equal(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", DECKS)
def test_read_input_rrtm_equals_jax(tmp_path, name):
    path = write_column_deck(tmp_path, **DECKS[name])
    got, ref = read_input_rrtm(path), jin.read_input_rrtm(path)
    assert got.nlayers > 10 and got.icld == DECKS[name].get("icld", 0)
    if name == "xsec":
        assert (got.wx > 0).all()
    if got.icld:
        assert got.clouds.cldfrac.max() > 0
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]
    _equal(got, ref)


@pytest.mark.parametrize("name", DECKS)
def test_run_case_matches_jax(tmp_path, name):
    case = read_input_rrtm(write_column_deck(tmp_path, **DECKS[name]))
    blocks, raws = tcli.run_case(case, nmca=2, return_raw=True,
                                 device="cpu")
    jblocks, jraws = jcli.run_case(jin.read_input_rrtm(
        tmp_path / "INPUT_RRTM"), nmca=2, return_raw=True)
    assert len(blocks) == len(jblocks) == 1
    assert blocks == jblocks
    for got, ref in zip(raws, jraws):
        assert got["device"] == "cpu"
        for k in ("istart", "iend"):
            assert got[k] == ref[k]
        for k in ("uflx", "dflx", "fnet", "htr"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-10,
                                       err_msg=k)
    uflx = raws[0]["uflx"]
    assert np.isfinite(uflx).all() and uflx[-1] < uflx[0]


def test_mcica_samples_are_the_reference_generators(tmp_path):
    """nmca=2 McICA: the two samples are the reference MT streams of
    seeds 1 and 2, so a cloudy deck's fluxes differ from its clear-sky
    ones and from a single-sample run."""
    case = read_input_rrtm(write_column_deck(tmp_path, icld=2, imca=1))
    _, two = tcli.run_case(case, nmca=2, return_raw=True, device="cpu")
    _, one = tcli.run_case(case, nmca=1, return_raw=True, device="cpu")
    case.icld = 0
    _, clear = tcli.run_case(case, nmca=1, return_raw=True, device="cpu")
    assert not np.allclose(two[0]["uflx"], clear[0]["uflx"])
    assert not np.allclose(two[0]["dflx"], one[0]["dflx"])


def test_output_round_trips_and_main(tmp_path):
    inp = write_column_deck(tmp_path, icld=2, imca=0)
    blocks, raws = tcli.run_case(read_input_rrtm(inp), return_raw=True,
                                 device="cpu")
    out = tmp_path / "OUT_TEXT"
    write_output_rrtm(out, blocks)
    text = out.read_text()
    assert text.endswith(version_footer()) and "rrtmg_lw_torch" in text
    (parsed,) = golden.parse_output_rrtm(out)
    assert (parsed.wavenum1, parsed.wavenum2) == (10.0, 3250.0)
    L = len(raws[0]["uflx"]) - 1
    np.testing.assert_array_equal(parsed.level, np.arange(L, -1, -1))
    # the printed values are the raws at the format's own precision
    np.testing.assert_allclose(parsed.uflx, raws[0]["uflx"][::-1],
                               atol=5e-5)
    np.testing.assert_allclose(parsed.htr[1:], raws[0]["htr"][::-1],
                               atol=5e-6)
    assert golden.compare_outputs(out, out) == dict(
        uflx=0.0, dflx=0.0, fnet=0.0, htr=0.0, pz=0.0)
    # the command line on the CPU writes the same file
    main_out = tmp_path / "OUT_MAIN"
    tcli.main([str(inp), "-o", str(main_out), "--device", "cpu"])
    assert main_out.read_text() == text


def test_default_device_is_the_card(tmp_path):
    case = read_input_rrtm(write_column_deck(tmp_path))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.run_case(case)
