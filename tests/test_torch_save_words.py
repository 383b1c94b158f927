"""The cloudy-layer words that K1's gradient-step launch keeps beside the
radiances in the fused and cldf-odcld modes (and compact at idrv=1, for
its d/dT adjoint), which K6 reads there: the plain packing helper
``rtrn.cloudy_words`` against a numpy bit-pack, on per-g cloud fractions
and on compact's int8 mask, and ``rtrn_cuda.rt_sweep_g_radiances`` /
``rt_sweep_radiances`` on CPU tensors (the plain version of K1 keeping
the radiances) returning them in those modes and none in banded.  The
kernel's words are held to the plain helper's on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from rrtmg_lw_torch import BandClouds, LWConfig, McicaCloudsBlocked
from rrtmg_lw_torch import Atmosphere, McicaCloudsCompact, make_model
from rrtmg_lw_torch.ops import cldprop, rtrn, rtrn_cuda, setcoef
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.utils import synthetic as tsyn

torch.set_num_threads(1)


def numpy_words(cldf):
    """(L, 144, B) cloud fractions -> uint32 ((B + 31) // 32, L): bit c
    of word (t, l) set where column 32 t + c has a g-point of 140 with
    cldf >= 0.5 at layer l; columns past B - 1 clear."""
    L, _, B = cldf.shape
    n = -(-B // 32)
    cloudy = np.zeros((L, n * 32), bool)
    cloudy[:, :B] = (cldf[:, :140] >= 0.5).any(axis=1)
    packed = np.packbits(cloudy.reshape(L, n, 32), axis=-1,
                         bitorder="little")
    return np.ascontiguousarray(packed).view("<u4")[..., 0].T


def seeded_cldf(L, B, seed):
    """Per-g cloud fractions from a seeded generator: about half the
    (layer, column) cloudy, with a few g-points at or above 0.5 (a third
    of them exactly 0.5), the other g-points below it (a third of them
    the float just below 0.5); the pad rows 140-143 at 1 (never read)."""
    rng = np.random.default_rng(seed)
    shape = (L, 144, B)
    below = np.nextafter(0.5, 0.0)
    u = rng.random(shape)
    high = np.where(u < 1 / 3, 0.5, 0.5 + 0.5 * rng.random(shape))
    low = np.where(u < 1 / 3, below, 0.5 * rng.random(shape))
    on = (rng.random((L, 1, B)) < 0.5) & (rng.random(shape) < 0.05)
    cldf = np.where(on, high, low)
    cldf[:, 140:] = 1.0
    return cldf


SHAPES = [(37, 6), (64, 5), (96, 4), (5, 3), (33, 1)]


@pytest.mark.parametrize("B,L,mask", [
    *(pytest.param(B, L, False, id=f"{B}-{L}") for B, L in SHAPES),
    *(pytest.param(B, L, True, id=f"int8-{B}-{L}") for B, L in SHAPES)])
def test_cloudy_words_match_a_numpy_bit_pack(B, L, mask):
    """``rtrn.cloudy_words`` at odd (96, 5, 33) and even (37, 64) counts
    of 32-column tiles, ragged (37, 5, 33) and full (64, 96), equals the
    numpy bit-pack of ``(cldf[:, :140] >= 0.5).any(g)`` with the columns
    past B clear, reinterpreted as int32; exactly 0.5 counts as cloudy,
    the float just below it does not.  ``mask``: on compact's int8 mask
    of the same draw (1 where cldf >= 0.5, else 0; the pad rows 1, never
    read), whose words K1 SAVE compact keeps at idrv=1."""
    cldf = seeded_cldf(L, B, seed=B * 7 + L)
    if mask:
        cldf = (cldf >= 0.5).astype(np.int8)
    want = numpy_words(cldf).view(np.int32)
    got = rtrn.cloudy_words(torch.as_tensor(cldf))
    assert got.dtype == torch.int32 and got.shape == (-(-B // 32), L)
    assert np.array_equal(got.numpy(), want)
    if mask:
        lay = (cldf[:, :140] == 1).any(axis=1)
        assert lay.any() and not lay.all() and (cldf[:, 140:] == 1).all()
        one = np.zeros((1, 144, B), np.int8)
        one[0, 139, B - 1] = 1
        one[0, 140:, 0] = 1                     # pad rows: not read
        words = rtrn.cloudy_words(torch.as_tensor(one)).numpy().view(
            np.uint32)
        bits = [(int(words[t, 0]) >> c) & 1 for t in range(words.shape[0])
                for c in range(32)]
        assert bits[B - 1] == 1 and sum(bits) == 1
        return
    # both sides of the gate are in the draw, and a mix of clear and
    # cloudy (layer, column)
    assert (cldf[:, :140] == 0.5).any()
    assert (cldf[:, :140] == np.nextafter(0.5, 0.0)).any()
    lay = (cldf[:, :140] >= 0.5).any(axis=1)
    assert lay.any() and not lay.all()
    # the gate in isolation: one g-point at 0.5 makes its layer cloudy,
    # one just below leaves it clear
    one = np.zeros((1, 144, B))
    one[0, 139, B - 1] = 0.5
    one[0, 0, 0] = np.nextafter(0.5, 0.0)
    words = rtrn.cloudy_words(torch.as_tensor(one)).numpy().view(np.uint32)
    bits = [(int(words[t, 0]) >> c) & 1 for t in range(words.shape[0])
            for c in range(32)]
    assert bits[B - 1] == 1 and sum(bits) == 1


def _sweep_inputs(B, L):
    """The sweep inputs (taut_t, fracs_t, planklay_t, planklev_t, surf)
    and each random-overlap mode's clouds on a synthetic atmosphere, as
    the model forms them on the CPU (float64)."""
    model = make_model(LWConfig(icld=1, imca=0, use_lut=False), device="cpu")
    static = model.static_tensors()
    prof = inatm(Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"))
    sc = setcoef.setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    play, plev = (setcoef.interp_planck_blocked(t.t().contiguous(),
                                                model.totplnk)
                  for t in (prof.tavel, prof.tz))
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm, tg.dtype)
    bc = BandClouds.from_numpy(tsyn.make_band_clouds(B, L), "cpu")
    taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                              iceflag=3, liqflag=1)
    blk = McicaCloudsBlocked.from_numpy(
        tsyn.make_mcica_clouds(B, L, layout="blocked"), "cpu")
    abi, abl = cldprop.ice_liq_coeffs_blocked(blk.reicmc, blk.relqmc, 3, 1,
                                              static)
    tauc, cldf, _ = cldprop.cldprmc_blocked(blk, static, inflag=2,
                                            iceflag=3, liqflag=1)
    cmp = McicaCloudsCompact.from_numpy(
        tsyn.make_mcica_clouds(B, L, seed=L, mask_dtype=np.int8,
                               clear_frac=0.3), "cpu")
    cabi, cabl = cldprop.ice_liq_coeffs_blocked(cmp.reicmc, cmp.relqmc, 3,
                                                1, static)
    cw = torch.stack([cmp.ciwp.t(), cmp.clwp.t()], 1).contiguous()
    clouds = {"banded": (bc.cldfrac.t().contiguous(), taucb),
              "fused": (*blk[:4], abi, abl), "cldf_od": (cldf, tauc),
              "compact": (cmp.cldfmc, cw, cabi, cabl)}
    return (tg, fr, play, plev, surf), clouds, model


@pytest.mark.parametrize("mode", ["banded", "fused", "cldf_od", "compact"])
def test_sweep_keeping_radiances_returns_the_words(mode):
    """On CPU tensors ``rt_sweep_g_radiances`` returns (fluxes, rads,
    words): the plain sweep's fluxes and radiances and, in fused and
    cldf-odcld, the words of the mode's per-g cloud fraction (the numpy
    bit-pack's; some layers cloudy, some clear), None in banded; the
    plain sweep with ``radiances=True`` returns the same words.  Compact:
    ``rt_sweep_radiances`` returns the words of its int8 mask (the numpy
    bit-pack's) beside the plain sweep's fluxes and radiances."""
    B, L = 37, 6
    x, clouds, model = _sweep_inputs(B, L)
    cl = clouds[mode]
    if mode == "compact":
        mask, cw, abi, abl = cl
        fl, rads, words = rtrn_cuda.rt_sweep_radiances(
            *x, cw, abi, abl, mask, model.ngb0, model.wg)
        ref = rtrn.rt_sweep_blocked(*x, model.ngb0, model.wg, cl,
                                    radiances=True)
        assert len(ref) == 2
        want = numpy_words(mask.numpy()).view(np.int32)
        assert words.dtype == torch.int32
        assert np.array_equal(words.numpy(), want)
        assert bool(words.any()) and not bool((words == -1).all())
        assert torch.equal(fl, ref[0]) and torch.equal(rads, ref[1])
        assert rads.shape == (4, L, 140, B)
        return
    fl, rads, words = rtrn_cuda.rt_sweep_g_radiances(mode, *x, cl,
                                                     model.ngb0, model.wg)
    if mode == "banded":
        assert words is None
        ref = rtrn.rt_sweep_banded(*x, *cl, model.ngb0, model.wg,
                                   radiances=True)
        assert len(ref) == 2
    else:
        ref = rtrn.rt_sweep_blocked(*x, model.ngb0, model.wg, cl,
                                    radiances=True)
        assert len(ref) == 3 and torch.equal(words, ref[2])
        want = numpy_words(cl[0].numpy()).view(np.int32)
        assert np.array_equal(words.numpy(), want)
        assert bool(words.any()) and not bool((words == -1).all())
    assert torch.equal(fl, ref[0]) and torch.equal(rads, ref[1])
    assert rads.shape == (4, L, 140, B)
