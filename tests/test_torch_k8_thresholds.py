"""K8's integer compares (csrc/mcica.cu) on the CPU: where the compared
value is a raw uniform u = m 2**-k of the Philox draw (k = 24 in float32,
53 in float64), the kernel compares m with ``mcica.uniform_thresholds``
of the threshold in place of u with the threshold.

* Exhaustively for every m within 3 of each threshold's T: m >= T(thr)
  <=> m 2**-k >= thr, and m < T(a, strict) <=> m 2**-k < a, on random
  floats, every multiple of 2**-k near 0, 0.5 and 1 and its float
  neighbours, 0, 1, 1 - CLDMIN, values outside [0, 1], the infinities and
  NaN.
* The mask of icld 1, 3, 4 and 5 walked on the integers m (icld 4/5's
  carried CDF is always an earlier uniform) equal to
  ``mask_from_uniforms`` on the same Philox uniforms, in both types.
"""

import pytest
import torch

from rrtmg_lw_torch.ops import mcica

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)


def _bits(dtype):
    return 24 if dtype == torch.float32 else 53


def _thresholds(dtype):
    """The thresholds the compares are held on, in ``dtype``."""
    k = _bits(dtype)
    ulp = 2.0 ** -k
    j = torch.arange(-64, 65, dtype=torch.float64)
    grid = torch.cat([j[64:] * ulp, 0.5 + j * ulp, 1.0 + j * ulp])
    grid = grid.to(dtype)
    inf = torch.tensor(float("inf"), dtype=dtype)
    gen = torch.Generator().manual_seed(k)
    rand = torch.rand(4000, generator=gen, dtype=dtype)
    out = torch.cat([
        grid, torch.nextafter(grid, inf), torch.nextafter(grid, -inf), rand,
        rand * 3 - 1,
        torch.tensor([0.0, -0.0, 1.0, 1.0 - mcica.CLDMIN, mcica.CLDMIN,
                      1e-30, -1e-30, 1e30, -1e30, float("inf"),
                      float("-inf"), float("nan")], dtype=dtype)])
    return out


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_integer_compare_equals_the_float_compare(dtype, strict):
    k = _bits(dtype)
    x = _thresholds(dtype)
    t = mcica.uniform_thresholds(x, strict)
    assert t.dtype == torch.int64 and t.shape == x.shape
    assert int(t.min()) >= 0 and int(t.max()) <= 1 << k
    m = (t[:, None] + torch.arange(-3, 4)).clamp(0, (1 << k) - 1)
    u = m.to(dtype) * 2.0 ** -k          # exact: m < 2**k
    assert torch.equal((u * 2.0 ** k).to(torch.int64), m)
    xs = x[:, None].expand_as(u)
    if strict:
        assert torch.equal(m < t[:, None], u < xs)
    else:
        assert torch.equal(m >= t[:, None], u >= xs)


def _walk_on_integers(icld, cf, mu, mv, alpha):
    """The mask (L, 140, B) of icld 1, 3, 4, 5 on the uniforms' integers
    m (layout of ``overlap_cdf``), compared with integer thresholds."""
    cldf_t = torch.where(cf < mcica.CLDMIN, 0.0, cf).t()
    t = mcica.uniform_thresholds(1.0 - cldf_t)[:, None, :]
    L = cldf_t.shape[0]
    if icld == 1:
        return mu >= t
    if icld == 3:
        return mu[:1] >= t
    a = mcica.uniform_thresholds(alpha.t(), strict=True)[:, None, :]
    prev, out = mu[0], [mu[0]]
    for lev in range(1, L):
        prev = torch.where(mv[lev] < a[lev], prev, mu[lev])
        out.append(prev)
    return torch.stack(out) >= t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("icld", [1, 3, 4, 5])
def test_integer_walk_equals_mask_from_uniforms(icld, dtype):
    B, L = 96, 13
    gen = torch.Generator().manual_seed(icld)
    r = torch.rand((B, L), generator=gen, dtype=dtype)
    cf = torch.rand((B, L), generator=gen, dtype=dtype)
    cf = torch.where(r < 0.3, 0.0, torch.where(r > 0.85, 1.0, cf))
    cf = torch.where((r > 0.4) & (r < 0.45), 1e-25, cf)
    alpha = torch.rand((B, L), generator=gen, dtype=dtype)
    alpha = torch.where(r < 0.1, 0.0, torch.where(r > 0.9, 1.0, alpha))
    alpha = alpha if icld in (4, 5) else None
    key = mcica.fold_in(mcica.key(7), icld)
    one = 2.0 ** _bits(dtype)
    u = mcica.philox_uniforms(key, 1 if icld == 3 else L, B, dtype)
    u2 = (mcica.philox_uniforms(key, L, B, dtype, stream=mcica.STREAM_U2)
          if icld in (4, 5) else None)
    mu = (u * one).to(torch.int64)
    mv = None if u2 is None else (u2 * one).to(torch.int64)
    got = _walk_on_integers(icld, cf, mu, mv, alpha)
    ref = mcica.mask_from_uniforms(icld, cf, u, u2, alpha,
                                   mask_dtype=torch.int8)
    assert torch.equal(got.expand(L, -1, -1).to(torch.int8), ref[:, :140])
    assert 0.05 < float(ref[:, :140].float().mean()) < 0.95
