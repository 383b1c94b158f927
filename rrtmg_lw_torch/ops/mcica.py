"""McICA stochastic sub-column cloud generation.

Port of ``rrtmg_lw_tpu.ops.mcica`` (the GCM variant
``src/mcica_subcol_gen_lw.f90`` and the single-column variant
``src/mcica_subcol_gen_lw.1col.f90``, with the RNGs of
``src/mcica_random_numbers.f90``):

  * ``get_alpha``: the vertical correlation of icld 4/5;
  * the device generator, ``mcica_subcol_lw_compact`` (the generate-then-
    radiate step's: an (L, 144, B) sub-column mask, int8 on the main
    path, plus the per-layer water paths) and ``mcica_subcol_lw`` (the
    batch layout, (B, L, 140) per-g arrays).  On a CUDA tensor both
    launch K8 (``ops.mcica_cuda``, ``csrc/mcica.cu``); on a CPU tensor
    they run its plain version, ``subcol_mask``;
  * numpy-only copies of the bit-exact reference generators
    (``MersenneTwisterRef``, ``KissVecRef``,
    ``generate_stochastic_clouds_ref``), which the column-mode CLI uses.

The draws.  JAX's generator draws ``jax.random`` (threefry) bits; the
port draws Philox4x32-10 (Salmon et al., SC'11, Random123), a counter-
based generator, with an explicit key: ``key(seed)`` and ``fold_in(key,
i)`` in place of ``jax.random.PRNGKey`` / ``fold_in``; there is no
global RNG state.  One Philox call gives the uniforms of ``per_call``
consecutive layers of one (g-point, column): 4 in float32, 2 in float64.
Its counter is (column, g-point, layer block, stream), stream 0 the draw
``u`` and 1 the decorrelation draw ``u2`` of icld 4/5; its key the key's
two words.  A float32 uniform is ``(x >> 8) * 2**-24``, a float64 one
``((x0 >> 5) * 2**26 + (x1 >> 6)) * 2**-53``: both exact in the type, in
[0, 1).  ``philox_uniforms`` draws them in torch integer ops; K8 draws
the same bits in registers, so one key gives one mask on the CPU and on
the card.  The two packages' masks agree for the same uniforms
(``mask_from_uniforms``, ``uniforms=`` of the generators), not for the
same seed.

The overlap (icld 1 random, 2 maximum-random, 3 maximum, 4 exponential,
5 exponential-random) is ``overlap_cdf``, the plain core over a leading
layer axis: the same elementwise operations as JAX's
``_native_cdf_blocked`` (rrtmg_lw_tpu/ops/mcica.py:164) and
``_native_cdf`` (:91), so the masks are bitwise equal for equal draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import NGPT, NGPT_PAD, McicaClouds, McicaCloudsCompact
from .cldprop import NGB0

CLDMIN = 1.0e-20
M32 = 0xFFFFFFFF

# Philox4x32-10 (Random123's philox.h): the round multipliers and the
# Weyl increments of the key
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10
# counter word 3: the streams of the draws, and fold_in's own
STREAM_U, STREAM_U2, STREAM_FOLD = 0, 1, 2


def per_call(dtype: torch.dtype) -> int:
    """Layers whose uniforms one Philox call gives (four 32-bit words)."""
    return 2 if dtype == torch.float64 else 4


# ---------------------------------------------------------------------------
# Philox4x32-10 in torch integer ops (int64 tensors holding uint32 values)
# ---------------------------------------------------------------------------

def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * x, m < 2**32 and
    0 <= x < 2**32: x in 16-bit halves, so that no int64 product
    overflows."""
    p1 = m * (x & 0xFFFF)                   # < 2**48
    p2 = m * (x >> 16)                      # < 2**48
    mid = p1 + ((p2 & 0xFFFF) << 16)        # < 2**49
    return (p2 >> 16) + (mid >> 32), mid & M32


def philox4x32(ctr, k):
    """Philox4x32-10 of the counter ``ctr`` (four words of uint32 values:
    int64 tensors, which broadcast, or Python ints) under the key ``k``
    (two ints): four words of the same kind."""
    c = list(ctr)
    k0, k1 = int(k[0]), int(k[1])
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & M32
            k1 = (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def key(seed: int) -> tuple:
    """The key of ``seed`` (0 <= seed < 2**64): its two 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return (seed & M32, seed >> 32)


def fold_in(k, i: int) -> tuple:
    """A new key from ``k`` and the integer ``i`` (a step, a shard):
    the first two words of Philox at counter (i low, i high, 0,
    STREAM_FOLD), a counter no draw uses."""
    i = int(i)
    if not 0 <= i < 1 << 64:
        raise ValueError(f"fold_in takes 0 <= i < 2**64, got {i}")
    w = philox4x32((i & M32, i >> 32, 0, STREAM_FOLD), k)
    return (int(w[0]), int(w[1]))


def philox_uniforms(k, nlay: int, ncol: int, dtype=torch.float32,
                    stream: int = STREAM_U, device="cpu") -> torch.Tensor:
    """Uniforms (nlay, 140, ncol) in [0, 1) of ``dtype``: the plain
    version of K8's draw (counter (column, g, layer // per_call,
    stream))."""
    per = per_call(dtype)
    nblk = -(-nlay // per)

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)
    col = ar(ncol)[None, None, :]
    g = ar(NGPT)[None, :, None]
    blk = ar(nblk)[:, None, None]
    x = [w.expand(nblk, NGPT, ncol)
         for w in philox4x32((col, g, blk, stream), k)]
    if per == 4:
        u = torch.stack([(w >> 8).to(torch.float32) for w in x], dim=1)
        u = u * 2.0 ** -24
    else:
        u = torch.stack([((a >> 5) * (1 << 26) + (b >> 6)).to(torch.float64)
                         for a, b in ((x[0], x[1]), (x[2], x[3]))], dim=1)
        u = u * 2.0 ** -53
    return u.reshape(nblk * per, NGPT, ncol)[:nlay].contiguous()


def uniform_thresholds(x: torch.Tensor, strict: bool = False):
    """K8's integer thresholds for compares with a uniform u = m 2**-k of
    ``philox_uniforms`` (k = 24 in float32, 53 in float64): T = ceil(x
    2**k) clamped to [0, 2**k], so that u >= x <=> m >= T and (``strict``)
    u < x <=> m < T.  NaN compares false either way: T = 2**k, or 0 where
    ``strict``.  ``x``: float32 or float64 -> int64 of its shape."""
    one = 2.0 ** (24 if x.dtype == torch.float32 else 53)
    t = torch.ceil(x * one).clamp(0.0, one)   # x 2**k is exact in the type
    return torch.where(torch.isnan(x), 0.0 if strict else one,
                       t).to(torch.int64)


# ---------------------------------------------------------------------------
# get_alpha (mcica_subcol_gen_lw.f90:68-180)
# ---------------------------------------------------------------------------

def get_alpha(dz, icld, idcor=0, decorr_con=2.5e3, lat=None, juldat=0,
              cldfrac=None):
    """Vertical correlation parameter alpha (B, L) for icld 4/5 (zero
    for the other overlaps).

    dz: (B, L) layer thickness in m; lat: (B,) degrees (idcor=1);
    cldfrac required for icld=5 (block decorrelation)."""
    dz = torch.as_tensor(dz)
    dtype, device = dz.dtype, dz.device
    B, L = dz.shape
    if icld not in (4, 5):
        return torch.zeros((B, L), dtype=dtype, device=device)

    if idcor == 1:
        am1, am2, am4, amr = 1.4315, 2.1219, -25.584, 7.0
        if juldat > 181:
            am3 = -4.0 * amr / 365.0 * (juldat - 272)
        else:
            am3 = 4.0 * amr / 365.0 * (juldat - 91)
        lat = torch.as_tensor(lat, dtype=dtype, device=device)
        decorr_lat = am1 + am2 * torch.exp(-(lat - am3) ** 2 / am4 ** 2)
        decorr_len = decorr_lat * 1.0e3
    else:
        decorr_len = torch.full((B,), decorr_con, dtype=dtype, device=device)

    pos = decorr_len > 0.0
    decorr_inv = torch.where(
        pos, 1.0 / torch.where(pos, decorr_len, 1.0),
        torch.where(decorr_len == 0.0, torch.inf, 1.0))

    half_dz = 0.5 * (dz[:, 1:] + dz[:, :-1])            # (B, L-1)
    alpha_up = torch.exp(-half_dz * decorr_inv[:, None])
    alpha = torch.cat([torch.zeros((B, 1), dtype=dtype, device=device),
                       alpha_up], dim=1)
    if icld == 5:
        cf = torch.as_tensor(cldfrac, dtype=dtype, device=device)
        decor = (cf[:, 1:] == 0.0) & (cf[:, :-1] > 0.0)
        alpha[:, 1:] = torch.where(decor, 0.0, alpha[:, 1:])
    return alpha


# ---------------------------------------------------------------------------
# The device generator: overlap core, plain mask, the two layouts
# ---------------------------------------------------------------------------

def _check_icld(icld):
    if icld not in (1, 2, 3, 4, 5):
        raise ValueError(f"invalid icld={icld}")


def overlap_cdf(icld: int, u, cldf_t, alpha_t=None, u2=None):
    """The plain overlap core: uniforms ``u`` (L, G, B) (icld=3: only
    layer 0 is read) and, for icld 4/5, ``u2`` (L, G, B), with the cloud
    fraction ``cldf_t`` (after CLDMIN) and ``alpha_t`` in (L, B) -> the
    correlated CDF (L, G, B), walking up the leading layer axis as
    ``_native_cdf_blocked`` (rrtmg_lw_tpu/ops/mcica.py:165-202) does."""
    _check_icld(icld)
    L = cldf_t.shape[0]
    if icld == 1:
        return u
    if icld == 3:
        return u[:1].expand(L, *u.shape[1:])
    prev = u[0]
    out = [prev]
    for lev in range(1, L):
        if icld == 2:
            # cloudy below keeps the number, clear below rescales it into
            # the clear part (1col:513-521)
            thr = (1.0 - cldf_t[lev - 1])[None, :]
            prev = torch.where(prev > thr, prev, u[lev] * thr)
        else:
            prev = torch.where(u2[lev] < alpha_t[lev][None, :], prev, u[lev])
        out.append(prev)
    return torch.stack(out)


def mask_from_uniforms(icld: int, cldfrac, u, u2=None, alpha=None,
                       g_pad: int = NGPT_PAD, mask_dtype=None):
    """The sub-column mask (L, g_pad, B) from given uniforms (the layout
    of ``overlap_cdf``), pad rows zero: cloudy where the CDF reaches
    1 - cldf (mcica.py:225).  ``cldfrac``, ``alpha``: (B, L); the mask in
    ``mask_dtype`` (default the cloud fraction's)."""
    B, L = cldfrac.shape
    if g_pad < NGPT:
        raise ValueError(f"g_pad must be at least {NGPT}, got {g_pad}")
    cldf_t = torch.where(cldfrac < CLDMIN, 0.0, cldfrac).t()
    alpha_t = None if alpha is None else alpha.t()
    if icld in (4, 5) and alpha_t is None:
        alpha_t = torch.zeros_like(cldf_t)
    cdf = overlap_cdf(icld, u, cldf_t, alpha_t, u2)
    iscloudy = cdf >= (1.0 - cldf_t)[:, None, :]
    mdt = cldfrac.dtype if mask_dtype is None else mask_dtype
    mask = torch.zeros((L, g_pad, B), dtype=mdt, device=cldfrac.device)
    mask[:, :NGPT] = iscloudy.to(mdt)
    return mask


def subcol_mask(k, icld: int, cldfrac, alpha=None, g_pad: int = NGPT_PAD,
                mask_dtype=None):
    """The plain version of K8: Philox uniforms of key ``k``
    (``philox_uniforms``, streams 0 and, for icld 4/5, 1) through
    ``mask_from_uniforms``."""
    _check_icld(icld)
    B, L = cldfrac.shape
    kw = dict(dtype=cldfrac.dtype, device=cldfrac.device)
    u = philox_uniforms(k, 1 if icld == 3 else L, B, stream=STREAM_U, **kw)
    u2 = (philox_uniforms(k, L, B, stream=STREAM_U2, **kw)
          if icld in (4, 5) else None)
    return mask_from_uniforms(icld, cldfrac, u, u2, alpha, g_pad,
                              mask_dtype)


def mcica_subcol_lw_compact(k, icld: int, cldfrac, ciwp, clwp, rei, rel,
                            alpha=None, g_pad: int = NGPT_PAD,
                            mask_dtype=None,
                            uniforms=None) -> McicaCloudsCompact:
    """The generator in the compact form: the sub-column mask in the RT
    kernel's padded (L, g_pad, B) layout (pad rows zero) in
    ``mask_dtype`` (default the cloud fraction's; int8 on the main
    path), plus the per-layer water paths (mcica.py:205-235).  For the
    inflag=2 parameterized optics, where the per-g taucmc is never read.

    ``k``: a key (``key``, ``fold_in``).  ``uniforms``: (u, u2) in the
    layout of ``overlap_cdf`` to use in place of the key's draws (u2 None
    but for icld 4/5).  On a CUDA tensor K8 makes the mask."""
    from .mcica_cuda import subcol_mask as k8
    mask = k8(k, icld, cldfrac, alpha, g_pad, mask_dtype, uniforms)
    return McicaCloudsCompact(cldfmc=mask, ciwp=ciwp, clwp=clwp,
                              reicmc=rei, relqmc=rel)


def mcica_subcol_lw(k, icld: int, cldfrac, ciwp, clwp, rei, rel, tauc,
                    alpha=None, ngb=None, uniforms=None) -> McicaClouds:
    """The generator in the batch layout: (B, L) cloud state -> per-g
    stochastic sub-columns (B, L, 140) (mcica.py:136-161).

    tauc: per-band in-cloud optical depth (B, L, 16), gathered through
    the g-point -> band table; ngb: (140,) 1-based band of each g-point
    (default the static table's).  K8 (on a CUDA tensor) makes the mask,
    in the same draws as ``mcica_subcol_lw_compact`` with this key; the
    per-g arrays are formed from it here."""
    from .mcica_cuda import subcol_mask as k8
    dtype = cldfrac.dtype
    mask = k8(k, icld, cldfrac, alpha, NGPT_PAD, torch.int8, uniforms)
    iscloudy = mask[:, :NGPT].permute(2, 0, 1).bool()     # (B, L, G)
    ngb0 = NGB0 if ngb is None else np.asarray(ngb) - 1
    tauc_g = tauc[..., torch.as_tensor(ngb0, device=tauc.device)]
    zero = torch.zeros((), dtype=dtype, device=cldfrac.device)
    return McicaClouds(
        cldfmc=iscloudy.to(dtype),
        ciwpmc=torch.where(iscloudy, ciwp[..., None], zero),
        clwpmc=torch.where(iscloudy, clwp[..., None], zero),
        taucmc=torch.where(iscloudy, tauc_g, zero),
        reicmc=rei, relqmc=rel)


# ---------------------------------------------------------------------------
# Bit-exact reference RNGs (numpy, host): the column-mode path.  Copies of
# rrtmg_lw_tpu/ops/mcica.py:238-389.
# ---------------------------------------------------------------------------

class MersenneTwisterRef:
    """Bit-exact MT19937 as in mcica_random_numbers.f90:77-306."""

    N, M = 624, 397

    def __init__(self, seed: int):
        # initialize_scalar (:172-189)
        state = np.zeros(self.N, dtype=np.uint64)
        state[0] = np.uint64(np.uint32(seed))
        for i in range(1, self.N):
            prev = state[i - 1]
            state[i] = (np.uint64(1812433253)
                        * (prev ^ (prev >> np.uint64(30))) + np.uint64(i)) \
                & np.uint64(0xFFFFFFFF)
        self.state = state.astype(np.uint32)
        self.current = self.N

    def _next_state(self):
        s = self.state.astype(np.uint64)
        n, m = self.N, self.M
        for k in range(n):
            y = (s[k] & np.uint64(0x80000000)) | (s[(k + 1) % n]
                                                  & np.uint64(0x7fffffff))
            tw = (y >> np.uint64(1)) ^ (np.uint64(0x9908b0df)
                                        if (s[(k + 1) % n] & np.uint64(1))
                                        else np.uint64(0))
            s[k] = (s[(k + m) % n] ^ tw) & np.uint64(0xFFFFFFFF)
        self.state = s.astype(np.uint32)
        self.current = 0

    def random_int32(self) -> np.uint32:
        if self.current >= self.N:
            self._next_state()
        y = np.uint64(self.state[self.current])
        self.current += 1
        y ^= y >> np.uint64(11)
        y = (y ^ ((y << np.uint64(7)) & np.uint64(0x9d2c5680))) \
            & np.uint64(0xFFFFFFFF)
        y = (y ^ ((y << np.uint64(15)) & np.uint64(0xefc60000))) \
            & np.uint64(0xFFFFFFFF)
        y ^= y >> np.uint64(18)
        return np.uint32(y)

    def random_real(self) -> float:
        """getRandomReal: genrand_real1, [0,1] with 32-bit resolution."""
        return float(self.random_int32()) / (2.0 ** 32 - 1.0)


class KissVecRef:
    """Bit-exact vector KISS generator (mcica_subcol_gen_lw.f90:711-743).

    Seeds from the fractional parts of the bottom-four layer pressures
    in Pa (1col:529-540).
    """

    def __init__(self, pmid_pa: np.ndarray):
        pm = np.atleast_2d(np.asarray(pmid_pa, np.float64))   # (ncol, >=4)
        if pm.shape[1] < 4 or np.any(pm[:, 0] < pm[:, 1]):
            raise ValueError("kissvec seeds need bottom-4 pmid, sfc first")
        frac = pm[:, :4] - np.trunc(pm[:, :4])
        # int32 wraparound of frac*1e9 (Fortran int assignment truncates)
        self.s = [np.trunc(frac[:, i] * 1.0e9).astype(np.int64)
                  .astype(np.uint32).astype(np.uint64) for i in range(4)]

    def draw(self) -> np.ndarray:
        """One vector draw: (ncol,) float64 in [0, 1]."""
        M32 = np.uint64(0xFFFFFFFF)
        s1, s2, s3, s4 = self.s

        def m(k, n):
            if n >= 0:
                return (k ^ ((k << np.uint64(n)) & M32)) & M32
            return (k ^ (k >> np.uint64(-n))) & M32
        s1 = (np.uint64(69069) * s1 + np.uint64(1327217885)) & M32
        s2 = m(m(m(s2, 13), -17), 5)
        s3 = (np.uint64(18000) * (s3 & np.uint64(65535)) +
              (s3 >> np.uint64(16))) & M32
        s4 = (np.uint64(30903) * (s4 & np.uint64(65535)) +
              (s4 >> np.uint64(16))) & M32
        self.s = [s1, s2, s3, s4]
        kiss = (s1 + s2 + ((s3 << np.uint64(16)) & M32) + s4) & M32
        kiss_signed = kiss.astype(np.uint32).view(np.int32).astype(np.float64)
        return kiss_signed * 2.328306e-10 + 0.5


def generate_stochastic_clouds_ref(nlayers: int, icld: int, irng: int,
                                   pmid, cldfrac, clwp, ciwp, alpha, tauc,
                                   changeseed: int, ngb,
                                   ngpt: int = NGPT):
    """Bit-exact single-column generator
    (mcica_subcol_gen_lw.1col.f90:284-654), numpy on host.

    pmid in Pa (sfc first); tauc (nbnd, nlayers); returns dict of
    (ngpt, nlayers) arrays cldfmc/ciwpmc/clwpmc/taucmc in reference
    orientation.
    """
    cldf = np.asarray(cldfrac, np.float64).copy()
    cldf[cldf < CLDMIN] = 0.0
    L, G = nlayers, ngpt

    cdf = np.zeros((G, L))
    cdf2 = np.zeros((G, L))
    if irng == 0:
        kiss = KissVecRef(np.asarray(pmid)[None, :])
        for _ in range(changeseed):
            kiss.draw()

        def draw():
            return kiss.draw()[0]
    else:
        mt = MersenneTwisterRef(changeseed)

        def draw():
            return mt.random_real()

    if icld == 1 or icld == 2:
        for isub in range(G):
            for lev in range(L):
                cdf[isub, lev] = draw()
        if icld == 2:
            for lev in range(1, L):            # 1col:513-521
                keep = cdf[:, lev - 1] > 1.0 - cldf[lev - 1]
                cdf[:, lev] = np.where(keep, cdf[:, lev - 1],
                                       cdf[:, lev] * (1.0 - cldf[lev - 1]))
    elif icld == 3:
        for isub in range(G):
            r = draw()
            cdf[isub, :] = r
    elif icld in (4, 5):
        for isub in range(G):
            for lev in range(L):
                cdf[isub, lev] = draw()
                cdf2[isub, lev] = draw()
        al = np.asarray(alpha, np.float64)
        for lev in range(1, L):                # 1col:573-577, 604-607
            corr = cdf2[:, lev] < al[lev]
            cdf[:, lev] = np.where(corr, cdf[:, lev - 1], cdf[:, lev])
    else:
        raise ValueError(f"invalid icld={icld}")

    iscloudy = cdf >= (1.0 - cldf)[None, :]
    ngb0 = np.asarray(ngb) - 1
    tauc = np.asarray(tauc, np.float64)
    out_tau = np.where(iscloudy, tauc[ngb0, :], 0.0)
    return dict(
        cldfmc=np.where(iscloudy, 1.0, 0.0),
        clwpmc=np.where(iscloudy, np.asarray(clwp)[None, :], 0.0),
        ciwpmc=np.where(iscloudy, np.asarray(ciwp)[None, :], 0.0),
        taucmc=out_tau)
