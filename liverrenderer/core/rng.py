"""Counter-based per-lane RNG + independent sampler.

Wavefront replacement for the reference's stateful PCG32 sampler
(reference include/mitsuba/core/random.h, src/samplers/independent.cpp):
a *stateless* counter-based hash (pcg4d family, Jarzynski & Olano 2020) keyed
on (lane, seed, dimension).  Statelessness is the point — the PRB adjoint
pass (integrators/prb.py) replays identical random numbers simply by reusing
the same counters, replacing Dr.Jit's sampler clone/replay machinery
(reference python/ad/integrators/common.py:752-775).

All ops are uint32 arithmetic; no 64-bit state is needed, so it runs
without x64 mode.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from . import struct

from .types import static_field

Array = jax.Array

_U32 = jnp.uint32


def _pcg4d(v: Array) -> Array:
    """pcg4d hash: (..., 4) uint32 -> (..., 4) uint32."""
    v = v.astype(_U32)
    v = v * _U32(1664525) + _U32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], -1)


def _to_unit_float(bits: Array) -> Array:
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def _bit_reverse(v: Array) -> Array:
    v = ((v >> 16) | (v << 16)).astype(_U32)
    v = (((v & _U32(0x00ff00ff)) << 8) | ((v & _U32(0xff00ff00)) >> 8))
    v = (((v & _U32(0x0f0f0f0f)) << 4) | ((v & _U32(0xf0f0f0f0)) >> 4))
    v = (((v & _U32(0x33333333)) << 2) | ((v & _U32(0xcccccccc)) >> 2))
    v = (((v & _U32(0x55555555)) << 1) | ((v & _U32(0xaaaaaaaa)) >> 1))
    return v


def _sobol2(i: Array, scramble: Array) -> Array:
    """Second dimension of the (0,2)-sequence (ldsampler.cpp /
    qmc sampleTEA-style scrambling)."""
    v = jnp.full_like(i, 1 << 31)
    r = scramble
    for bit in range(32):
        mask = (i >> bit) & _U32(1)
        r = r ^ (mask * v)
        v = v ^ (v >> 1)
    return r


def _pow2_mask(l: int) -> int:
    w = 1
    while w < l:
        w <<= 1
    return w - 1


def _kensler_permute(i: Array, l: int, p: Array, rounds: int = 10) -> Array:
    """Stateless random permutation of [0, l) (Kensler 2013, "Correlated
    Multi-Jittered Sampling", listing 5 — the same construction the
    reference's multijitter.cpp relies on).  Cycle-walks a keyed bijection
    of the next-pow2 domain; each walk step accepts with p >= 1/2, so
    `rounds` fixed masked iterations resolve all lanes w.h.p. (stragglers
    fall back to a modulo, an O(2^-rounds) bias)."""
    if l <= 1:
        return jnp.zeros_like(i)
    w = _U32(_pow2_mask(l))
    p = p.astype(_U32)

    def h(i):
        i = i ^ p
        i = i * _U32(0xE170893D)
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = i * _U32(0x0929EB3F)
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = i * (_U32(1) | (p >> 27))
        i = i * _U32(0x6935FA69)
        i = i ^ ((i & w) >> 11)
        # odd multiplier (an even one is not invertible mod 2^32, which
        # breaks the masked-domain bijection the cycle walk relies on)
        i = i * _U32(0x74DCCA25)
        i = i ^ (p >> 2)
        i = i * _U32(0x9E501CC3)
        i = i ^ ((i & w) >> 2)
        i = i * _U32(0xC860A3DF)
        i = i & w
        i = i ^ (i >> 5)
        return i

    cur = i.astype(_U32)
    out = jnp.zeros_like(cur)
    ok = jnp.zeros(cur.shape, bool)
    for _ in range(rounds):
        cur = h(cur)
        accept = (~ok) & (cur < _U32(l))
        out = jnp.where(accept, cur, out)
        ok = ok | accept
    out = jnp.where(ok, out, cur % _U32(l))
    return (out + p) % _U32(l)


def _smallest_prime_ge(n: int) -> int:
    def is_prime(k):
        if k < 2:
            return False
        d = 2
        while d * d <= k:
            if k % d == 0:
                return False
            d += 1
        return True
    while not is_prime(n):
        n += 1
    return n


def _cmj_factor(spp: int):
    """m x n = spp with m as close to sqrt(spp) as divisibility allows."""
    m = max(1, int(round(spp ** 0.5)))
    while spp % m:
        m -= 1
    return m, spp // m


@struct.dataclass
class Sampler:
    """Per-lane sampler state: (seed, dim-counter, sample index).

    seed encodes (pixel/lane id, global seed); dim is the dimension counter
    advanced by every next_1d/next_2d call so that the primal and replay
    passes consume the identical sequence.  `kind` selects the sample
    pattern (reference src/samplers/{independent,stratified,multijitter,
    orthogonal,ldsampler}.cpp):
      independent          — pcg4d hash stream
      stratified           — per-dimension strata with decorrelating cyclic
                             shifts + jitter
      multijitter /
      orthogonal           — stratified with sub-stratified jitter
      ldsampler            — scrambled (0,2)-sequence (van der Corput +
                             Sobol') per dimension pair
    All kinds are counter-based (stateless), which is what makes the PRB
    adjoint replay exact.
    """
    seed: Array   # (N,) uint32, hash of (pixel, global seed)
    dim: Array    # (N,) uint32
    samp: Array = None   # (N,) uint32 sample index within the pixel
    pix: Array = None    # (N,) uint32 pixel/lane id (stratification keys)
    kind: str = static_field(default="independent")
    spp: int = static_field(default=1)

    # -- pattern helpers ----------------------------------------------------
    def _strat_1d(self, h, extra_rot):
        """Stratified value from hash bits h: (shifted stratum + jitter)/spp."""
        spp = max(self.spp, 1)
        shift = (extra_rot % _U32(spp)).astype(_U32)
        stratum = (self.samp + shift) % _U32(spp)
        jitter = _to_unit_float(h)
        return (stratum.astype(jnp.float32) + jitter) / spp

    def _ld_pair(self, scr1, scr2):
        i = self.samp
        x = _to_unit_float(_bit_reverse(i) ^ scr1)
        y = _to_unit_float(_sobol2(i, scr2))
        return x, y

    def _cmj_2d(self, h):
        """Correlated multi-jittered 2D pattern (Kensler 2013 eq. at
        listing 6; reference src/samplers/multijitter.cpp): the spp samples
        of a pixel are one-per-cell on the m x n grid AND one-per-stratum
        in both 1D projections."""
        spp = max(self.spp, 1)
        m_, n_ = _cmj_factor(spp)
        key = h[..., 3]
        s = _kensler_permute(self.samp, spp, key * _U32(0x51633E2D))
        sx = _kensler_permute(s % _U32(m_), m_, key * _U32(0x68BC21EB))
        sy = _kensler_permute(s // _U32(m_), n_, key * _U32(0x02E5BE93))
        hj = _pcg4d(jnp.stack([key, self.samp,
                               jnp.full_like(key, 7),
                               jnp.full_like(key, 0x9E3779B9)], -1))
        jx = _to_unit_float(hj[..., 0])
        jy = _to_unit_float(hj[..., 1])
        x = (sx.astype(jnp.float32) + (sy.astype(jnp.float32) + jx) / n_) / m_
        y = (sy.astype(jnp.float32) + (sx.astype(jnp.float32) + jy) / m_) / n_
        return x, y

    def _cmj_1d(self, h):
        spp = max(self.spp, 1)
        key = h[..., 3]
        s = _kensler_permute(self.samp, spp, key * _U32(0x51633E2D))
        hj = _pcg4d(jnp.stack([key, self.samp,
                               jnp.full_like(key, 7),
                               jnp.full_like(key, 0x9E3779B9)], -1))
        return (s.astype(jnp.float32) + _to_unit_float(hj[..., 0])) / spp

    def _oa_coord(self, a_main, a_sub, p_: int, key, jit):
        """Sub-stratified OA coordinate (Jarosz et al. 2019 "Orthogonal
        Array Sampling", CMJ-flavoured): major stratum = permuted OA symbol,
        minor offset = permuted companion symbol + jitter."""
        pm = _kensler_permute(a_main, p_, key * _U32(0x68BC21EB))
        ps = _kensler_permute(a_sub, p_, key * _U32(0x02E5BE93))
        return (pm.astype(jnp.float32)
                + (ps.astype(jnp.float32) + jit) / p_) / p_

    def _oa_2d(self, h):
        """Bose orthogonal-array pattern of strength 2 (reference
        src/samplers/orthogonal.cpp): sample i maps to symbols
        (a1, a2) = (i % p, i // p); column j is (a1 + j*a2) % p.  Any two
        columns — here the two coordinates of every dimension pair, with
        the column index advancing per dimension — are jointly stratified
        on the p x p grid.  Ideal spp = p^2 for prime p; other spp cover a
        prefix of the array after a keyed shuffle."""
        spp = max(self.spp, 1)
        p_ = _smallest_prime_ge(max(2, int(spp ** 0.5 + 0.9999)))
        key = h[..., 3]
        # the sample-order shuffle must be keyed per PIXEL only (dim
        # independent): sample k needs the same OA row (a1, a2) in every
        # dimension, or the strength-2 coupling across dimensions is lost
        pix_key = _pcg4d(jnp.stack([
            self.seed, jnp.full_like(self.seed, 3),
            jnp.zeros_like(self.seed),
            jnp.full_like(self.seed, 0x9E3779B9)], -1))[..., 0]
        i = _kensler_permute(self.samp, spp, pix_key * _U32(0x51633E2D))
        a1 = i % _U32(p_)
        a2 = i // _U32(p_)
        # column multipliers for this dimension pair: (a1 + j*a2) % p with
        # distinct j per coordinate — any two distinct columns are jointly
        # stratified (strength 2)
        d = self.dim
        jx = (d * _U32(2)) % _U32(p_)
        jy = (d * _U32(2) + _U32(1)) % _U32(p_)
        cx = (a1 + jx * a2) % _U32(p_)
        cy = (a1 + jy * a2) % _U32(p_)
        hj = _pcg4d(jnp.stack([key, self.samp,
                               jnp.full_like(key, 7),
                               jnp.full_like(key, 0x9E3779B9)], -1))
        x = self._oa_coord(cx, cy, p_, key ^ _U32(0x9E3779B9),
                           _to_unit_float(hj[..., 0]))
        y = self._oa_coord(cy, cx, p_, key ^ _U32(0x85EBCA6B),
                           _to_unit_float(hj[..., 1]))
        return x, y

    def next_1d(self):
        h = _pcg4d(jnp.stack([
            self.seed, self.dim,
            jnp.zeros_like(self.seed), jnp.full_like(self.seed, 0x9E3779B9),
        ], -1))
        if self.kind == "stratified":
            u = self._strat_1d(h[..., 0], h[..., 1])
        elif self.kind in ("multijitter", "orthogonal"):
            u = self._cmj_1d(h)
        elif self.kind == "ldsampler":
            u = _to_unit_float(_bit_reverse(self.samp) ^ h[..., 0])
        else:
            u = _to_unit_float(h[..., 0])
        return u, self.replace(dim=self.dim + _U32(1))

    def next_nd(self, k: int):
        """k uniforms per lane in ceil(k/4) hashes -> ((N, k), sampler).
        Separate key stream (z=2) from next_1d (z=0) / next_2d (z=1)."""
        m = (k + 3) // 4
        cols = []
        for j in range(m):
            h = _pcg4d(jnp.stack([
                self.seed, self.dim + _U32(j),
                jnp.full_like(self.seed, 2),
                jnp.full_like(self.seed, 0x9E3779B9),
            ], -1))
            for c in range(4):
                cols.append(_to_unit_float(h[..., c]))
        u = jnp.stack(cols[:k], -1)
        return u, self.replace(dim=self.dim + _U32(k))

    def next_2d(self):
        h = _pcg4d(jnp.stack([
            self.seed, self.dim,
            jnp.ones_like(self.seed), jnp.full_like(self.seed, 0x9E3779B9),
        ], -1))
        if self.kind == "stratified":
            u = jnp.stack([self._strat_1d(h[..., 0], h[..., 2]),
                           self._strat_1d(h[..., 1], h[..., 3])], -1)
        elif self.kind == "multijitter":
            x, y = self._cmj_2d(h)
            u = jnp.stack([x, y], -1)
        elif self.kind == "orthogonal":
            x, y = self._oa_2d(h)
            u = jnp.stack([x, y], -1)
        elif self.kind == "ldsampler":
            x, y = self._ld_pair(h[..., 0], h[..., 1])
            u = jnp.stack([x, y], -1)
        else:
            u = jnp.stack([_to_unit_float(h[..., 0]),
                           _to_unit_float(h[..., 1])], -1)
        return u, self.replace(dim=self.dim + _U32(2))


def make_sampler(lane_id: Array, sample_idx, seed=0,
                 kind: str = "independent", spp: int = 1) -> Sampler:
    """Seed a wavefront sampler. lane_id: (N,) int; sample_idx: int or (N,).

    Mirrors Sampler::seed's wavefront seeding (reference sampler.cpp) —
    every (pixel, spp-index, seed) triple gets a decorrelated stream.  For
    the stratified/ld kinds the per-pixel stream is keyed on the pixel only
    so the spp samples of one pixel share a pattern.
    """
    lane = jnp.asarray(lane_id).astype(_U32)
    samp = (jnp.broadcast_to(jnp.asarray(sample_idx), lane.shape)).astype(_U32)
    base = jnp.broadcast_to(jnp.asarray(seed), lane.shape).astype(_U32)
    if kind == "independent":
        h = _pcg4d(jnp.stack([lane, samp, base,
                              jnp.full_like(lane, 0x85EBCA6B)], -1))
    else:  # pattern kinds: stream keyed per pixel, sample index separate
        h = _pcg4d(jnp.stack([lane, jnp.zeros_like(lane), base,
                              jnp.full_like(lane, 0x85EBCA6B)], -1))
    return Sampler(seed=h[..., 0], dim=jnp.zeros_like(lane), samp=samp,
                   pix=lane, kind=kind, spp=spp)


def hash_u32(*parts) -> Array:
    """General-purpose uint32 hash of up-to-4 integer arrays (broadcast)."""
    arrs = [jnp.asarray(p).astype(_U32) for p in parts]
    shape = jnp.broadcast_shapes(*[a.shape for a in arrs])
    arrs = [jnp.broadcast_to(a, shape) for a in arrs]
    while len(arrs) < 4:
        arrs.append(jnp.full(shape, 0x27D4EB2F, _U32))
    return _pcg4d(jnp.stack(arrs[:4], -1))[..., 0]
