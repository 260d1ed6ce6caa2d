"""Discrete + piecewise distributions for emitter/envmap importance sampling.

Wavefront replacement for the reference's DiscreteDistribution /
ContinuousDistribution / Hierarchical2D machinery (include/mitsuba/core/
distr_1d.h:1023, distr_2d.h:1500): CDFs are precomputed host-side into dense
arrays, sampling is a vectorized `searchsorted` (maps to a fused binary
search, no data-dependent shapes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from . import struct

Array = jax.Array


@struct.dataclass
class DiscreteDistribution:
    """Normalized discrete distribution over n entries."""
    cdf: Array    # (n,) inclusive cumulative sum, cdf[-1] == total
    pmf: Array    # (n,) unnormalized weights
    total: Array  # () sum of weights

    @staticmethod
    def build(weights) -> "DiscreteDistribution":
        w = jnp.asarray(weights, jnp.float32)
        cdf = jnp.cumsum(w)
        return DiscreteDistribution(cdf=cdf, pmf=w, total=cdf[-1])

    def sample(self, u: Array):
        """u in [0,1) -> (index, pdf)."""
        x = u * self.total
        idx = jnp.searchsorted(self.cdf, x, side="right")
        idx = jnp.clip(idx, 0, self.pmf.shape[0] - 1).astype(jnp.int32)
        pdf = self.pmf[idx] / jnp.maximum(self.total, 1e-30)
        return idx, pdf

    def sample_reuse(self, u: Array):
        """Sample and rescale u for reuse (reference distr_1d.h sample_reuse)."""
        x = u * self.total
        idx = jnp.searchsorted(self.cdf, x, side="right")
        idx = jnp.clip(idx, 0, self.pmf.shape[0] - 1).astype(jnp.int32)
        lo = jnp.where(idx > 0, self.cdf[jnp.maximum(idx - 1, 0)], 0.0)
        w = self.pmf[idx]
        u2 = jnp.clip((x - lo) / jnp.maximum(w, 1e-30), 0.0, 1.0 - 1e-7)
        pdf = w / jnp.maximum(self.total, 1e-30)
        return idx, u2, pdf

    def eval_pdf(self, idx: Array):
        return self.pmf[idx] / jnp.maximum(self.total, 1e-30)


@struct.dataclass
class Distribution2D:
    """Row-major 2D piecewise-constant distribution (envmap sampling).

    Equivalent capability to reference Hierarchical2D<0> used by envmap.cpp;
    implemented as marginal-row CDF + per-row conditional CDFs, both sampled
    with searchsorted.
    """
    cond_cdf: Array   # (h, w) per-row inclusive cumsum
    marg_cdf: Array   # (h,) inclusive cumsum of row sums
    data: Array       # (h, w) weights
    total: Array      # ()

    @staticmethod
    def build(weights) -> "Distribution2D":
        w = jnp.asarray(weights, jnp.float32)
        cond = jnp.cumsum(w, axis=1)
        rows = cond[:, -1]
        marg = jnp.cumsum(rows)
        return Distribution2D(cond_cdf=cond, marg_cdf=marg, data=w,
                              total=marg[-1])

    def sample(self, u2: Array):
        """u2: (..., 2) -> ((row, col) float positions in [0,h)x[0,w), pdf).

        pdf is wrt the discrete cell, i.e. density per-texel = pdf * h * w.
        """
        h, w = self.data.shape
        x = u2[..., 1] * self.total
        row = jnp.clip(jnp.searchsorted(self.marg_cdf, x, side="right"),
                       0, h - 1).astype(jnp.int32)
        row_lo = jnp.where(row > 0, self.marg_cdf[jnp.maximum(row - 1, 0)], 0.0)
        row_w = self.cond_cdf[row, -1]
        # conditional along the row
        y = u2[..., 0] * row_w
        cond = self.cond_cdf[row]
        col = jnp.clip(
            jax.vmap(lambda c, yy: jnp.searchsorted(c, yy, side="right"))(
                cond.reshape(-1, w), y.reshape(-1)).reshape(y.shape),
            0, w - 1).astype(jnp.int32)
        col_lo = jnp.where(col > 0,
                           self.cond_cdf[row, jnp.maximum(col - 1, 0)], 0.0)
        cell = self.data[row, col]
        pdf = cell / jnp.maximum(self.total, 1e-30)
        # continuous offsets inside the cell
        du = jnp.clip((y - col_lo) / jnp.maximum(cell, 1e-30), 0.0, 1.0)
        dv = jnp.clip((x - row_lo) / jnp.maximum(row_w, 1e-30), 0.0, 1.0)
        pos = jnp.stack([col.astype(jnp.float32) + du,
                         row.astype(jnp.float32) + dv], -1)
        return pos, pdf

    def eval_pdf(self, col: Array, row: Array):
        return self.data[row, col] / jnp.maximum(self.total, 1e-30)


def build_distribution_1d_np(weights: np.ndarray):
    w = np.asarray(weights, np.float32)
    return w, np.cumsum(w), float(w.sum())
