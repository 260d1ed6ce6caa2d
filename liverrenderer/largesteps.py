"""Large Steps in inverse geometry optimization (the reference's Python AD
layer `mi.ad.LargeSteps`, Nicolet et al. 2021).

Reparameterizes vertex positions v through u = (I + lambda * L) v, where L
is the combinatorial mesh Laplacian; optimizing u with a uniform-step
optimizer yields smooth, large, self-intersection-resistant steps in v.

Design: the reference backs `from_differential` with a Cholesky
factorization (cholespy).  Sparse Cholesky has no jittable JAX form; here the
system (I + lambda L) u = b is solved with conjugate gradients whose matvec
is two `segment_sum` scatters over the edge list — batched, jittable and
differentiable (the solve's implicit derivative is CG on the transpose,
which equals CG on the same SPD matrix).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class LargeSteps:
    """Build from host-side mesh arrays (vertices only define the size;
    connectivity comes from faces)."""

    def __init__(self, n_vertices: int, faces: np.ndarray,
                 lambda_: float = 19.0):
        f = np.asarray(faces, np.int64)
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        e = np.unique(np.sort(e, axis=1), axis=0)
        self.edges = jnp.asarray(e, jnp.int32)          # (E, 2) undirected
        deg = np.bincount(e.ravel(), minlength=n_vertices)
        self.degree = jnp.asarray(deg, jnp.float32)
        self.n = n_vertices
        self.lambda_ = float(lambda_)

    def _matvec(self, v):
        """(I + lambda (D - A)) v  — two scatter-adds over the edge list."""
        a, b = self.edges[:, 0], self.edges[:, 1]
        neigh = jnp.zeros_like(v).at[a].add(v[b]).at[b].add(v[a])
        return v * (1.0 + self.lambda_ * self.degree)[:, None] \
            - self.lambda_ * neigh

    def to_differential(self, v):
        """v -> u (latent) — mi.ad.LargeSteps.to_differential."""
        return self._matvec(v)

    def from_differential(self, u, tol: float = 1e-6, maxiter: int = 200):
        """u -> v by CG on the SPD system (mi.ad.LargeSteps
        .from_differential)."""
        sol, _ = jax.scipy.sparse.linalg.cg(
            self._matvec, u, x0=u / (1.0 + self.lambda_
                                     * self.degree)[:, None],
            tol=tol, maxiter=maxiter)
        return sol
