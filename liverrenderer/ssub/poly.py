"""Degree-3 implicit-polynomial machinery for shape-adaptive subsurface
scattering (Vicini et al.), re-derived for batched JAX.

Replaces the reference's Eigen machinery (polynomials.h):
  * monomial basis/eval/gradient  (evalPolyImpl / evalPolyGrad :509-585)
  * kernel epsilon + fit scale    (getKernelEps :494, getFitScaleFactor :598)
  * weighted least-squares fit with hard surface constraint + normal
    constraints                   (fitPolynomialsImpl :303-402)
  * world->light-space coefficient rotation (rotatePolynomialEigen :785),
    done here as a trace-time multinomial expansion over lane vectors
  * poly-gradient ray adjustment  (adjustRayDirForPolynomialTracing :689)

Coefficient order matches the reference exactly (degree-major, x-major
within degree): 1, x, y, z, x2, xy, xz, y2, yz, z2, x3, x2y, x2z, xy2,
xyz, xz2, y3, y2z, yz2, z3.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

N_COEFFS = 20

# (dx, dy, dz) exponents in reference order (polynomials.h term loops)
EXPONENTS = np.array(
    [(0, 0, 0),
     (1, 0, 0), (0, 1, 0), (0, 0, 1),
     (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
     (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
     (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)], np.int32)

def _powers(rel):
    """rel: (..., 3) -> monomial basis (..., 20) in reference order."""
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    xp = [jnp.ones_like(x), x, x * x, x * x * x]
    yp = [jnp.ones_like(y), y, y * y, y * y * y]
    zp = [jnp.ones_like(z), z, z * z, z * z * z]
    return jnp.stack([xp[dx] * yp[dy] * zp[dz] for dx, dy, dz in EXPONENTS],
                     -1)


def eval_poly(coeffs, rel):
    """coeffs (..., 20), rel (..., 3) scaled relative position -> (...)."""
    return jnp.sum(coeffs * _powers(rel), -1)


def eval_poly_grad(coeffs, rel):
    """Gradient of the polynomial wrt the *scaled* coordinates: (..., 3)."""
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    xp = [jnp.ones_like(x), x, x * x, x * x * x]
    yp = [jnp.ones_like(y), y, y * y, y * y * y]
    zp = [jnp.ones_like(z), z, z * z, z * z * z]
    gx = gy = gz = 0.0
    for i, (dx, dy, dz) in enumerate(EXPONENTS):
        c = coeffs[..., i]
        if dx > 0:
            gx = gx + c * dx * xp[dx - 1] * yp[dy] * zp[dz]
        if dy > 0:
            gy = gy + c * dy * xp[dx] * yp[dy - 1] * zp[dz]
        if dz > 0:
            gz = gz + c * dz * xp[dx] * yp[dy] * zp[dz - 1]
    return jnp.stack([gx, gy, gz], -1)


def onb_duff(n):
    """Duff et al. orthonormal basis (scattereigen.h NetworkHelpers::onb /
    Volpath3D::onbDuff): n (..., 3) -> (b1, b2) with frame (b1, b2, n)."""
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    b1 = jnp.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b,
                    -sign * n[..., 0]], -1)
    b2 = jnp.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return b1, b2


def effective_albedo(albedo):
    """sss_particle_tracer.h:365."""
    return -jnp.log(1.0 - albedo * (1.0 - jnp.exp(-8.0))) / 8.0


def kernel_eps(sigma_t, albedo, g, kernel_multiplier=1.0):
    """polynomials.h:494 getKernelEps — per channel scalars/arrays."""
    sigma_s = albedo * sigma_t
    sigma_a = sigma_t - sigma_s
    sigma_sp = (1.0 - g) * sigma_s
    sigma_tp = sigma_sp + sigma_a
    alpha_p = sigma_sp / jnp.maximum(sigma_tp, 1e-12)
    eff = effective_albedo(alpha_p)
    val = 0.25 * g + 0.25 * alpha_p + 1.0 * eff
    return kernel_multiplier * 4.0 * val * val / \
        jnp.maximum(sigma_tp * sigma_tp, 1e-12)


def fit_scale(k_eps):
    """polynomials.h:600."""
    return 1.0 / jnp.sqrt(k_eps)


# ---------------------------------------------------------------------------
# coefficient rotation: f'(x) = f(S x) with S = [s t n] columns
# ---------------------------------------------------------------------------

def rotate_poly(coeffs, S):
    """Express f(x_world) in rotated coordinates x_local: returns coeffs' of
    f'(x_local) = f(S @ x_local).  coeffs (..., 20), S (..., 3, 3).
    Replaces rotatePolynomialEigen (polynomials.h:785).

    Implementation note: this is a trace-time multinomial expansion over
    UNSTACKED (...,)-shaped component arrays.  The earlier symmetric-tensor
    einsum formulation materialized per-lane (..., 3, 3, 3) intermediates,
    which tiled device layouts pad on the trailing (3, 3) dims and which
    ran out of device memory at render wavefront sizes.  Unrolling keeps
    every intermediate a flat lane vector."""
    from itertools import product as _product

    c = [coeffs[..., m] for m in range(N_COEFFS)]
    Sc = [[S[..., i, a] for a in range(3)] for i in range(3)]
    idx = {tuple(e): m for m, e in enumerate(map(tuple, EXPONENTS))}
    out = [None] * N_COEFFS

    def acc(m, v):
        out[m] = v if out[m] is None else out[m] + v

    for m, e in enumerate(map(tuple, EXPONENTS)):
        d = sum(e)
        if d == 0:
            acc(0, c[0])
            continue
        # y_i^{e_i} with y_i = sum_a S[i,a] x_a: one slot per factor
        slots = []
        for ax in range(3):
            slots += [ax] * e[ax]
        for assign in _product(range(3), repeat=d):
            tgt = [0, 0, 0]
            for a in assign:
                tgt[a] += 1
            w = c[m]
            for i_slot, a in zip(slots, assign):
                w = w * Sc[i_slot][a]
            acc(idx[tuple(tgt)], w)
    return jnp.stack(out, -1)


# ---------------------------------------------------------------------------
# weighted least-squares fit (per query point, batched)
# ---------------------------------------------------------------------------

def fit_polynomials(query_p, cons_p, cons_n, k_eps, regularization=1e-4):
    """Fit degree-3 implicit polys around each query point.

    query_p: (V, 3); cons_p/cons_n: (V, K, 3) constraint positions/normals
    (pre-gathered K nearest per query); k_eps: (V,) kernel epsilon.
    Returns (V, 20) world-space coefficients (coeff[0] = 0, hard surface
    constraint — fitPolynomialsImpl:303-402) in *scaled* relative
    coordinates rel = (x - query_p) * fit_scale(k_eps).
    """
    V, K, _ = cons_p.shape
    scale = fit_scale(k_eps)                          # (V,)
    rel = (cons_p - query_p[:, None, :]) * scale[:, None, None]
    d2 = jnp.sum((cons_p - query_p[:, None, :]) ** 2, -1)    # (V, K)
    w = jnp.sqrt(jnp.exp(-d2 / (2.0 * k_eps[:, None]))) / np.sqrt(K)
    w = jnp.maximum(w, 1e-6)

    basis = _powers(rel)                              # (V, K, 20)
    # gradient of each basis fn wrt scaled coords: (V, K, 20, 3)
    gbasis = jax.vmap(jax.vmap(
        lambda r: jax.jacfwd(lambda rr: _powers(rr))(r)))(rel)

    # rows: value constraints (=0) + 3 * gradient constraints (= normals)
    A_val = basis * w[..., None]                      # (V, K, 20)
    A_gx = gbasis[..., 0] * w[..., None]
    A_gy = gbasis[..., 1] * w[..., None]
    A_gz = gbasis[..., 2] * w[..., None]
    A = jnp.concatenate([A_val, A_gx, A_gy, A_gz], 1)  # (V, 4K, 20)
    b = jnp.concatenate([
        jnp.zeros((V, K)),
        cons_n[..., 0] * w, cons_n[..., 1] * w, cons_n[..., 2] * w], 1)

    # hard surface constraint: drop the constant column
    A = A[..., 1:]                                    # (V, 4K, 19)
    AtA = jnp.einsum("vki,vkj->vij", A, A)
    reg = regularization * jnp.eye(19)
    # no regularization on the linear terms (fitPolynomialsImpl reg(0..2)=0)
    reg = reg.at[0, 0].set(0.0).at[1, 1].set(0.0).at[2, 2].set(0.0)
    Atb = jnp.einsum("vki,vk->vi", A, b)
    sol = jnp.linalg.solve(AtA + reg, Atb[..., None])[..., 0]  # (V, 19)
    return jnp.concatenate([jnp.zeros((V, 1)), sol], -1)


def poly_normal_and_adjusted_dir(coeffs, in_dir, sh_n):
    """adjustRayDirForPolynomialTracing (polynomials.h:689): evaluate the
    poly gradient at the vertex itself (rel = 0 -> gradient = linear
    coeffs), rotate in_dir by the rotation taking sh_n -> poly normal."""
    g = coeffs[..., 1:4]
    pn = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    axis = jnp.cross(sh_n, pn)
    s = jnp.linalg.norm(axis, axis=-1)
    parallel = s < 1e-8
    axis = axis / jnp.maximum(s, 1e-12)[..., None]
    c = jnp.clip(jnp.sum(pn * sh_n, -1), -1.0, 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - c * c, 0.0))
    # Rodrigues rotation of in_dir about axis by angle(sh_n -> pn)
    d = in_dir
    rot = d * c[..., None] + jnp.cross(axis, d) * sin_t[..., None] \
        + axis * jnp.sum(axis * d, -1, keepdims=True) * (1.0 - c[..., None])
    out_dir = jnp.where(parallel[..., None], d, rot)
    return pn, out_dir
