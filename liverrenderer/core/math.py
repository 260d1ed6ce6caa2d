"""Batched vector math helpers (analog of reference include/mitsuba/core/
{vector.h,frame.h,math.h} utilities), written as fusible jnp ops."""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .types import Frame


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def norm(v):
    # forward-exact but grad-safe at v=0: sqrt'(0)=inf would turn the
    # zero cotangent of masked lanes into nan (inf*0)
    n2 = jnp.sum(v * v, axis=-1)
    zero = n2 == 0.0
    return jnp.where(zero, 0.0, jnp.sqrt(jnp.where(zero, 1.0, n2)))


def normalize(v, eps=1e-20):
    # max on the SQUARED norm keeps the backward finite at v = 0 (the
    # max(sqrt(x), eps) form still differentiates sqrt at x=0 -> inf*0=nan)
    n2 = jnp.sum(v * v, axis=-1)
    return v / jnp.sqrt(jnp.maximum(n2, eps * eps))[..., None]


def cross(a, b):
    return jnp.cross(a, b)


@jax.custom_jvp
def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    # sqrt's derivative blows up at 0; masked-SIMD dispatch feeds exact
    # zeros here for lanes of OTHER bsdf families (e.g. fresnel_conductor
    # with eta_im = 0), and the resulting inf Jacobian x 0 cotangent NaNs
    # every reverse pass that touches the family (vertex gradients through
    # roughconductor).  Clamp the derivative instead.
    (x,), (dx,) = primals, tangents
    y = jnp.sqrt(jnp.maximum(x, 0.0))
    dy = jnp.where(x > 1e-12, 0.5 / jnp.maximum(y, 1e-12), 0.0) * dx
    return y, dy


def safe_rsqrt(x):
    return jnp.where(x > 0, 1.0 / jnp.sqrt(jnp.maximum(x, 1e-30)), 0.0)


def safe_acos(x):
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def rcp(x, eps=0.0):
    return 1.0 / x


def safe_rcp(x, eps=1e-20):
    return jnp.where(jnp.abs(x) > eps, 1.0 / jnp.where(x == 0, 1.0, x), 0.0)


def sqr(x):
    return x * x


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta=2), matching reference path.cpp:370-376 /
    biovolpath.cpp:554-559.  Detached: MIS weights are sampling-density
    ratios, excluded from differentiation (ad/integrators/common.py
    detached-sampling rules)."""
    import jax
    a2 = pdf_a * pdf_a
    w = a2 / jnp.maximum(a2 + pdf_b * pdf_b, 1e-38)
    return jax.lax.stop_gradient(jnp.where(jnp.isfinite(w), w, 0.0))


def coordinate_system(n):
    """Build (s, t) orthogonal to n. Duff et al. branchless ONB, as used by the
    reference Frame3f ctor (include/mitsuba/core/vector.h coordinate_system)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    t = jnp.stack([b, sign + ny * ny * a, -ny], -1)
    return s, t


def make_frame(n) -> Frame:
    s, t = coordinate_system(n)
    return Frame(s=s, t=t, n=n)


def cos_theta(v):
    """z-component in a local frame (reference frame.h Frame3f::cos_theta)."""
    return v[..., 2]


def sin_theta_2(v):
    return jnp.maximum(1.0 - v[..., 2] * v[..., 2], 0.0)


def sph_to_dir(theta, phi):
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return jnp.stack([st * cp, st * sp, ct], -1)


def dir_to_sph(d):
    theta = safe_acos(d[..., 2])
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    return theta, phi


def reflect(wi):
    """Local-frame mirror reflection of incident dir wi (pointing away)."""
    return jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)


def refract_local(wi, cos_theta_t, eta_ti):
    """Local-frame refraction; cos_theta_t from fresnel(), eta_ti = 1/eta of
    the transmission (reference fresnel.h refract)."""
    return jnp.stack([
        -eta_ti * wi[..., 0],
        -eta_ti * wi[..., 1],
        cos_theta_t,
    ], -1)


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def luminance(c):
    return (0.212671 * c[..., 0] + 0.715160 * c[..., 1]
            + 0.072169 * c[..., 2])


def table_lookup(table, idx):
    """Per-lane row lookup from a parameter table.

    Tiny static tables (the common case for plugin parameter rows) become
    branchless select chains that fuse into the surrounding kernel instead
    of per-lane gathers; large tables stay real gathers.
    """
    R = table.shape[0]
    out_shape = idx.shape + table.shape[1:]
    if R == 1:
        return jnp.broadcast_to(table[0], out_shape)
    if R <= 8:
        exp = idx.reshape(idx.shape + (1,) * (table.ndim - 1))
        out = jnp.broadcast_to(table[0], out_shape)
        for r in range(1, R):
            out = jnp.where(exp == r, table[r], out)
        return out
    return table[idx]
