"""Radiance-field integrator over volumetric ellipsoid primitives.

Re-derivation of the reference's ``volprim_rf_basic``
(src/python/python/ad/integrators/volprim_rf_basic.py:1-188) for the
instanced-icosphere ellipsoid tessellation: the wavefront marches
hit-by-hit through the splat set, each front-facing ellipsoid hit
evaluates the 3DGS transmittance model (Gaussian kernel at the ray-space
peak, "3D Gaussian Ray Tracing") and the SH directional emission, and
the path composites front-to-back

    L += beta * (1 - T) * emission ;  beta *= T

until the throughput drops below 0.01 or max_depth splats were crossed
(volprim_rf_basic.py:121-174).

Wavefront differences from the reference:
  * the ellipsoid parameters live in one SoA table (``Scene.volprims``)
    gathered by hit prim id — no dr.dispatch over shape pointers;
  * backface (exit) hits of the tessellated icospheres are skipped as
    null events, reproducing ellipsoids.cpp:317 backface culling of the
    analytic primitive;
  * gradients flow through opacity / SH / geometry via the bounded-scan
    adjoint (mode="ad"), matching the PRB logic in :146-166 — the hit
    sequence is detached, transmittance and emission are differentiable.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..accel.intersect import ray_intersect
from ..core import math as m
from ..core.rng import Sampler
from ..core.spectrum import srgb_to_linear
from ..core.types import Ray
from ..scene.ir import Scene

Array = jax.Array
INF = jnp.inf


def sh_eval(d: Array, degree: int) -> Array:
    """Real spherical harmonics basis values at directions d (N, 3), up to
    ``degree`` (Sloan 2013 convention, the one dr.sh_eval implements;
    volprim_rf_basic.py:87 sh_dir_coef).  Returns (N, (degree+1)^2)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [jnp.full_like(x, 0.28209479177387814)]
    if degree >= 1:
        out += [-0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [1.0925484305920792 * x * y,
                -1.0925484305920792 * y * z,
                0.94617469575756 * zz - 0.31539156525252,
                -1.0925484305920792 * x * z,
                0.5462742152960396 * (xx - yy)]
    if degree >= 3:
        out += [-0.5900435899266435 * y * (3 * xx - yy),
                2.890611442640554 * x * y * z,
                -0.4570457994644658 * y * (5 * zz - 1.0),
                0.3731763325901154 * z * (5 * zz - 3.0),
                -0.4570457994644658 * x * (5 * zz - 1.0),
                1.445305721320277 * z * (xx - yy),
                -0.5900435899266435 * x * (xx - 3 * yy)]
    return jnp.stack(out, -1)


def eval_transmission(scene: Scene, ell: Array, ray_o: Array, ray_d: Array
                      ) -> Array:
    """3DGS transmittance of ellipsoid ``ell`` along the ray
    (volprim_rf_basic.py:49-78): Gaussian kernel at the ray-space peak,
    T = 1 - min(opacity * exp(-0.5 |p|^2), 0.9999)."""
    vp = scene.volprims
    e = jnp.maximum(ell, 0)
    c = vp.center[e]
    s = jnp.maximum(vp.scale[e], 1e-12)
    R = vp.rot[e]                                   # (N, 3, 3)
    o = jnp.einsum("nji,nj->ni", R, ray_o - c) / s  # R^T (o - c) / s
    d = jnp.einsum("nji,nj->ni", R, ray_d) / s
    t_peak = -jnp.sum(o * d, -1) / jnp.maximum(jnp.sum(d * d, -1), 1e-20)
    p = o + d * t_peak[:, None]
    density = jnp.exp(-0.5 * jnp.sum(p * p, -1))
    return 1.0 - jnp.minimum(vp.opacity[e] * density, 0.9999)


def eval_sh_emission(scene: Scene, ell: Array, ray_d: Array) -> Array:
    """SH directional emission (volprim_rf_basic.py:80-98):
    max(sum_k Y_k(d) c_k + 0.5, 0)."""
    vp = scene.volprims
    e = jnp.maximum(ell, 0)
    Y = sh_eval(ray_d, vp.sh_degree)                # (N, K)
    em = jnp.einsum("nk,nkc->nc", Y, vp.sh[e])
    return jnp.maximum(em + 0.5, 0.0)


@struct.dataclass
class VPState:
    active: Array
    ray_o: Array
    L: Array
    beta: Array
    depth: Array


def _bounce(scene: Scene, ray_d: Array, st: VPState) -> VPState:
    si = ray_intersect(scene, Ray(o=st.ray_o, d=ray_d,
                                  maxt=jnp.full(st.ray_o.shape[:1], INF)))
    prim = jnp.maximum(si.prim, 0)
    ell = jnp.where(si.valid & (si.prim >= 0),
                    scene.volprims.tri_ell[prim], -1)
    active = st.active & si.valid
    is_prim = active & (ell >= 0)
    # exit (backfacing) tessellation hits are null events
    # (ellipsoids.cpp:317 backface culling)
    entry = jnp.sum(si.ng * ray_d, -1) < 0.0
    evals = is_prim & entry

    T = jnp.where(evals, eval_transmission(scene, ell, st.ray_o, ray_d), 1.0)
    em = eval_sh_emission(scene, ell, ray_d)
    Le = st.beta * (1.0 - T)[:, None] * em
    Le = jnp.where(jnp.isfinite(Le), Le, 0.0)
    L = st.L + jnp.where(evals[:, None], Le, 0.0)
    beta = st.beta * jnp.where(evals, T, 1.0)[:, None]
    # spawn past the hit (reference avoids spawn_ray on purpose, :145)
    o = jnp.where(active[:, None], si.p + ray_d * 1e-4, st.ray_o)
    depth = st.depth + jnp.where(evals, 1, 0)
    alive = active & (jnp.max(beta, -1) > 0.01) & (depth < scene.max_depth)
    return VPState(active=alive, ray_o=o, L=L, beta=beta, depth=depth)


def sample(scene: Scene, sampler: Sampler, ray: Ray, mode: str = "primal"):
    """Wavefront volprim march.  Returns (L, valid, sampler) like every
    integrator in common._integrator_sample."""
    n = ray.o.shape[0]
    ray_d = m.normalize(ray.d)
    st = VPState(active=jnp.ones((n,), bool), ray_o=ray.o,
                 L=jnp.zeros((n, 3)), beta=jnp.ones((n, 3)),
                 depth=jnp.zeros((n,), jnp.int32))
    # each splat costs 2 tessellation hits (entry + exit)
    max_iters = 2 * scene.max_depth + 2
    if mode == "primal":
        def cond(c):
            s, it = c
            return jnp.any(s.active) & (it < max_iters)

        def body(c):
            s, it = c
            return _bounce(scene, ray_d, s), it + 1
        st, _ = jax.lax.while_loop(cond, body, (st, 0))
    else:
        body = jax.checkpoint(lambda s: _bounce(scene, ray_d, s))

        def step(s, _):
            return body(s), None
        st, _ = jax.lax.scan(step, st, None, length=max_iters)
    L = st.L
    if scene.volprims.srgb:
        # :176-178 sRGB -> linear on the composited radiance
        L = srgb_to_linear(jnp.clip(L, 0.0, None))
    return L, jnp.ones((n,), bool), sampler
