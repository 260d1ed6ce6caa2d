"""Device-side ray intersection (the render hot path).

Functional contract mirrors reference Scene::ray_intersect / ray_test
(include/mitsuba/render/scene.h:79-316), replacing Embree/OptiX/kd-tree with
three strategies:

* ``brute``: all lanes x all triangles in fixed-size chunks via `lax.scan` —
  branch-free, fully vectorized, optimal for small scenes (the Cornell box,
  the analytic liver spheres) where a BVH's gather-divergence costs more
  than brute FLOPs.
* ``bvh``: lockstep stack-based traversal of the flattened 2-wide BVH
  (accel/bvh.py) in a `lax.while_loop`; every lane keeps a register stack.
* ``pallas``: the fused closest-hit GPU kernel (accel/pallas_intersect.py).

Each returns hit (t, prim, barycentrics) which `compute_si` turns into a full
SurfaceInteraction.  Selection is static per scene (`_tri_strategy`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.types import Frame, Ray, SurfaceInteraction, INF
from ..scene.ir import Scene, SHAPE_SPHERE

TRI_CHUNK = 128


def _moeller_trumbore(o, d, p0, e1, e2):
    """Batched Möller-Trumbore: o,d (N,3); p0,e1,e2 (...,3) broadcastable.
    Returns (t, u, v, hit)."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, -1)
    # the unsafe branch's denominator must be replaced BEFORE the divide:
    # masking only the value leaves 1/det^2 in the backward, which
    # overflows to inf for subnormal dets and nans masked lanes' grads
    safe = jnp.abs(det) > 1e-12
    inv_det = jnp.where(safe, 1.0 / jnp.where(safe, det, 1.0), 0.0)
    tvec = o - p0
    u = jnp.sum(tvec * pvec, -1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, -1) * inv_det
    t = jnp.sum(e2 * qvec, -1) * inv_det
    hit = (jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) \
        & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, hit


def _ray_aabb(o, inv_d, maxt, bmin, bmax):
    """Slab test; returns entry-t and hit mask. All shapes broadcastable."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    near = jnp.max(tmin, -1)
    far = jnp.min(tmax, -1)
    hit = (near <= far) & (far > 0.0) & (near < maxt)
    return jnp.maximum(near, 0.0), hit


# ---------------------------------------------------------------------------
# Triangle stream intersection
# ---------------------------------------------------------------------------

def _gather_tri(scene: Scene, tri_idx):
    f = scene.faces[tri_idx]
    p0 = scene.vertices[f[..., 0]]
    p1 = scene.vertices[f[..., 1]]
    p2 = scene.vertices[f[..., 2]]
    return p0, p1 - p0, p2 - p0


def _brute_tris(scene: Scene, ray: Ray, t_best, any_hit: bool):
    """Chunked brute force over the global triangle stream."""
    T = scene.n_tris
    if T == 0:
        N = ray.o.shape[0]
        return t_best, jnp.full((N,), -1, jnp.int32), \
            jnp.zeros((N,)), jnp.zeros((N,))
    n_chunks = (T + TRI_CHUNK - 1) // TRI_CHUNK
    Tp = n_chunks * TRI_CHUNK
    # Pad the triangle stream once (degenerate tris never hit).
    pad = Tp - T
    faces = jnp.pad(scene.faces, ((0, pad), (0, 0)))
    p0 = scene.vertices[faces[:, 0]]
    p1 = scene.vertices[faces[:, 1]]
    p2 = scene.vertices[faces[:, 2]]
    valid_tri = jnp.arange(Tp) < T
    e1 = jnp.where(valid_tri[:, None], p1 - p0, 0.0)
    e2 = jnp.where(valid_tri[:, None], p2 - p0, 0.0)
    p0c = p0.reshape(n_chunks, TRI_CHUNK, 3)
    e1c = e1.reshape(n_chunks, TRI_CHUNK, 3)
    e2c = e2.reshape(n_chunks, TRI_CHUNK, 3)

    o = ray.o[:, None, :]
    d = ray.d[:, None, :]

    def body(carry, chunk):
        t_best, prim, uu, vv = carry
        cp0, ce1, ce2, base = chunk
        t, u, v, hit = _moeller_trumbore(o, d, cp0[None], ce1[None], ce2[None])
        hit &= t < t_best[:, None]
        # closest within chunk
        t_masked = jnp.where(hit, t, INF)
        j = jnp.argmin(t_masked, axis=1)
        tj = jnp.take_along_axis(t_masked, j[:, None], 1)[:, 0]
        better = tj < t_best
        prim = jnp.where(better, base + j.astype(jnp.int32), prim)
        uu = jnp.where(better, jnp.take_along_axis(u, j[:, None], 1)[:, 0], uu)
        vv = jnp.where(better, jnp.take_along_axis(v, j[:, None], 1)[:, 0], vv)
        t_best = jnp.where(better, tj, t_best)
        return (t_best, prim, uu, vv), None

    N = ray.o.shape[0]
    init = (t_best, jnp.full((N,), -1, jnp.int32),
            jnp.zeros((N,)), jnp.zeros((N,)))
    bases = jnp.arange(n_chunks, dtype=jnp.int32) * TRI_CHUNK
    (t_best, prim, uu, vv), _ = jax.lax.scan(
        body, init, (p0c, e1c, e2c, bases))
    return t_best, prim, uu, vv


def _bvh_tris(scene: Scene, ray: Ray, t_best, any_hit: bool):
    """Lockstep stack traversal; all lanes in one while_loop."""
    bvh = scene.bvh
    N = ray.o.shape[0]
    D = bvh.depth + 2
    d_safe = jnp.where(jnp.abs(ray.d) < 1e-12,
                       jnp.where(ray.d >= 0, 1e-12, -1e-12), ray.d)
    inv_d = 1.0 / d_safe

    stack = jnp.zeros((N, D), jnp.int32)
    sp = jnp.ones((N,), jnp.int32)          # stack holds root (=0) at slot 0
    prim = jnp.full((N,), -1, jnp.int32)
    uu = jnp.zeros((N,))
    vv = jnp.zeros((N,))

    max_leaf = 8 * 4  # MAX_LEAF fat-leaf bound from bvh.py

    def cond(state):
        sp = state[1]
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, t_best, prim, uu, vv = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack, top[:, None], 1)[:, 0]
        node = jnp.where(active, node, 0)
        sp = jnp.where(active, sp - 1, sp)

        nmin = bvh.node_min[node]
        nmax = bvh.node_max[node]
        near, hit_box = _ray_aabb(ray.o, inv_d, jnp.minimum(ray.maxt, t_best),
                                  nmin, nmax)
        hit_box &= active

        is_leaf = bvh.right[node] < 0
        # ---- leaf: test up to `count` prims serially (count<=32) ----
        first = bvh.first[node]
        cnt = bvh.count[node]

        def leaf_body(k, carry):
            t_best, prim, uu, vv = carry
            li = jnp.clip(first + k, 0, bvh.perm.shape[0] - 1)
            tri = bvh.perm[li]
            p0, e1, e2 = _gather_tri(scene, tri)
            t, u, v, h = _moeller_trumbore(ray.o, ray.d, p0, e1, e2)
            h &= hit_box & is_leaf & (k < cnt) & (t < t_best) & (t < ray.maxt)
            t_best = jnp.where(h, t, t_best)
            prim = jnp.where(h, tri, prim)
            uu = jnp.where(h, u, uu)
            vv = jnp.where(h, v, vv)
            return t_best, prim, uu, vv

        t_best, prim, uu, vv = jax.lax.fori_loop(
            0, max_leaf, leaf_body, (t_best, prim, uu, vv))

        # ---- internal: push children (near-first ordering skipped r1) ----
        push = hit_box & ~is_leaf
        left = node + 1
        right = bvh.right[node]
        # push right then left so left pops first
        stack = _stack_push(stack, sp, right, push)
        sp = jnp.where(push, sp + 1, sp)
        stack = _stack_push(stack, sp, left, push)
        sp = jnp.where(push, sp + 1, sp)
        return stack, sp, t_best, prim, uu, vv

    state = (stack, sp, t_best, prim, uu, vv)
    stack, sp, t_best, prim, uu, vv = jax.lax.while_loop(cond, body, state)
    return t_best, prim, uu, vv


def _stack_push(stack, sp, val, mask):
    D = stack.shape[1]
    slot = jnp.clip(sp, 0, D - 1)
    onehot = jax.nn.one_hot(slot, D, dtype=stack.dtype)
    newval = val[:, None] * onehot
    keep = 1 - onehot * mask[:, None].astype(stack.dtype)
    return stack * keep + newval * mask[:, None].astype(stack.dtype)


# ---------------------------------------------------------------------------
# Instanced shapegroups (non-flattened instancing)
# ---------------------------------------------------------------------------

def _instances(scene: Scene, ray: Ray, t_best, prim, uu, vv):
    """Instanced-geometry pass (reference src/shapes/{shapegroup,
    instance}.cpp): a `lax.scan` over instances; each instance transforms
    the SHARED group-local triangle stream into world space chunk-by-chunk
    (a handful of 3-vectors broadcast over all lanes — the same
    vertex-then-subtract ops the flattening baker performs, so instanced
    and flattened renders agree to fp32 rounding) and runs the dense
    Möller-Trumbore sweep.  A per-instance world-AABB test cond-skips the
    whole chunk loop when no lane can hit.  Hits are encoded
    prim = n_tris + instance * n_inst_tris + group_tri."""
    from ..scene.ir import INST_CHUNK
    n_tris = scene.n_tris
    Tg = scene.n_inst_tris
    tris = scene.inst_tris
    d_safe = jnp.where(jnp.abs(ray.d) < 1e-12,
                       jnp.where(ray.d >= 0, 1e-12, -1e-12), ray.d)
    inv_d = 1.0 / d_safe
    o = ray.o[:, None, :]
    dd = ray.d[:, None, :]

    def inst_body(carry, xs):
        t_best, prim, uu, vv = carry
        xf, start, nch, bmin, bmax, iid = xs
        M = xf[:12].reshape(3, 4)
        _, box_hit = _ray_aabb(ray.o, inv_d,
                               jnp.minimum(ray.maxt, t_best),
                               bmin[None], bmax[None])

        def sweep(carry):
            def chunk_body(c, carry2):
                t_best, prim, uu, vv = carry2
                off = start + c * INST_CHUNK
                blk = jax.lax.dynamic_slice(
                    tris, (off, jnp.int32(0), jnp.int32(0)),
                    (INST_CHUNK, 3, 3))
                pw = blk @ M[:, :3].T + M[:, 3]          # (C, 3, 3)
                p0 = pw[:, 0]
                e1 = pw[:, 1] - pw[:, 0]
                e2 = pw[:, 2] - pw[:, 0]
                t, u, v, hit = _moeller_trumbore(o, dd, p0[None],
                                                 e1[None], e2[None])
                hit &= (t < t_best[:, None]) & (t < ray.maxt[:, None]) \
                    & (c < nch)
                t_masked = jnp.where(hit, t, INF)
                j = jnp.argmin(t_masked, axis=1)
                tj = jnp.take_along_axis(t_masked, j[:, None], 1)[:, 0]
                better = tj < t_best
                code = n_tris + iid.astype(jnp.int32) * Tg \
                    + off.astype(jnp.int32) + j.astype(jnp.int32)
                prim = jnp.where(better, code, prim)
                uu = jnp.where(
                    better, jnp.take_along_axis(u, j[:, None], 1)[:, 0], uu)
                vv = jnp.where(
                    better, jnp.take_along_axis(v, j[:, None], 1)[:, 0], vv)
                t_best = jnp.where(better, tj, t_best)
                return t_best, prim, uu, vv

            return jax.lax.fori_loop(0, scene.inst_max_chunks, chunk_body,
                                     carry)

        carry = jax.lax.cond(jnp.any(box_hit), sweep, lambda c: c, carry)
        return carry, None

    xs = (scene.inst_xf, scene.inst_face_start, scene.inst_n_chunks,
          scene.inst_bmin, scene.inst_bmax,
          jnp.arange(scene.n_instances, dtype=jnp.int32))
    (t_best, prim, uu, vv), _ = jax.lax.scan(
        inst_body, (t_best, prim, uu, vv), xs)
    return t_best, prim, uu, vv


# ---------------------------------------------------------------------------
# Analytic spheres
# ---------------------------------------------------------------------------

def _spheres(scene: Scene, ray: Ray, t_best):
    """Intersect all analytic spheres (few per scene -> brute force)."""
    Sp = scene.n_spheres
    N = ray.o.shape[0]
    sph = jnp.full((N,), -1, jnp.int32)
    if Sp == 0:
        return t_best, sph
    c = scene.sph_center[None]          # (1, Sp, 3)
    r = scene.sph_radius[None]          # (1, Sp)
    o = ray.o[:, None, :] - c
    d = ray.d[:, None, :]
    b = jnp.sum(o * d, -1)
    cc = jnp.sum(o * o, -1) - r * r
    disc = b * b - cc
    sq = m.safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where(t0 > 1e-5, t0, jnp.where(t1 > 1e-5, t1, INF))
    t = jnp.where(disc > 0, t, INF)
    j = jnp.argmin(t, axis=1)
    tj = jnp.take_along_axis(t, j[:, None], 1)[:, 0]
    better = tj < t_best
    sph = jnp.where(better, j.astype(jnp.int32), sph)
    t_best = jnp.where(better, tj, t_best)
    return t_best, sph


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _pallas_tris(scene: Scene, ray: Ray, t_best, any_hit: bool):
    from .pallas_intersect import intersect_tris
    t, prim = intersect_tris(scene.tri_buf, scene.tri_boxes, ray.o, ray.d,
                             ray.maxt, t_best, scene.tri_center)
    # the kernel carries only (t, prim); compute_si re-derives u, v
    better = (prim >= 0) & (t < t_best)
    zero = jnp.zeros_like(t)
    return jnp.where(better, t, t_best), jnp.where(better, prim, -1), \
        zero, zero


# largest mesh the XLA chunked sweep takes before the lockstep BVH.  This
# routes CPU runs; on a GPU the kernel takes every mesh up to its cap, and the
# BVH above it (at 64k rays on an H100 the sweep lost to the BVH at 327,680
# triangles, so a GPU crossover only matters past the kernel's cap)
MAX_BRUTE_TRIS = 8192


def _placement_backend() -> str:
    """Platform the traced computation runs on: the default device when one
    is set (`jax.default_device`, e.g. a CPU reference run in a GPU
    process), else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def _tri_strategy(scene: Scene, backend: str | None = None):
    """The triangle intersector: `scene.intersector` when forced, else the
    Pallas kernel on the GPU up to its cap, then the XLA sweep for small
    meshes and the lockstep BVH for large ones."""
    if scene.intersector == "brute":
        return _brute_tris
    if scene.intersector == "bvh":
        return _bvh_tris
    if scene.intersector == "pallas":
        return _pallas_tris
    from .pallas_intersect import MAX_KERNEL_TRIS
    backend = backend or _placement_backend()
    if backend == "gpu" and 0 < scene.n_tris <= MAX_KERNEL_TRIS:
        return _pallas_tris
    return _brute_tris if scene.n_tris <= MAX_BRUTE_TRIS else _bvh_tris


_SDF_STEPS = 96


def _sdf_trilinear(grid, whd, p):
    """Trilinear SDF sample at local p (N,3) in [0,1]^3; grid (D,H,W)."""
    W = (whd[0] - 1).astype(jnp.float32)
    H = (whd[1] - 1).astype(jnp.float32)
    D = (whd[2] - 1).astype(jnp.float32)
    fx = jnp.clip(p[:, 0], 0.0, 1.0) * W
    fy = jnp.clip(p[:, 1], 0.0, 1.0) * H
    fz = jnp.clip(p[:, 2], 0.0, 1.0) * D
    x0 = jnp.clip(fx.astype(jnp.int32), 0, (whd[0] - 2))
    y0 = jnp.clip(fy.astype(jnp.int32), 0, (whd[1] - 2))
    z0 = jnp.clip(fz.astype(jnp.int32), 0, (whd[2] - 2))
    tx = fx - x0
    ty = fy - y0
    tz = fz - z0

    def g(dz, dy, dx):
        return grid[z0 + dz, y0 + dy, x0 + dx]

    c00 = g(0, 0, 0) * (1 - tx) + g(0, 0, 1) * tx
    c01 = g(0, 1, 0) * (1 - tx) + g(0, 1, 1) * tx
    c10 = g(1, 0, 0) * (1 - tx) + g(1, 0, 1) * tx
    c11 = g(1, 1, 0) * (1 - tx) + g(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def _sdfs(scene: Scene, ray: Ray, t_best):
    """Sphere-trace SDF grid shapes (sdfgrid.cpp capability): a fixed-count
    masked march with no data-dependent trip counts.
    Returns (t_best, sdf_idx)."""
    N = ray.o.shape[0]
    sdf_idx = jnp.full((N,), -1, jnp.int32)
    eps = 1e-3
    for k in range(scene.n_sdfs):
        A = scene.sdf_to_local[k]
        o_l = ray.o @ A[:3, :3].T + A[:3, 3]
        d_l = ray.d @ A[:3, :3].T
        dl_len = jnp.maximum(m.norm(d_l), 1e-12)
        inv = 1.0 / jnp.where(jnp.abs(d_l) > 1e-12, d_l, 1e-12)
        t0 = (0.0 - o_l) * inv
        t1 = (1.0 - o_l) * inv
        near = jnp.max(jnp.minimum(t0, t1), -1)
        far = jnp.min(jnp.maximum(t0, t1), -1)
        box = (near <= far) & (far > 0.0) & (near < t_best)
        t = jnp.maximum(near, 0.0) + 1e-5

        grid = scene.sdf_grids[k]
        whd = scene.sdf_whd[k]

        def body(i, carry):
            t, hit, dead = carry
            p = o_l + t[:, None] * d_l
            val = _sdf_trilinear(grid, whd, p)
            conv = (val < eps) & ~dead
            t_next = t + jnp.maximum(val, 0.25 * eps) / dl_len
            dead2 = dead | conv | (t_next > jnp.minimum(far, t_best))
            t = jnp.where(dead, t, t_next)
            # keep t at the converged point, not the advanced one
            t = jnp.where(conv, t - jnp.maximum(val, 0.25 * eps) / dl_len, t)
            return t, hit | conv, dead2

        t_sdf, hit, _ = jax.lax.fori_loop(
            0, _SDF_STEPS, body,
            (t, jnp.zeros(N, bool), ~box))
        t_sdf = jax.lax.stop_gradient(t_sdf)
        take = hit & (t_sdf < t_best) & (t_sdf > 1e-5)
        t_best = jnp.where(take, t_sdf, t_best)
        sdf_idx = jnp.where(take, k, sdf_idx)
    return t_best, sdf_idx


def _sdf_trilinear_lanes(scene: Scene, k, p):
    """Trilinear SDF sample with a per-lane grid index k (N,), p (N,3)."""
    whd = scene.sdf_whd[k]                         # (N,3)
    W = (whd[:, 0] - 1).astype(jnp.float32)
    H = (whd[:, 1] - 1).astype(jnp.float32)
    D = (whd[:, 2] - 1).astype(jnp.float32)
    fx = jnp.clip(p[:, 0], 0.0, 1.0) * W
    fy = jnp.clip(p[:, 1], 0.0, 1.0) * H
    fz = jnp.clip(p[:, 2], 0.0, 1.0) * D
    x0 = jnp.clip(fx.astype(jnp.int32), 0, whd[:, 0] - 2)
    y0 = jnp.clip(fy.astype(jnp.int32), 0, whd[:, 1] - 2)
    z0 = jnp.clip(fz.astype(jnp.int32), 0, whd[:, 2] - 2)
    tx, ty, tz = fx - x0, fy - y0, fz - z0

    def g(dz, dy, dx):
        return scene.sdf_grids[k, z0 + dz, y0 + dy, x0 + dx]

    c00 = g(0, 0, 0) * (1 - tx) + g(0, 0, 1) * tx
    c01 = g(0, 1, 0) * (1 - tx) + g(0, 1, 1) * tx
    c10 = g(1, 0, 0) * (1 - tx) + g(1, 0, 1) * tx
    c11 = g(1, 1, 0) * (1 - tx) + g(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def ray_intersect_preliminary(scene: Scene, ray: Ray):
    """Returns (t, prim, u, v, sph_idx). prim=-1 & sph=-1 => miss.
    SDF-grid hits are encoded as sph_idx = n_spheres + k."""
    N = ray.o.shape[0]
    t_best = jnp.where(jnp.isfinite(ray.maxt), ray.maxt, INF)
    t_best = jnp.minimum(t_best, INF)
    strat = _tri_strategy(scene)
    t_best, prim, uu, vv = strat(scene, ray, t_best, any_hit=False)
    if scene.n_instances:
        t_best, prim, uu, vv = _instances(scene, ray, t_best, prim, uu, vv)
    t_best, sph = _spheres(scene, ray, t_best)
    if scene.n_sdfs:
        t_best, sdf = _sdfs(scene, ray, t_best)
        sph = jnp.where(sdf >= 0, scene.n_spheres + sdf, sph)
    prim = jnp.where(sph >= 0, -1, prim)
    return t_best, prim, uu, vv, sph


def ray_test(scene: Scene, ray: Ray):
    """Shadow-ray occlusion query (scene.h ray_test)."""
    t, prim, _, _, sph = ray_intersect_preliminary(scene, ray)
    return (prim >= 0) | (sph >= 0)


def compute_si(scene: Scene, ray: Ray, t, prim, u, v, sph) -> SurfaceInteraction:
    """Fill a full SurfaceInteraction from a preliminary hit
    (analog of PreliminaryIntersection3f::compute_surface_interaction)."""
    N = ray.o.shape[0]
    hit_tri = prim >= 0
    hit_sph = sph >= 0
    hit = hit_tri | hit_sph

    # miss lanes carry garbage preliminary (t, u, v) (inf best-t, strategy-
    # dependent barycentrics); p_tri = p0 + e1*u + ... with non-finite u
    # poisons the BACKWARD of every masked consumer (0 cotangent x
    # inf Jacobian lands on the tri_si gather), so sanitize BEFORE use —
    # t_out below restores INF for misses
    u = jnp.where(hit_tri & jnp.isfinite(u), u, 0.0)
    v = jnp.where(hit_tri & jnp.isfinite(v), v, 0.0)
    t = jnp.where(hit & jnp.isfinite(t), t, 1.0)

    # instanced hits arrive encoded prim = n_tris + inst*Tg + group_tri
    # (accel _instances); decode the lane's (instance, group-tri) pair
    is_inst = hit_tri & (prim >= scene.n_tris) if scene.n_instances \
        else jnp.zeros_like(hit_tri)
    prim_s = jnp.clip(prim, 0, max(scene.n_tris - 1, 0))
    # single packed gather per lane (see Scene.tri_si)
    row = scene.tri_si[prim_s]
    p0 = row[:, 0:3]
    e1 = row[:, 3:6]
    e2 = row[:, 6:9]
    # hit FINDING is detached (ray_intersect stops gradients on the
    # preliminary); re-derive the winner's (t, u, v) DIFFERENTIABLY from
    # the packed tri_si row so interior geometry gradients flow through
    # si.p/ns/uv — and so the Pallas kernel (which carries only (t, prim)
    # through its reduction) gets barycentrics at all
    tt, uu2, vv2, hh = _moeller_trumbore(ray.o, ray.d, p0, e1, e2)
    ok = hit_tri & ~is_inst & hh
    u = jnp.where(ok, uu2, u)
    v = jnp.where(ok, vv2, v)
    t = jnp.where(ok, tt, t)
    if scene.n_instances:
        # group-local row + instance transform (two gathers per lane,
        # once per bounce — same budget class as the tri_si row); the
        # transform-then-subtract ordering matches the flattening baker
        code = jnp.maximum(prim - scene.n_tris, 0)
        iid = code // scene.n_inst_tris
        gtri = code % scene.n_inst_tris
        irow = scene.inst_si[gtri]
        xf = scene.inst_xf[iid]
        M = xf[:, :12].reshape(-1, 3, 4)
        Nm = xf[:, 12:21].reshape(-1, 3, 3)

        def xform_p(pl):
            return jnp.einsum("nij,nj->ni", M[:, :, :3], pl) + M[:, :, 3]

        ip0 = xform_p(irow[:, 0:3])
        ie1 = xform_p(irow[:, 3:6]) - ip0
        ie2 = xform_p(irow[:, 6:9]) - ip0
        itt, iu, iv, ihh = _moeller_trumbore(ray.o, ray.d, ip0, ie1, ie2)
        iok = is_inst & ihh
        u = jnp.where(iok, iu, u)
        v = jnp.where(iok, iv, v)
        t = jnp.where(iok, itt, t)
        p0 = jnp.where(is_inst[:, None], ip0, p0)
        e1 = jnp.where(is_inst[:, None], ie1, e1)
        e2 = jnp.where(is_inst[:, None], ie2, e2)

        def xform_n(nl):
            out = jnp.einsum("nij,nj->ni", Nm, nl)
            return out / jnp.maximum(m.norm(out), 1e-20)[:, None]

        in0 = xform_n(irow[:, 9:12])
        in1 = xform_n(irow[:, 12:15])
        in2 = xform_n(irow[:, 15:18])
        # splice the instanced lanes' per-vertex data into the row so the
        # shared interpolation below covers both cases
        row = jnp.where(
            is_inst[:, None],
            jnp.concatenate([ip0, ie1, ie2, in0, in1, in2,
                             irow[:, 18:25]], -1), row)
    w = 1.0 - u - v
    p_tri = p0 + e1 * u[:, None] + e2 * v[:, None]
    ng_tri = m.normalize(jnp.cross(e1, e2))
    ns_tri = row[:, 9:12] * w[:, None] + row[:, 12:15] * u[:, None] \
        + row[:, 15:18] * v[:, None]
    ns_len = m.norm(ns_tri)
    ns_tri = jnp.where((ns_len > 1e-6)[:, None], ns_tri / jnp.maximum(ns_len, 1e-6)[:, None], ng_tri)
    uv_tri = row[:, 18:20] * w[:, None] + row[:, 20:22] * u[:, None] \
        + row[:, 22:24] * v[:, None]
    shape_tri = row[:, 24].astype(jnp.int32)

    # spheres
    sph_s = jnp.maximum(sph, 0)
    c = m.table_lookup(scene.sph_center, sph_s)
    r = m.table_lookup(scene.sph_radius, sph_s)
    # miss lanes carry t=INF; inf positions poison the BACKWARD of the
    # masked sphere branch (0 cotangent x nan forward), so clamp first
    t_sph = jnp.where(hit_sph, t, 1.0)
    p_sph_raw = ray.at(t_sph)
    ns_sph = m.normalize(p_sph_raw - c)
    p_sph = c + ns_sph * r[:, None]   # re-project for robustness
    theta = m.safe_acos(ns_sph[..., 2])
    phi = jnp.arctan2(ns_sph[..., 1], ns_sph[..., 0])
    uv_sph = jnp.stack([(phi + jnp.pi) / (2 * jnp.pi), theta / jnp.pi], -1)
    shape_sph = m.table_lookup(scene.sph_shape, sph_s)

    p = jnp.where(hit_sph[:, None], p_sph, p_tri)
    ng = jnp.where(hit_sph[:, None], ns_sph, ng_tri)
    ns = jnp.where(hit_sph[:, None], ns_sph, ns_tri)
    uv = jnp.where(hit_sph[:, None], uv_sph, uv_tri)
    shape = jnp.where(hit_sph, shape_sph,
                      jnp.where(hit_tri, shape_tri, -1)).astype(jnp.int32)

    if scene.n_sdfs:
        # SDF hits arrive encoded as sph = n_spheres + k; normal = grid
        # gradient (central differences in local space, mapped by A^T)
        is_sdf = hit_sph & (sph >= scene.n_spheres)
        k = jnp.clip(sph - scene.n_spheres, 0, scene.n_sdfs - 1)
        A = scene.sdf_to_local[k]                      # (N,4,4)
        p_w = ray.at(jnp.where(is_sdf, t, 1.0))
        p_l = jnp.einsum("nij,nj->ni", A[:, :3, :3], p_w) + A[:, :3, 3]
        h = 0.5 / jnp.max(scene.sdf_whd[k], -1).astype(jnp.float32)
        grad = []
        for ax in range(3):
            off = jnp.zeros((1, 3)).at[0, ax].set(1.0)
            vp = _sdf_trilinear_lanes(scene, k, p_l + off * h[:, None])
            vm = _sdf_trilinear_lanes(scene, k, p_l - off * h[:, None])
            grad.append(vp - vm)
        g_l = jnp.stack(grad, -1)
        n_w = m.normalize(jnp.einsum("nij,ni->nj", A[:, :3, :3], g_l))
        p = jnp.where(is_sdf[:, None], p_w, p)
        ng = jnp.where(is_sdf[:, None], n_w, ng)
        ns = jnp.where(is_sdf[:, None], n_w, ns)
        uv = jnp.where(is_sdf[:, None], p_l[:, :2], uv)
        shape = jnp.where(is_sdf, scene.sdf_shape[k], shape)

    t_out = jnp.where(hit, t, INF)
    attr = None
    if scene.has_vertex_attr:
        fa = scene.faces[prim_s]
        attr = scene.vertex_attrs[fa[:, 0]] * w[:, None] \
            + scene.vertex_attrs[fa[:, 1]] * u[:, None] \
            + scene.vertex_attrs[fa[:, 2]] * v[:, None]
    frame = m.make_frame(ns)
    if scene.has_tangents:
        # curve tubes: align the frame's s-axis with the interpolated fiber
        # tangent so the hair BSDF's +x convention holds (scene/curves.py)
        f = scene.faces[prim_s]
        tg = scene.tangents[f[:, 0]] * w[:, None] \
            + scene.tangents[f[:, 1]] * u[:, None] \
            + scene.tangents[f[:, 2]] * v[:, None]
        tg = tg - jnp.sum(tg * ns, -1, keepdims=True) * ns
        tl = m.norm(tg)
        use = (tl > 1e-6) & hit_tri
        s = jnp.where(use[:, None], tg / jnp.maximum(tl, 1e-6)[:, None],
                      frame.s)
        tvec = jnp.where(use[:, None], jnp.cross(ns, s), frame.t)
        frame = frame.replace(s=s, t=tvec)
    wi_local = frame.to_local(-ray.d)
    si_kwargs = {}
    if attr is not None:
        si_kwargs["attr"] = attr
    return SurfaceInteraction(
        t=t_out, p=p, ng=ng, sh_frame=frame, uv=uv, wi=wi_local,
        prim=jnp.where(hit_sph, sph, prim).astype(jnp.int32), shape=shape,
        **si_kwargs)


def ray_intersect(scene: Scene, ray: Ray) -> SurfaceInteraction:
    # the search itself is never differentiated (its select-chains give
    # biased/NaN cotangents); compute_si re-derives the winner's (t,u,v)
    # differentiably from tri_si
    pre = ray_intersect_preliminary(scene, ray)
    t, prim, u, v, sph = jax.tree_util.tree_map(jax.lax.stop_gradient, pre)
    return compute_si(scene, ray, t, prim, u, v, sph)
