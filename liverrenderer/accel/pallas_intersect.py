"""Closest-hit ray-triangle kernel for NVIDIA Hopper (Pallas, Triton route).

Replaces the reference's OptiX/Embree intersection backends
(scene_optix.inl / scene_embree.inl) for meshes up to `MAX_KERNEL_TRIS`
triangles: one program per block of `RAY_BLOCK` rays, a loop inside the
program over `TRI_CHUNK`-triangle chunks, the running closest hit `(t, prim)`
held in registers.  The triangle set (64 B a triangle) stays in L2; the XLA
sweep it replaces (`intersect._brute_tris`) writes lane-by-chunk `t/u/v`
arrays to device memory once per chunk.

Per-test math is the Baldwin-Weber precomputed world-to-barycentric
transform (JCGT 2016): the two cross products of Moeller-Trumbore move into
the per-triangle packing, leaving three dot products and one plane solve.
Triangles are packed in BVH-leaf order (accel/bvh.py), so each chunk has a
tight AABB and a ray block skips every chunk that none of its rays enters
closer than its current best hits.

Layout contract (structure of arrays, so every load is one contiguous row):
  rays   (8, Npad)  f32 rows: ox oy oz dx dy dz lim (row 7 unused); Npad is a
                    multiple of RAY_BLOCK; padded lanes have lim = -1.
  tris   (16, Tpad) f32 rows: n xyz, dot(n,p0), r1 xyz, d1, r2 xyz, d2,
                    tri_id, 3 unused; n = e1 x e2 (unnormalized),
                    r1 = (e2 x n)/|n|^2, d1 = -dot(r1, p0) (r2/d2 from e1),
                    so u = dot(r1, p) + d1 and v = dot(r2, p) + d2 at the hit
                    point p.  Padded columns are zero, so n.d == 0 rejects
                    them.  Tpad is a multiple of TRI_CHUNK.
  boxes  (8, n_chunks) f32 rows: min xyz, max xyz, 2 unused.
  out    t (Npad,) f32 (inf = miss) and prim (Npad,) int32 (-1 = miss).

Gradients: intersection ids and distances are sampling geometry, detached
under PRB like sampled medium distances (media/dispatch.py); the wrapper is
a custom_vjp with zero cotangents.  compute_si re-derives the winner's
(t, u, v) differentiably.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# block shape and launch parameters chosen on an H100 (tools/
# intersect_sweep.py): 64 x 16 tiles were fastest at every warp count;
# larger tiles spill registers at 2-4 warps
RAY_BLOCK = 64         # rays per program
TRI_CHUNK = 16         # triangles per inner-loop chunk (and per AABB)
NUM_WARPS = 4
NUM_STAGES = 1
# the largest mesh measured (tools/intersect_sweep.py): there the kernel beat
# the lockstep BVH 11x at 64k rays on an H100; larger meshes go to the BVH
MAX_KERNEL_TRIS = 327_680
TRI_ROWS = 16

_INF = float("inf")


def _sweep_chunk(tris_ref, base, o, d, lim, carry, chunk):
    """Baldwin-Weber closest-hit update of a (rays, chunk) tile."""
    best_t, best_prim = carry
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)

    def row(k):
        return plt.load(tris_ref.at[k, pl.ds(base, chunk)])[None, :]

    nx, ny, nz, dn = row(0), row(1), row(2), row(3)
    # t from the plane equation; n = e1 x e2, so n.d is (minus) the
    # Moeller-Trumbore determinant and the same 1e-12 guard rejects
    # padded (all-zero) columns and parallel rays
    ndir = nx * dx + ny * dy + nz * dz
    ok = jnp.abs(ndir) > 1e-12
    t = (dn - (nx * ox + ny * oy + nz * oz)) \
        * jnp.where(ok, 1.0 / jnp.where(ok, ndir, 1.0), 0.0)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    u = row(4) * px + row(5) * py + row(6) * pz + row(7)
    v = row(8) * px + row(9) * py + row(10) * pz + row(11)
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) \
        & (t < best_t[:, None]) & (t < lim[:, None])
    t_m = jnp.where(hit, t, _INF)
    t_min = jnp.min(t_m, axis=1)
    ids = row(12).astype(jnp.int32)
    # ties (shared edges) keep the largest id, as every strategy may
    prim_min = jnp.max(jnp.where(t_m == t_min[:, None], ids, -1), axis=1)
    got = t_min < best_t
    return jnp.where(got, t_min, best_t), jnp.where(got, prim_min, best_prim)


def _intersect_kernel(rays_ref, tris_ref, boxes_ref, t_ref, prim_ref, *,
                      chunk):
    n_chunks = tris_ref.shape[1] // chunk
    ox, oy, oz, dx, dy, dz, lim = (plt.load(rays_ref.at[k, :])
                                   for k in range(7))
    # slab-test reciprocals; a tiny component becomes +-inf products, and
    # the min/max ordering below still holds
    eps = 1e-20
    inv = [1.0 / jnp.where(jnp.abs(c) > eps, c, eps) for c in (dx, dy, dz)]
    org = (ox, oy, oz)

    def chunk_body(c, carry):
        best_t, _ = carry
        near, far = None, None
        for k in range(3):
            t0 = (plt.load(boxes_ref.at[k, c]) - org[k]) * inv[k]
            t1 = (plt.load(boxes_ref.at[k + 3, c]) - org[k]) * inv[k]
            lo, hi = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
            near = lo if near is None else jnp.maximum(near, lo)
            far = hi if far is None else jnp.minimum(far, hi)
        enter = (near <= far) & (far > 0.0) & (near < jnp.minimum(best_t,
                                                                   lim))
        any_enter = jnp.max(enter.astype(jnp.int32)) > 0
        return jax.lax.cond(
            any_enter,
            lambda cr: _sweep_chunk(tris_ref, c * chunk, org, (dx, dy, dz),
                                    lim, cr, chunk),
            lambda cr: cr, carry)

    n = ox.shape[0]
    init = (jnp.full((n,), _INF, jnp.float32), jnp.full((n,), -1, jnp.int32))
    best_t, best_prim = jax.lax.fori_loop(0, n_chunks, chunk_body, init)
    plt.store(t_ref.at[:], best_t)
    plt.store(prim_ref.at[:], best_prim)


@partial(jax.jit, static_argnames=("block", "chunk", "num_warps",
                                   "num_stages", "interpret"))
def _call_kernel(rays, tris, boxes, *, block=RAY_BLOCK, chunk=TRI_CHUNK,
                 num_warps=NUM_WARPS, num_stages=NUM_STAGES,
                 interpret=False):
    npad = rays.shape[1]
    return pl.pallas_call(
        partial(_intersect_kernel, chunk=chunk),
        grid=(npad // block,),
        in_specs=[
            pl.BlockSpec((8, block), lambda i: (0, i)),
            pl.BlockSpec(tris.shape, lambda i: (0, 0)),
            pl.BlockSpec(boxes.shape, lambda i: (0, 0)),
        ],
        out_specs=[pl.BlockSpec((block,), lambda i: (i,)),
                   pl.BlockSpec((block,), lambda i: (i,))],
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32),
                   jax.ShapeDtypeStruct((npad,), jnp.int32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=num_stages),
        interpret=interpret,
        name="intersect_tris",
    )(rays, tris, boxes)


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def _intersect_nograd(rays, tris, boxes, interpret):
    return _call_kernel(rays, tris, boxes, interpret=interpret)


def _intersect_fwd(rays, tris, boxes, interpret):
    return _intersect_nograd(rays, tris, boxes, interpret), None


def _intersect_bwd(interpret, _, g):
    # sampled intersection geometry is detached (PRB detached sampling);
    # parameter gradients flow through BSDF/emitter/medium evals instead
    return None, None, None


_intersect_nograd.defvjp(_intersect_fwd, _intersect_bwd)


def bw_rows(v0, v1, v2, xp=np):
    """Baldwin-Weber per-triangle rows (n, dn, r1, d1, r2, d2) from the
    three vertex arrays; works for numpy (float64 precompute) and jnp
    (differentiable-detached refresh, util.refresh_vertex_geometry)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = xp.cross(e1, e2)
    nn = xp.sum(n * n, -1)
    # degenerate guard must include overflow: if |n|^2 hits inf (fp32
    # refresh path) inv_nn would be 0 and u = v = 0 would pass every
    # barycentric test across the triangle's whole plane — zero the n row
    # too so the kernel's |n.d| > 1e-12 guard rejects the triangle
    ok = (nn > 0) & xp.isfinite(nn)
    n = xp.where(ok[:, None], n, 0.0)
    dn = xp.sum(n * v0, -1)
    inv_nn = xp.where(ok, 1.0 / xp.where(ok, nn, 1.0), 0.0)
    r1 = xp.cross(e2, n) * inv_nn[:, None]
    d1 = -xp.sum(r1 * v0, -1)
    r2 = xp.cross(n, e1) * inv_nn[:, None]
    d2 = -xp.sum(r2 * v0, -1)
    return n, dn, r1, d1, r2, d2


def pack_tris(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              perm: np.ndarray | None = None, chunk: int = TRI_CHUNK):
    """Host-side packing of the (TRI_ROWS, Tpad) triangle buffer
    (Baldwin-Weber rows, computed in float64).

    When `perm` (BVH leaf order, accel/bvh.py) is given, triangles are
    packed in that spatially local order, so the per-`chunk` AABBs are
    tight.  Returns (tri_buf, boxes (8, n_chunks), kernel_perm (Tpad,)
    mapping buffer column -> original triangle id, center (3,) local-frame
    origin).

    Geometry is re-centered on the scene AABB midpoint before the rows are
    computed: Baldwin-Weber's dn - n.o and u = r.p + d terms cancel
    catastrophically in fp32 for scenes translated far from the origin
    (Moeller-Trumbore subtracts o - p0 first and does not); the kernel works
    in the local frame, and intersect_tris shifts ray origins by the same
    center."""
    T = len(v0)
    tpad = max(-(-T // chunk) * chunk, chunk)
    if perm is None:
        perm = np.arange(T, dtype=np.int64)
    v0o, v1o, v2o = v0[perm].astype(np.float64), \
        v1[perm].astype(np.float64), v2[perm].astype(np.float64)
    if T:
        allv = np.concatenate([v0o, v1o, v2o])
        center = 0.5 * (allv.min(0) + allv.max(0))
    else:
        center = np.zeros(3)
    v0o, v1o, v2o = v0o - center, v1o - center, v2o - center
    n, dn, r1, d1, r2, d2 = bw_rows(v0o, v1o, v2o)
    buf = np.zeros((TRI_ROWS, tpad), np.float32)
    buf[0:3, :T] = n.T
    buf[3, :T] = dn
    buf[4:7, :T] = r1.T
    buf[7, :T] = d1
    buf[8:11, :T] = r2.T
    buf[11, :T] = d2
    # original triangle id baked into the buffer: the reduction then
    # yields ids directly (no permutation gather after the kernel)
    buf[12, :T] = perm.astype(np.float32)
    kperm = np.full(tpad, -1, np.int32)
    kperm[:T] = perm
    pts = np.stack([v0o, v1o, v2o], 1)
    return buf, chunk_boxes(pts, kperm >= 0, chunk=chunk), kperm, \
        center.astype(np.float32)


def chunk_boxes(pts, valid, xp=np, chunk: int = TRI_CHUNK):
    """(8, n_chunks) AABBs of `chunk`-column groups; pts (Tpad, 3, 3)
    triangle corners (rows past T may hold anything), valid (Tpad,).
    Chunks without a valid triangle get an empty (inverted) box."""
    tpad = valid.shape[0]
    if pts.shape[0] < tpad:
        pts = xp.concatenate(
            [pts, xp.zeros((tpad - pts.shape[0], 3, 3), pts.dtype)])
    m = valid[:, None, None]
    lo = xp.where(m, pts, xp.inf).reshape(-1, chunk * 3, 3).min(1)
    hi = xp.where(m, pts, -xp.inf).reshape(-1, chunk * 3, 3).max(1)
    pad = xp.zeros((2, lo.shape[0]), lo.dtype)
    return xp.concatenate([lo.T, hi.T, pad], 0).astype(xp.float32)


def intersect_tris(tri_buf: jax.Array, boxes: jax.Array,
                   o: jax.Array, d: jax.Array, maxt: jax.Array,
                   t_best: jax.Array, center: jax.Array,
                   interpret: bool = False):
    """Closest hit over the packed triangle buffer.

    Returns (t, prim): prim is the ORIGINAL triangle id, -1 (and t = inf)
    for a miss; hits at or beyond min(maxt, t_best) are rejected.
    `interpret=True` runs the kernel in the Pallas interpreter (CPU tests)."""
    n = o.shape[0]
    lim = jnp.minimum(jnp.where(jnp.isfinite(maxt), maxt, _INF), t_best)
    # local-frame shift matching pack_tris (t is shift-invariant)
    o = o - center[None]
    npad = max(-(-n // RAY_BLOCK) * RAY_BLOCK, RAY_BLOCK)
    mat = jnp.concatenate([o.T, d.T, lim[None], jnp.zeros((1, n))], 0)
    rays = jnp.pad(mat.astype(jnp.float32), ((0, 0), (0, npad - n)))
    rays = rays.at[6, n:].set(-1.0)
    t, prim = _intersect_nograd(rays, tri_buf, boxes, interpret)
    return t[:n], prim[:n]
