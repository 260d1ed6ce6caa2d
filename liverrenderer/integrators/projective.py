"""Projective (visibility / discontinuity) gradients.

Wavefront redesign of the reference's projective-sampling machinery for
*primarily visible* silhouettes (python/ad/projective.py:28-190
init/sample_primarily_visible_silhouette + sensor_jacobian +
eval_primary_silhouette_radiance_difference, used by
direct_projective.py): interior gradients (shading/transport terms) flow
through the differentiable hit recompute; the MISSING piece round 1 was
the boundary term — the film-space line integral over silhouette edges

    dI_pix/dtheta = oint_{silhouettes}  dL * (dx_film/dtheta . n_hat)  dl

where dL is the radiance difference across the edge and n_hat the
film-space edge normal pointing into the background.

Design differences from the reference (Dr.Jit vcall/dr.switch machinery):
  * edge adjacency is ONE flat SoA table built once per mesh set (numpy,
    outside jit) instead of per-shape precomputed silhouette lists;
  * the silhouette test, categorical edge sampling, visibility test,
    radiance-difference estimation and the final VJP assembly are a
    single jit program — no per-shape dr.switch;
  * instead of Dr.Jit forward-AD through the projection (sensor_jacobian),
    the film-space velocity of the boundary enters as the analytically
    assembled scalar  S = sum delta[pix] * dL * (proj(x(V)) . n_hat) / p
    differentiated by jax.grad — only x(V) carries gradient.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..accel.intersect import ray_intersect_preliminary, ray_test
from ..core.rng import hash_u32, make_sampler
from ..core.types import Ray
from ..scene.ir import SENSOR_ORTHOGRAPHIC, SENSOR_PERSPECTIVE, Scene
from ..util import apply_params

Array = jax.Array

_EDGE_CACHE: dict = {}


def edge_table(faces: np.ndarray, n_tris: int):
    """Unique-edge adjacency: (edge_v (E,2) int32, edge_f (E,2) int32,
    f1 = -1 for boundary edges).  Cached per faces buffer."""
    key = (faces.shape[0], n_tris, int(faces[:1].sum()) if n_tris else 0,
           int(faces[n_tris - 1:n_tris].sum()) if n_tris else 0)
    hit = _EDGE_CACHE.get(key)
    if hit is not None and np.array_equal(hit[2], faces[:n_tris]):
        return hit[0], hit[1]
    F = np.asarray(faces[:n_tris], np.int64)
    e = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]])
    fid = np.tile(np.arange(len(F)), 3)
    key_e = np.minimum(e[:, 0], e[:, 1]) << 32 \
        | np.maximum(e[:, 0], e[:, 1])
    order = np.argsort(key_e, kind="stable")
    key_s, e_s, f_s = key_e[order], e[order], fid[order]
    first = np.ones(len(key_s), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    idx_first = np.nonzero(first)[0]
    ev = e_s[idx_first].astype(np.int32)
    ef = np.full((len(idx_first), 2), -1, np.int32)
    ef[:, 0] = f_s[idx_first]
    nxt = idx_first + 1
    has2 = nxt < len(key_s)
    has2[has2] &= key_s[nxt[has2]] == key_s[idx_first[has2]]
    ef[has2, 1] = f_s[nxt[has2]]
    out = (jnp.asarray(ev), jnp.asarray(ef))
    _EDGE_CACHE.clear()
    _EDGE_CACHE[key] = (out[0], out[1], F.astype(np.int32).copy())
    return out


def project_to_film(scene: Scene, p: Array) -> Array:
    """World point -> continuous pixel coordinates (the inverse of
    sensor/perspective.py sample_ray's film->direction map)."""
    sensor = scene.sensor
    w, h = scene.film_w, scene.film_h
    aspect = w / h
    R = sensor.to_world[:3, :3]
    t = sensor.to_world[:3, 3]
    p_cam = (p - t) @ R            # R^T (p - t)
    if sensor.stype == SENSOR_ORTHOGRAPHIC:
        nx = (1.0 - p_cam[..., 0]) * 0.5
        ny = (1.0 - p_cam[..., 1] * aspect) * 0.5
    else:
        tan_half = jnp.tan(jnp.deg2rad(sensor.fov_x) * 0.5)
        z = jnp.maximum(p_cam[..., 2], 1e-6)
        nx = (1.0 - p_cam[..., 0] / (z * tan_half)) * 0.5
        ny = (1.0 - p_cam[..., 1] * aspect / (z * tan_half)) * 0.5
    return jnp.stack([nx * w, ny * h], -1)


def silhouette_weights(scene: Scene, Vd: Array, edge_v: Array,
                       edge_f: Array):
    """Length-measure categorical weights over the silhouette edge set
    (the projective.py silhouette test): weight = edge length on
    silhouette edges, 0 elsewhere."""
    F = scene.faces
    cam = scene.sensor.to_world[:3, 3]
    p0, p1 = Vd[edge_v[:, 0]], Vd[edge_v[:, 1]]
    mid = 0.5 * (p0 + p1)

    def face_front(fi):
        f = F[jnp.maximum(fi, 0)]
        a, b, c = Vd[f[:, 0]], Vd[f[:, 1]], Vd[f[:, 2]]
        n = jnp.cross(b - a, c - a)
        return jnp.sum(n * (mid - cam), -1) < 0.0

    front0 = face_front(edge_f[:, 0])
    front1 = face_front(edge_f[:, 1])
    boundary = edge_f[:, 1] < 0
    sil = jnp.where(boundary, True, front0 != front1)
    length = jnp.linalg.norm(p1 - p0, axis=-1)
    return jnp.where(sil, length, 0.0), length


@partial(jax.jit, static_argnames=("n_samples", "sil_depth"))
def _boundary_grad_jit(scene: Scene, V: Array, edge_v: Array, edge_f: Array,
                       delta: Array, wgt: Array, seed, n_samples: int,
                       sil_depth: int):
    """Vertex-position cotangent of the primary-visibility boundary term.

    delta: (h, w, 3) dLoss/dImage; wgt: (E,) categorical edge weights
    (any measure supported on the silhouette set — uniform length or
    pilot-guided).  Returns (dLoss/dV (V,3), per-sample |contribution|
    (P,), sampled edge ids (P,)) — the latter two feed guiding.
    """
    w, h = scene.film_w, scene.film_h
    Vd = jax.lax.stop_gradient(V)
    cam = scene.sensor.to_world[:3, 3]
    _, length = silhouette_weights(scene, Vd, edge_v, edge_f)
    total_w = jnp.sum(wgt)

    # ---- sample n_samples points on the silhouette set ----
    u = make_sampler(jnp.arange(n_samples, dtype=jnp.uint32),
                     0, seed, kind="independent")
    u_pick, u = u.next_1d()
    u_t, u = u.next_1d()
    cdf = jnp.cumsum(wgt)
    e_idx = jnp.searchsorted(cdf, u_pick * total_w, side="right")
    e_idx = jnp.clip(e_idx, 0, edge_v.shape[0] - 1)
    i0 = edge_v[e_idx, 0]
    i1 = edge_v[e_idx, 1]
    tpar = u_t
    x = (1.0 - tpar[:, None]) * Vd[i0] + tpar[:, None] * Vd[i1]
    len_e = length[e_idx]
    valid = total_w > 0.0

    # the shape owning the (first adjacent) face, for fore/background
    # disambiguation
    own_shape = scene.tri_shape[jnp.maximum(edge_f[e_idx, 0], 0)]

    # ---- visibility from the camera ----
    to_x = x - cam
    dist = jnp.linalg.norm(to_x, axis=-1)
    d_cam = to_x / jnp.maximum(dist, 1e-9)[:, None]
    occ = ray_test(scene, Ray(o=jnp.broadcast_to(cam, x.shape), d=d_cam,
                              maxt=dist * (1.0 - 1e-3)))
    visible = ~occ & valid

    # ---- film position, local film velocity along the edge ----
    e_unit = (Vd[i1] - Vd[i0]) / jnp.maximum(len_e, 1e-9)[:, None]
    xf, dxf = jax.jvp(lambda q: project_to_film(scene, q), (x,), (e_unit,))
    speed = jnp.linalg.norm(dxf, axis=-1)            # px per scene unit
    ef_unit = dxf / jnp.maximum(speed, 1e-9)[:, None]
    n_hat = jnp.stack([-ef_unit[:, 1], ef_unit[:, 0]], -1)
    in_film = (xf[:, 0] >= 0.5) & (xf[:, 0] < w - 0.5) \
        & (xf[:, 1] >= 0.5) & (xf[:, 1] < h - 0.5)
    visible &= in_film & (speed > 1e-6)

    # ---- classify the two sides (foreground hits the owning shape at
    # ~the silhouette depth) and estimate the radiance difference ----
    eps_px = 0.1

    def side_ray(sgn):
        from ..sensor.perspective import sample_ray
        return sample_ray(scene, xf + sgn * eps_px * n_hat)

    ray_p = side_ray(+1.0)
    ray_m = side_ray(-1.0)

    def probe(ray):
        t, prim, _, _, sph = ray_intersect_preliminary(scene, ray)
        shp = jnp.where(prim >= 0, scene.tri_shape[jnp.maximum(prim, 0)], -1)
        near = jnp.abs(t - dist) < 0.05 * dist + 1e-3
        return (shp == own_shape) & near

    fg_p = probe(ray_p)
    fg_m = probe(ray_m)
    one_side = fg_p ^ fg_m
    visible &= one_side

    from .common import _integrator_sample
    smp = make_sampler(hash_u32(jnp.arange(n_samples, dtype=jnp.uint32),
                                jnp.uint32(0x9D7F3A21)),
                       0, seed, kind="independent")
    sc_sil = scene.replace(max_depth=min(scene.max_depth, sil_depth))
    L_p, _, smp = _integrator_sample(sc_sil, smp, ray_p, mode="primal")
    L_m, _, smp = _integrator_sample(sc_sil, smp, ray_m, mode="primal")
    L_p = jnp.where(jnp.isfinite(L_p), L_p, 0.0)
    L_m = jnp.where(jnp.isfinite(L_m), L_m, 0.0)
    # dL = L_foreground - L_background; n_hat oriented into the background
    dL = jnp.where(fg_p[:, None], L_p - L_m, L_m - L_p)
    n_bg = jnp.where(fg_p[:, None], -n_hat, n_hat)

    # ---- assemble the boundary VJP ----
    # film-space line density of the sampler with categorical edge
    # weights w_e:  p_film = (w_e / total_w) * 1/len_e * 1/speed  per
    # unit film length (uniform-by-length reduces to total_w * speed)
    inv_p = total_w * speed * len_e / jnp.maximum(wgt[e_idx], 1e-30)
    pix = jnp.clip(xf[:, 1].astype(jnp.int32), 0, h - 1) * w \
        + jnp.clip(xf[:, 0].astype(jnp.int32), 0, w - 1)
    d_pix = delta.reshape(-1, 3)[pix]
    coeff = jnp.sum(d_pix * dL, -1) * inv_p / n_samples
    coeff = jnp.where(visible, coeff, 0.0)
    coeff = jax.lax.stop_gradient(coeff)
    n_bg = jax.lax.stop_gradient(n_bg)

    def S(Vp):
        xv = (1.0 - tpar[:, None]) * Vp[i0] + tpar[:, None] * Vp[i1]
        xfv = project_to_film(scene, xv)
        return jnp.sum(coeff * jnp.sum(xfv * n_bg, -1))

    return jax.grad(S)(V), jnp.abs(coeff) * n_samples, e_idx


@partial(jax.jit, static_argnames=())
def _sil_weights_jit(scene: Scene, Vd: Array, edge_v: Array, edge_f: Array):
    return silhouette_weights(scene, Vd, edge_v, edge_f)[0]


@partial(jax.jit, static_argnames=("n_samples", "sil_depth", "depth_max"))
def _indirect_boundary_grad_jit(scene: Scene, V: Array, edge_v: Array,
                                edge_f: Array, delta: Array, seed,
                                n_samples: int, sil_depth: int,
                                eps_ang: float = 1e-3, ocs=None,
                                depth_max: int = 1):
    """Vertex-position cotangent of the INDIRECT visibility boundary
    term: silhouettes seen from an interior path vertex z_d (e.g. an
    occluder visible only in a rough-mirror reflection, or only after a
    chain of bounces).

    Wavefront analog of the reference's indirect projective phase
    (ad/projective.py:614-833 ProjectOperation + common.py:786+
    PSIntegrator indirect boundary sampling + prb_projective.py:8): the
    boundary lives in the DIRECTION domain at z_d,

        dI_pix/dtheta = oint beta_d f(z_d, w) dL(w)
                             (dw_sil/dtheta . n_hat) dl_w

    with beta_d the path throughput of the sampled prefix, f the BSDF at
    z_d (cosine included) and dl_w angular arc length.  Instead of the
    reference's seed-ray projection search (a per-lane walk to the
    nearest silhouette, dr.switch over shapes), each lane JOINTLY samples
    (pixel, prefix depth, edge point): the camera ray plus a BSDF-sampled
    prefix walk of depth d ~ U{1..depth_max} fixes z_d (the reference's
    (pixel^2, depth) boundary sample space), the edge point fixes the
    direction — one fused wavefront program, the same shape every
    iteration.  Delta BSDFs ALONG the prefix are fine (the walk samples
    them); a delta BSDF AT z_d evaluates to zero — perfectly specular
    final segments need the reference's attached reparam, rough chains
    (the practical mirror: roughconductor) are covered.
    """
    from ..sensor.perspective import sample_ray
    from .common import _integrator_sample
    from .shading import shading_frame_with_bump
    from ..accel.intersect import ray_intersect
    from ..bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
    from ..core import math as m

    w, h = scene.film_w, scene.film_h
    Vd = jax.lax.stop_gradient(V)
    F = scene.faces

    # ---- prefix: one camera ray per lane -> z1 ----
    smp = make_sampler(jnp.arange(n_samples, dtype=jnp.uint32), 0, seed,
                       kind="independent")
    u_pix, smp = smp.next_2d()
    u_pick, smp = smp.next_1d()
    u_t, smp = smp.next_1d()
    if ocs is not None:
        # octree-guided (pixel.x, pixel.y, edge-pick) primary sample
        # space (the reference's OcSpaceDistr over 3D guiding domains,
        # ad/guiding.py:141-568): warp the joint draw through the pilot
        # octree and divide by its density
        u_sel, smp = smp.next_1d()
        prim, dens = ocs.sample(
            u_sel, jnp.stack([u_pix[:, 0], u_pix[:, 1], u_pick], -1))
        u_pix = prim[:, 0:2]
        u_pick = prim[:, 2]
        inv_dens = 1.0 / jnp.maximum(dens, 1e-12)
    else:
        inv_dens = jnp.ones((n_samples,))
    prim_pts = jnp.stack([u_pix[:, 0], u_pix[:, 1], u_pick], -1)
    pos = u_pix * jnp.array([w, h], jnp.float32)
    ray = sample_ray(scene, pos)
    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)
    prefix_ok = si.valid
    beta = jnp.ones((n_samples, 3))
    if depth_max > 1:
        # ---- arbitrary-depth prefix: extend the camera hit by a BSDF-
        # sampled walk to z_d, d ~ U{1..depth_max} (uniform depth pdf
        # 1/depth_max -> the estimator multiplies by depth_max below).
        # The walk is a bounded masked fori_loop: lane l extends while
        # k < d_l - 1 and the walk stays on surfaces ----
        u_d, smp = smp.next_1d()
        depth_t = 1 + jnp.floor(u_d * depth_max).astype(jnp.int32)
        depth_t = jnp.clip(depth_t, 1, depth_max)

        def pf_body(k, carry):
            si_c, beta_c, alive_c, smp_c = carry
            u1, smp_c = smp_c.next_1d()
            u2, smp_c = smp_c.next_1d()
            extend = alive_c & (k < depth_t - 1)
            bidx = m.table_lookup(scene.shape_bsdf,
                                  jnp.maximum(si_c.shape, 0))
            bs = bsdf_sample(scene, si_c, bidx, u1, u2)
            d_w = si_c.to_world(bs.wo)
            d_w = d_w / jnp.maximum(
                jnp.linalg.norm(d_w, axis=-1, keepdims=True), 1e-12)
            r2 = si_c.spawn_ray(d_w)
            si_n = ray_intersect(scene, r2)
            si_n = shading_frame_with_bump(scene, si_n, r2)
            wgt = jnp.where(jnp.isfinite(bs.weight), bs.weight, 0.0)
            good = si_n.valid & (bs.pdf > 0) \
                & (jnp.max(wgt, -1) > 0)
            beta_n = jnp.where(extend[:, None], beta_c * wgt, beta_c)
            def _merge(a, b):
                # lane-independent fields (e.g. the (1,3) attr default)
                # are identical in both records — keep them as-is so the
                # fori carry types stay fixed
                if a.shape[:1] != extend.shape[:1]:
                    return b
                return jnp.where(
                    extend.reshape(extend.shape + (1,) * (a.ndim - 1)),
                    a, b)

            si_m = jax.tree_util.tree_map(_merge, si_n, si_c)
            alive_n = jnp.where(extend, good, alive_c)
            return si_m, beta_n, alive_n, smp_c

        si, beta, prefix_ok, smp = jax.lax.fori_loop(
            0, depth_max - 1, pf_body,
            (si, beta, prefix_ok, smp))
        beta = beta * depth_max
    bsdf_idx = m.table_lookup(scene.shape_bsdf, jnp.maximum(si.shape, 0))

    # ---- edge point, uniform by length over ALL edges (the silhouette
    # set depends on z1, so the test is per-lane below) ----
    p0, p1 = Vd[edge_v[:, 0]], Vd[edge_v[:, 1]]
    length = jnp.linalg.norm(p1 - p0, axis=-1)
    total_len = jnp.sum(length)
    cdf = jnp.cumsum(length)
    e_idx = jnp.clip(jnp.searchsorted(cdf, u_pick * total_len,
                                      side="right"),
                     0, edge_v.shape[0] - 1)
    i0, i1 = edge_v[e_idx, 0], edge_v[e_idx, 1]
    x = (1.0 - u_t[:, None]) * Vd[i0] + u_t[:, None] * Vd[i1]
    len_e = length[e_idx]
    own_shape = scene.tri_shape[jnp.maximum(edge_f[e_idx, 0], 0)]

    # silhouette test w.r.t. the per-lane viewpoint z1
    def face_front(fi):
        f = F[jnp.maximum(fi, 0)]
        a, b, c = Vd[f[:, 0]], Vd[f[:, 1]], Vd[f[:, 2]]
        n = jnp.cross(b - a, c - a)
        return jnp.sum(n * (x - si.p), -1) < 0.0

    boundary = edge_f[e_idx, 1] < 0
    sil = jnp.where(boundary, True,
                    face_front(edge_f[e_idx, 0])
                    != face_front(edge_f[e_idx, 1]))

    to_x = x - si.p
    r = jnp.linalg.norm(to_x, axis=-1)
    wdir = to_x / jnp.maximum(r, 1e-9)[:, None]
    valid = prefix_ok & sil & (r > 1e-4)

    # visibility z1 -> x
    sray = si.spawn_ray(wdir)
    occ = ray_test(scene, Ray(o=sray.o, d=wdir,
                              maxt=r * (1.0 - 1e-3)))
    valid &= ~occ

    # BSDF throughput at z1 toward the edge (delta lobes -> 0)
    bval, _ = bsdf_eval_pdf(scene, si, bsdf_idx, si.to_local(wdir))

    # angular velocity of the silhouette point along the edge
    e_unit = (Vd[i1] - Vd[i0]) / jnp.maximum(len_e, 1e-9)[:, None]
    dw = (e_unit - wdir * jnp.sum(wdir * e_unit, -1, keepdims=True)) \
        / jnp.maximum(r, 1e-9)[:, None]
    speed = jnp.linalg.norm(dw, axis=-1)          # rad per unit edge len
    dw_unit = dw / jnp.maximum(speed, 1e-12)[:, None]
    n3 = jnp.cross(wdir, dw_unit)                 # tangent-plane normal
    valid &= speed > 1e-9

    # ---- radiance difference across the edge, probed from z1 ----
    def side_ray(sgn):
        d = wdir + sgn * eps_ang * n3
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        sr = si.spawn_ray(d)
        return Ray(o=sr.o, d=d, maxt=jnp.full((n_samples,), jnp.inf))

    ray_p, ray_m = side_ray(+1.0), side_ray(-1.0)

    def probe(rp):
        t, prim, _, _, _sph = ray_intersect_preliminary(scene, rp)
        shp = jnp.where(prim >= 0,
                        scene.tri_shape[jnp.maximum(prim, 0)], -1)
        near = jnp.abs(t - r) < 0.05 * r + 1e-3
        return (shp == own_shape) & near

    fg_p, fg_m = probe(ray_p), probe(ray_m)
    valid &= fg_p ^ fg_m

    smp2 = make_sampler(hash_u32(jnp.arange(n_samples, dtype=jnp.uint32),
                                 jnp.uint32(0x51C3B7A9)),
                        0, seed, kind="independent")
    sc_sil = scene.replace(max_depth=min(scene.max_depth, sil_depth))
    L_p, _, smp2 = _integrator_sample(sc_sil, smp2, ray_p, mode="primal")
    L_m, _, smp2 = _integrator_sample(sc_sil, smp2, ray_m, mode="primal")
    L_p = jnp.where(jnp.isfinite(L_p), L_p, 0.0)
    L_m = jnp.where(jnp.isfinite(L_m), L_m, 0.0)
    dL = jnp.where(fg_p[:, None], L_p - L_m, L_m - L_p)
    n_bg = jnp.where(fg_p[:, None], -n3, n3)

    # ---- assemble ----
    # pixel pdf 1/(w*h) per px^2 -> inv w*h; edge-length pdf 1/total_len
    # -> angular-domain inv = total_len * speed (cf. the primary case)
    pix = jnp.clip(pos[:, 1].astype(jnp.int32), 0, h - 1) * w \
        + jnp.clip(pos[:, 0].astype(jnp.int32), 0, w - 1)
    d_pix = delta.reshape(-1, 3)[pix]
    coeff = jnp.sum(d_pix * beta * bval * dL, -1) * total_len * speed \
        * (w * h) / n_samples * inv_dens
    coeff = jnp.where(jnp.isfinite(coeff), coeff, 0.0)
    coeff = jax.lax.stop_gradient(jnp.where(valid, coeff, 0.0))
    n_bg = jax.lax.stop_gradient(jnp.where(valid[:, None], n_bg, 0.0))
    # invalid lanes carry non-finite si.p (missed prefix); zero them so
    # 0-coefficient lanes cannot poison the sum with 0*nan
    z1 = jax.lax.stop_gradient(
        jnp.where(valid[:, None] & jnp.isfinite(si.p), si.p, 0.0))

    def S(Vp):
        xv = (1.0 - u_t[:, None]) * Vp[i0] + u_t[:, None] * Vp[i1]
        tv = xv - z1
        nrm = jnp.maximum(jnp.linalg.norm(tv, axis=-1, keepdims=True),
                          1e-9)
        return jnp.sum(coeff * jnp.sum(tv / nrm * n_bg, -1))

    return jax.grad(S)(V), prim_pts, jnp.abs(coeff) * n_samples


def indirect_boundary_gradient(scene: Scene, params, delta_image,
                               seed: int = 0, n_samples: int = 1 << 16,
                               sil_depth: int = 6,
                               guiding: str = "octree",
                               pilot_frac: float = 0.25,
                               depth_max: int = 1):
    """dLoss/d(vertices), indirect visibility boundary term (occluders
    seen through rough reflections/refractions at interior path
    vertices).  Complements boundary_gradient's primarily-visible term;
    both are added by render_grad when vertices are differentiated.

    depth_max: largest prefix depth sampled (d ~ U{1..depth_max}); 1 =
    the silhouette is viewed from the first hit, >1 walks a BSDF-sampled
    prefix first (the reference PSIntegrator's arbitrary-depth boundary
    sampling, prb_projective.py:8 / ad/projective.py:28-190).

    guiding="octree" runs the reference's two-stage scheme over the 3D
    (pixel.x, pixel.y, edge-pick) primary sample space: a uniform pilot
    round builds an OcSpaceDistr octree (guiding.octree_from_samples)
    from per-sample |contribution| and the main round importance-samples
    it; both rounds are unbiased and count-weighted together."""
    if scene.n_tris == 0 or "vertices" not in params:
        return jnp.zeros_like(scene.vertices)
    sc = apply_params(scene, {k: jax.lax.stop_gradient(v)
                              for k, v in params.items()})
    ev, ef = edge_table(np.asarray(sc.faces), sc.n_tris)
    delta = jnp.asarray(delta_image)
    if guiding == "none":
        g, _, _ = _indirect_boundary_grad_jit(sc, params["vertices"], ev,
                                              ef, delta, seed, n_samples,
                                              sil_depth,
                                              depth_max=depth_max)
        return g
    from .guiding import octree_from_samples
    n_pilot = max(256, int(n_samples * pilot_frac))
    n_main = max(256, n_samples - n_pilot)
    g1, pts, mass = _indirect_boundary_grad_jit(
        sc, params["vertices"], ev, ef, delta, seed, n_pilot, sil_depth,
        depth_max=depth_max)
    ocs = octree_from_samples(np.asarray(pts), np.asarray(mass))
    g2, _, _ = _indirect_boundary_grad_jit(
        sc, params["vertices"], ev, ef, delta, seed + 1, n_main,
        sil_depth, ocs=ocs, depth_max=depth_max)
    return (n_pilot * g1 + n_main * g2) / (n_pilot + n_main)


def boundary_gradient(scene: Scene, params, delta_image, seed: int = 0,
                      n_samples: int = 1 << 16, sil_depth: int = 6,
                      guiding: str = "edges", pilot_frac: float = 0.25):
    """dLoss/d(vertices) boundary term.  `delta_image`: (h, w, 3) dL/dI.

    guiding="edges" runs the reference's two-stage projective sampling
    (ad/guiding.py distributions; PSIntegrator proj_mesh spec): a pilot
    round samples the silhouette uniformly by length, its per-sample
    |contribution| builds a guided per-edge distribution
    (guiding.edge_guided_weights), and the main round samples from it.
    The rounds are count-weighted together (both unbiased).
    guiding="none" is single-round uniform-by-length.

    Only triangle meshes contribute silhouettes (the reference's
    sphere/curve/SDF silhouette support is per-shape-type specialized,
    projective.py:765-833; meshes cover the shipped scene corpus)."""
    if scene.n_tris == 0 or "vertices" not in params:
        return jnp.zeros_like(scene.vertices)
    sc = apply_params(scene, {k: jax.lax.stop_gradient(v)
                              for k, v in params.items()})
    ev, ef = edge_table(np.asarray(sc.faces), sc.n_tris)
    V = params["vertices"]
    delta = jnp.asarray(delta_image)
    wgt0 = _sil_weights_jit(sc, jax.lax.stop_gradient(V), ev, ef)
    if guiding == "none":
        g, _, _ = _boundary_grad_jit(sc, V, ev, ef, delta, wgt0, seed,
                                     n_samples, sil_depth)
        return g
    n_pilot = max(256, int(n_samples * pilot_frac))
    n_main = max(256, n_samples - n_pilot)
    g1, mass, e_idx = _boundary_grad_jit(sc, V, ev, ef, delta, wgt0, seed,
                                         n_pilot, sil_depth)
    from .guiding import edge_guided_weights
    wgt1 = edge_guided_weights(mass, e_idx, wgt0)
    g2, _, _ = _boundary_grad_jit(sc, V, ev, ef, delta, wgt1, seed + 1,
                                  n_main, sil_depth)
    return (n_pilot * g1 + n_main * g2) / (n_pilot + n_main)
