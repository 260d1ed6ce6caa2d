"""Adjoint particle (light) tracer.

Capability analog of reference src/integrators/ptracer.cpp
(AdjointIntegrator::render, integrator.cpp:574-789): paths start at the
emitters, carry radiant intensity, and connect every vertex to the camera
with a visibility ray; contributions are splatted to the film at the
projected pixel position.  Design: one wavefront of light paths in a
bounded scan, camera connections splatted with the same scatter-add film
as the forward integrators.

Supported emitters for path emission: area (mesh shapes), point, and the
infinite family (constant / envmap / directional) via
bounding-sphere-disk endpoint sampling — an incoming direction is drawn
(uniform sphere / envmap 2D CDF / the delta direction), then a ray
origin on the perpendicular disk of the scene bounding sphere, weight
L * pi R^2 / pdf_dir (endpoint.cpp sample_ray for infinite emitters).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import film as film_mod
from ..accel.intersect import ray_intersect, ray_test
from ..bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
from ..core import math as m
from ..core.rng import make_sampler
from ..core.types import Ray
from ..core.warp import square_to_cosine_hemisphere
from ..scene.ir import (EMITTER_AREA, EMITTER_CONSTANT, EMITTER_DIRECTIONAL,
                        EMITTER_ENVMAP, EMITTER_POINT, F_DELTA, Scene)
from ..sensor.perspective import sample_ray  # noqa: F401 (doc cross-ref)


def _camera_axes(scene: Scene):
    R = scene.sensor.to_world[:3, :3]
    t = scene.sensor.to_world[:3, 3]
    return R, t


def project_to_film(scene: Scene, p):
    """World point -> (film_pos (N,2), camera direction (N,3), valid).
    Inverse of sensor.sample_ray's pinhole mapping."""
    R, t = _camera_axes(scene)
    w, h = scene.film_w, scene.film_h
    aspect = w / h
    rel = p - t
    cam = rel @ R            # world->camera (R orthonormal)
    z = cam[..., 2]
    valid = z > 1e-6
    tan_half = jnp.tan(jnp.deg2rad(scene.sensor.fov_x) * 0.5)
    xn = cam[..., 0] / jnp.maximum(z, 1e-6) / tan_half
    yn = cam[..., 1] / jnp.maximum(z, 1e-6) / (tan_half / aspect)
    fx = (1.0 - xn) * 0.5 * w
    fy = (1.0 - yn) * 0.5 * h
    valid &= (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    return jnp.stack([fx, fy], -1), m.normalize(rel), valid


def _importance(scene: Scene, d_world):
    """Pinhole importance We(omega): 1 / (A_plane * cos^3 theta) with
    A_plane the film rectangle area on the z=1 plane (ptracer.cpp
    sensor->sample_direction weights)."""
    R, _ = _camera_axes(scene)
    fwd = R[:, 2]
    cos_t = jnp.clip(jnp.sum(d_world * fwd, -1), 1e-6, 1.0)
    aspect = scene.film_w / scene.film_h
    tan_half = jnp.tan(jnp.deg2rad(scene.sensor.fov_x) * 0.5)
    area = (2.0 * tan_half) * (2.0 * tan_half / aspect)
    return 1.0 / (area * cos_t ** 3)


def _sample_emitter_ray(scene: Scene, sampler):
    """Emit a light path: position + direction + initial power/pdf."""
    em = scene.emitters
    u_sel, sampler = sampler.next_1d()
    eidx, _, sel_pdf = em.distr.sample_reuse(u_sel)
    etype = em.etype[eidx]
    prm = em.params[eidx]

    u_pos, sampler = sampler.next_2d()
    u_dir, sampler = sampler.next_2d()

    # ---- area: uniform point on the emissive shape, cosine direction ----
    shape = em.shape[eidx]
    # pick a triangle of the shape proportional to area
    off = scene.shape_prim_offset[jnp.maximum(shape, 0)]
    cnt = jnp.maximum(scene.shape_prim_count[jnp.maximum(shape, 0)], 1)
    u_tri, sampler = sampler.next_1d()
    tri = off + jnp.minimum((u_tri * cnt).astype(jnp.int32), cnt - 1)
    f = scene.faces[tri]
    v0 = scene.vertices[f[:, 0]]
    v1 = scene.vertices[f[:, 1]]
    v2 = scene.vertices[f[:, 2]]
    su = jnp.sqrt(jnp.maximum(u_pos[:, 0], 1e-12))
    b0 = 1.0 - su
    b1 = u_pos[:, 1] * su
    b2 = 1.0 - b0 - b1
    p_area = v0 * b0[:, None] + v1 * b1[:, None] + v2 * b2[:, None]
    n_area = m.normalize(jnp.cross(v1 - v0, v2 - v0))
    wo_l = square_to_cosine_hemisphere(u_dir)
    fr = m.make_frame(n_area)
    d_area = (wo_l[:, 0:1] * fr.s + wo_l[:, 1:2] * fr.t
              + wo_l[:, 2:3] * n_area)
    area = jnp.maximum(scene.shape_area[jnp.maximum(shape, 0)], 1e-12)
    # radiance: constant in params[0:3], textured via tex0 when set
    from ..texture.eval import eval_texture
    uv = (scene.uvs[f[:, 0]] * b0[:, None] + scene.uvs[f[:, 1]] * b1[:, None]
          + scene.uvs[f[:, 2]] * b2[:, None])
    tex = eval_texture(scene.textures, em.tex0[eidx], uv)
    rad = jnp.where((em.tex0[eidx] >= 0)[:, None], tex, prm[:, 0:3])
    # power / (pdf_pos * pdf_dir): L * cos / (1/A * cos/pi) = L*A*pi
    w_area = rad * (area * jnp.pi)[:, None]

    # ---- point: isotropic intensity (params p0:3 position, p3:6 I) ----
    p_point = prm[:, 0:3]
    from ..core.warp import square_to_uniform_sphere
    d_point = square_to_uniform_sphere(u_dir)
    w_point = prm[:, 3:6] * (4.0 * jnp.pi)

    is_point = etype == EMITTER_POINT
    p0 = jnp.where(is_point[:, None], p_point, p_area)
    d0 = jnp.where(is_point[:, None], d_point, d_area)
    w0 = jnp.where(is_point[:, None], w_point, w_area)

    # ---- infinite emitters (constant / envmap / directional): pick an
    # incoming direction, then a point on the disk of the scene bounding
    # sphere perpendicular to it (endpoint.cpp sample_ray for infinite
    # emitters: pdf_pos = 1/(pi R^2), weight = L * pi R^2 / pdf_dir) ----
    tp = set(em.types_present)
    inf_types = tp & {EMITTER_CONSTANT, EMITTER_ENVMAP, EMITTER_DIRECTIONAL}
    if inf_types:
        c = 0.5 * (scene.vertices.min(0) + scene.vertices.max(0))
        radius = jnp.maximum(
            jnp.sqrt(jnp.sum((scene.vertices - c) ** 2, -1)).max(), 1e-3)
        u_disk, sampler = sampler.next_2d()
        # dd: direction from the scene toward the emitter
        dd = -d_point                                  # uniform sphere
        w_inf = prm[:, 0:3] * (4.0 * jnp.pi)           # constant: L*4pi
        if EMITTER_ENVMAP in tp:
            from .. import emitter as _em_pkg  # noqa: F401 (pkg init)
            from ..emitter.dispatch import _env_radiance
            pos_lm, cell_pdf = em.env_distr.sample(u_dir)
            gh, gw = em.env_distr.data.shape
            phi = pos_lm[..., 0] / gw * (2 * jnp.pi)
            theta = pos_lm[..., 1] / gh * jnp.pi
            s_t = jnp.sin(theta)
            d_loc = jnp.stack([s_t * jnp.sin(phi), jnp.cos(theta),
                               -s_t * jnp.cos(phi)], -1)
            tw = m.table_lookup(em.to_world, eidx)
            dd_env = jnp.einsum("nij,nj->ni", tw[:, :3, :3], d_loc)
            pdf_env = cell_pdf * (gh * gw) \
                / (2.0 * jnp.pi * jnp.pi * jnp.maximum(s_t, 1e-6))
            rad_env = _env_radiance(scene, eidx, dd_env)
            sel_env = etype == EMITTER_ENVMAP
            dd = jnp.where(sel_env[:, None], dd_env, dd)
            w_inf = jnp.where(sel_env[:, None],
                              rad_env / jnp.maximum(pdf_env, 1e-12)[:, None],
                              w_inf)
        if EMITTER_DIRECTIONAL in tp:
            sel_dir = etype == EMITTER_DIRECTIONAL
            dd = jnp.where(sel_dir[:, None], -prm[:, 0:3], dd)
            w_inf = jnp.where(sel_dir[:, None], prm[:, 3:6], w_inf)
        # disk origin outside the scene, perpendicular to dd
        fr_d = m.make_frame(dd)
        from ..core.warp import square_to_uniform_disk_concentric
        dk = square_to_uniform_disk_concentric(u_disk) * radius
        p_inf = c[None, :] + dd * (1.5 * radius) \
            + dk[:, 0:1] * fr_d.s + dk[:, 1:2] * fr_d.t
        w_inf = w_inf * (jnp.pi * radius * radius)
        is_inf = jnp.zeros(etype.shape, bool)
        for it in inf_types:
            is_inf = is_inf | (etype == it)
        p0 = jnp.where(is_inf[:, None], p_inf, p0)
        d0 = jnp.where(is_inf[:, None], -dd, d0)
        w0 = jnp.where(is_inf[:, None], w_inf, w0)

    w0 = w0 / jnp.maximum(sel_pdf, 1e-12)[:, None]
    n0 = jnp.where(is_point[:, None], d0, n_area)
    return p0, d0, w0, n0, sampler


def render_ptracer(scene: Scene, spp: int | None = None, seed: int = 0):
    """Light-trace the scene: returns the (h, w, 3) image.  The sample
    budget is spp light paths per pixel-equivalent (W*H*spp paths)."""
    spp = spp or scene.spp
    w, h = scene.film_w, scene.film_h
    n = w * h * max(1, spp // 4)   # light paths; each splats many pixels

    @jax.jit
    def run(scene, seed):
        lane = jnp.arange(n, dtype=jnp.uint32)
        sampler = make_sampler(lane, 0, seed)
        p, d, weight, nrm, sampler = _sample_emitter_ray(scene, sampler)
        acc = jnp.zeros((h * w, 4))

        def connect(acc, p_v, contrib_v, valid):
            pos, to_cam_dir, on_film = project_to_film(scene, p_v)
            R, t = _camera_axes(scene)
            dvec = t - p_v
            dist = m.norm(dvec)
            d_to_cam = dvec / jnp.maximum(dist, 1e-9)[:, None]
            eps = (1.0 + jnp.max(jnp.abs(p_v), -1)) * 1e-4
            occ = ray_test(scene, Ray(o=p_v + d_to_cam * eps[:, None],
                                      d=d_to_cam,
                                      maxt=dist - 2 * eps))
            imp = _importance(scene, -d_to_cam)
            gw = imp / jnp.maximum(dist * dist, 1e-9)
            val = contrib_v * gw[:, None]
            ok = valid & on_film & ~occ
            val = jnp.where(ok[:, None], val, 0.0)
            px = jnp.clip(pos[:, 0].astype(jnp.int32), 0, w - 1)
            py = jnp.clip(pos[:, 1].astype(jnp.int32), 0, h - 1)
            idx = py * w + px
            data = jnp.concatenate([val, jnp.zeros((n, 1))], -1)
            return acc.at[idx].add(data)

        st = dict(p=p, d=d, weight=weight, active=jnp.ones((n,), bool),
                  sampler=sampler, acc=acc, depth=jnp.zeros((n,), jnp.int32))

        def body(st):
            ray = Ray(o=st["p"] + st["d"] * 1e-4, d=st["d"],
                      maxt=jnp.full((n,), jnp.inf))
            si = ray_intersect(scene, ray)
            active = st["active"] & si.valid
            bsdf_idx = m.table_lookup(scene.shape_bsdf,
                                      jnp.maximum(si.shape, 0))
            # connect surface vertex to the camera through the BSDF
            R, t = _camera_axes(scene)
            d_cam = m.normalize(t - si.p)
            wo_local = si.to_local(d_cam)
            bval, _ = bsdf_eval_pdf(scene, si, bsdf_idx, wo_local)
            contrib = st["weight"] * bval
            acc = connect(st["acc"], si.p, contrib, active)
            # continue the light path
            u1, sampler = st["sampler"].next_1d()
            u2, sampler = sampler.next_2d()
            bs = bsdf_sample(scene, si, bsdf_idx, u1, u2)
            wo_w = si.to_world(bs.wo)
            weight = st["weight"] * bs.weight
            urr, sampler = sampler.next_1d()
            q = jnp.minimum(jnp.max(weight, -1), 0.95)
            keep = (urr < q) | (st["depth"] < scene.rr_depth)
            weight = jnp.where((st["depth"] >= scene.rr_depth)[:, None],
                               weight / jnp.maximum(q, 1e-8)[:, None],
                               weight)
            alive = active & (bs.pdf > 0) & keep \
                & (st["depth"] + 1 < scene.max_depth)
            return dict(p=si.p, d=wo_w, weight=weight, active=alive,
                        sampler=sampler, acc=acc,
                        depth=st["depth"] + 1)

        # initial connection from the emitter vertex itself (area emitters
        # are seen directly by the camera via the forward integrators; the
        # adjoint splats only scattered light — ptracer.cpp hide_emitters
        # semantics handled by the caller)
        def step(s, _):
            return body(s), None
        st, _ = jax.lax.scan(step, st, None, length=scene.max_depth)
        norm = (w * h) / jnp.float32(n)
        img = st["acc"][:, 0:3].reshape(h, w, 3) * norm
        return img

    return run(scene, seed)
