"""Wavefront subsurface-scattering event (vaescatter).

The reference handles SSS by recursing from the path integrator into
VaeScatter::LoImpl (vaescatter.cpp:229-476, hook path.cpp:262-265), which
(1) samples the internal dielectric, (2) tests zero-scattering straight
through the object, (3) samples an outgoing position with the VAE decoder
(one random RGB channel, weight 3*onehot — the m_use_rgb single-sample
variant), (4) projects it onto the real surface along the polynomial
gradient, and (5) leaves via a cosine lobe with NEE+MIS at the exit point.

Here the recursion is flattened into the wavefront: an SSS event consumes
one bounce and rewrites the lane's ray to the exit ray; NEE at the exit
point happens inline.  Design deviations (documented):
  * zero-scatter pass-through continues the straight ray from the exit
    point instead of recursing through the exit boundary BSDF;
  * Sw uses the physically-based normalized diffuse transmission
    (1 - Fr(cos))/ (pi * c), c = 1 - 2*C1(1/eta) (the snapshot's Sw returns
    the raw Fresnel reflectance, vaescatter.cpp:182-189 — we keep the
    published formulation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import math as m
from ..core.fresnel import fresnel_dielectric
from ..core.types import Ray
from ..core.warp import square_to_cosine_hemisphere
from . import vae
from .poly import (eval_poly_grad, fit_scale, kernel_eps, onb_duff,
                   poly_normal_and_adjusted_dir, rotate_poly)

Array = jax.Array


def fresnel_moment1(eta):
    """First Fresnel moment C1 (vaescatter.cpp FresnelMoment1)."""
    e2, e3 = eta * eta, eta ** 3
    e4, e5 = eta ** 4, eta ** 5
    lo = 0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3 \
        + 2.49277 * e4 - 0.68441 * e5
    hi = -4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3 \
        - 1.27198 * e4 + 0.12746 * e5
    return jnp.where(eta < 1.0, lo, hi)


def sw_factor(cos_o, eta):
    """Normalized diffuse transmission factor S_w (PBD 11.4):
    (1 - Fr(cos)) / (c * pi), c = 1 - 2 C1(1/eta)."""
    fr, _, _, _ = fresnel_dielectric(cos_o, eta)
    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    return (1.0 - fr) / jnp.maximum(c * jnp.pi, 1e-6)


@struct.dataclass
class SSEvent:
    """Result of the per-lane subsurface event."""
    alive: Array        # lane continues
    passthrough: Array  # zero-scatter straight continuation
    out_p: Array        # (N,3) continuation origin
    out_d: Array        # (N,3) continuation direction
    out_n: Array        # (N,3) exit normal
    weight: Array       # (N,3) throughput multiplier
    pdf: Array          # (N,) pdf of the continuation dir (cosine lobe)
    L_nee: Array        # (N,3) exit-point NEE contribution (x throughput)
    absorbed: Array     # (N,) VAE absorption-head kill (validation AOV)
    absorb_p: Array     # (N,) the absorption probability itself


def _nearest_vertex_poly(scene, si):
    """Per-lane (3, 20) world-space poly coeffs of the nearest hit vertex."""
    prim = jnp.maximum(si.prim, 0)
    f = scene.faces[prim]                         # (N, 3)
    # barycentrics of the hit (w, u, v) -> nearest corner
    # si carries uv as texture coords; recompute weights from position
    v0 = scene.vertices[f[:, 0]]
    v1 = scene.vertices[f[:, 1]]
    v2 = scene.vertices[f[:, 2]]
    d0 = jnp.sum((si.p - v0) ** 2, -1)
    d1 = jnp.sum((si.p - v1) ** 2, -1)
    d2 = jnp.sum((si.p - v2) ** 2, -1)
    sel = jnp.argmin(jnp.stack([d0, d1, d2], -1), -1)
    vid = jnp.where(sel == 0, f[:, 0],
                    jnp.where(sel == 1, f[:, 1], f[:, 2]))
    return scene.ssub.poly[vid], vid


def subsurface_event(scene, si, refr_d, sampler, active):
    """Run the VAE SSS event for `active` lanes.

    si: surface interaction at the entry point (from outside);
    refr_d: world direction of the transmitted (refracted) ray into the
    object.  Returns (SSEvent, sampler)."""
    from ..accel.intersect import ray_intersect, ray_test
    from ..emitter.dispatch import sample_emitter_direction

    n = refr_d.shape[0]
    ss_idx = m.table_lookup(scene.shape_subsurface,
                            jnp.maximum(si.shape, 0))
    prm = m.table_lookup(scene.ssub.params, jnp.maximum(ss_idx, 0))      # (N, 8)
    sigma_t = prm[:, 0:3]
    albedo = prm[:, 3:6]
    g = prm[:, 6]
    eta = prm[:, 7]
    w = scene.ssub.weights

    # ---- 1) zero-scatter test (vaescatter.cpp:281-305) ----
    eps0 = (1.0 + jnp.max(jnp.abs(si.p), -1)) * 1e-4
    zray = Ray(o=si.p + refr_d * eps0[:, None], d=refr_d,
               maxt=jnp.full((n,), jnp.inf))
    zits = ray_intersect(scene, zray)
    dead = active & ~zits.valid                 # degenerate: no exit found
    mean_sig = jnp.mean(sigma_t, -1)
    u_zs, sampler = sampler.next_1d()
    p_scatter = 1.0 - jnp.exp(-mean_sig * zits.t)
    passthrough = active & zits.valid & (u_zs > p_scatter)
    do_vae = active & zits.valid & ~passthrough

    # ---- 2) channel pick + poly features ----
    u_ch, sampler = sampler.next_1d()
    channel = jnp.minimum((u_ch * 3).astype(jnp.int32), 2)
    poly3, vid = _nearest_vertex_poly(scene, si)         # (N, 3, 20)
    ch3 = channel[:, None]
    coeffs_ws = jnp.where(ch3 == 0, poly3[:, 0],
                          jnp.where(ch3 == 1, poly3[:, 1],
                                    poly3[:, 2]))        # (N, 20)

    from ..media.dispatch import _index_spectrum
    sig_c = _index_spectrum(sigma_t, channel)
    alb_c = _index_spectrum(albedo, channel)
    k_eps = kernel_eps(sig_c, alb_c, g, scene.ssub.kernel_eps_scale)
    f_scale = fit_scale(k_eps)

    # polynomial normal + adjusted incident direction
    in_dir = -refr_d   # reference inDir = -d with d = refracted (into obj)
    vtx = scene.vertices[vid]
    pn, in_dir_adj = poly_normal_and_adjusted_dir(coeffs_ws, in_dir,
                                                  si.sh_frame.n)

    # light-space frame around the adjusted in direction (onbDuff(d))
    s_ax, t_ax = onb_duff(in_dir_adj)
    S = jnp.stack([s_ax, t_ax, in_dir_adj], -1)          # columns = s,t,n
    coeffs_ls = rotate_poly(coeffs_ws, S)

    # ---- 3) network inference ----
    feats_in = vae.preprocess_features(w, coeffs_ls, alb_c, g, eta, sig_c)
    feat = vae.shared_features(w, feats_in)
    absorb_p = vae.absorption_prob(w, feat)
    u_abs, sampler = sampler.next_1d()
    absorbed = do_vae & (u_abs < absorb_p)
    do_vae &= ~absorbed

    u4, sampler = sampler.next_nd(4)
    z0, z1 = vae.gaussian_from_uniform(u4[:, 0], u4[:, 1])
    z2, z3 = vae.gaussian_from_uniform(u4[:, 2], u4[:, 3])
    latent = jnp.stack([z0, z1, z2, z3], -1)
    out_local = vae.decode_outpos(w, feat, latent)       # (N, 3) tangent

    # epsilon-space: offset in the tangent frame of in_dir_adj, scaled by
    # 1/fitScaleFactor (scattereigen.h:467-476 localToWorld + eps space)
    offset = (out_local[:, 0:1] * s_ax + out_local[:, 1:2] * t_ax
              + out_local[:, 2:3] * in_dir_adj)
    sampled_p = si.p + offset / f_scale[:, None]

    # ---- 4) projection onto the surface (projectPointsToSurface) ----
    rel = (sampled_p - vtx) * f_scale[:, None]
    grad = eval_poly_grad(coeffs_ws, rel)
    gdir = m.normalize(grad)
    maxd = 2.0 * k_eps
    r1 = Ray(o=sampled_p, d=gdir, maxt=maxd)
    i1 = ray_intersect(scene, r1)
    r2 = Ray(o=sampled_p, d=-gdir,
             maxt=jnp.where(i1.valid, i1.t, maxd))
    i2 = ray_intersect(scene, r2)
    use2 = i2.valid & (~i1.valid | (i2.t < i1.t))
    proj_ok = i1.valid | i2.valid
    # fallback round with unbounded rays (polynomials.h dists[2] = {2eps, inf})
    r1b = Ray(o=sampled_p, d=gdir, maxt=jnp.full((n,), jnp.inf))
    i1b = ray_intersect(scene, r1b)
    r2b = Ray(o=sampled_p, d=-gdir,
              maxt=jnp.where(i1b.valid, i1b.t, jnp.inf))
    i2b = ray_intersect(scene, r2b)
    use2b = i2b.valid & (~i1b.valid | (i2b.t < i1b.t))
    ok_b = i1b.valid | i2b.valid

    exit_p = jnp.where(use2[:, None], i2.p, i1.p)
    exit_n = jnp.where(use2[:, None], i2.sh_frame.n, i1.sh_frame.n)
    exit_pb = jnp.where(use2b[:, None], i2b.p, i1b.p)
    exit_nb = jnp.where(use2b[:, None], i2b.sh_frame.n, i1b.sh_frame.n)
    exit_p = jnp.where(proj_ok[:, None], exit_p, exit_pb)
    exit_n = jnp.where(proj_ok[:, None], exit_n, exit_nb)
    proj_ok = proj_ok | ok_b
    do_vae &= proj_ok

    # ---- 5) exit: cosine lobe + Sw, NEE at the exit point ----
    onehot = jax.nn.one_hot(channel, 3, dtype=jnp.float32)
    weight = onehot * 3.0 * (eta * eta)[:, None]         # vaescatter.cpp:333

    u2d, sampler = sampler.next_2d()
    wo_local = square_to_cosine_hemisphere(u2d)
    cos_o = wo_local[:, 2]
    fr_s, fr_t = onb_duff(exit_n)
    out_d = (wo_local[:, 0:1] * fr_s + wo_local[:, 1:2] * fr_t
             + wo_local[:, 2:3] * exit_n)
    pdf_cos = jnp.maximum(cos_o, 1e-6) / jnp.pi
    sw = sw_factor(cos_o, eta)
    # contribution of the continuing path: throughput * Sw * cos / pdf
    cont_w = weight * (sw * jnp.pi)[:, None]

    # NEE with the diffuse exit lobe (vaescatter.cpp:420-455)
    u2e, sampler = sampler.next_2d()
    u1e, sampler = sampler.next_1d()
    ds, em_w = sample_emitter_direction(scene, exit_p, u2e, u1e)
    cos_e = jnp.sum(ds.d * exit_n, -1)
    nee_ok = do_vae & (ds.pdf > 0) & (cos_e > 0)
    epsn = (1.0 + jnp.max(jnp.abs(exit_p), -1)) * 1e-4
    occ = ray_test(scene, Ray(o=exit_p + ds.d * epsn[:, None], d=ds.d,
                              maxt=ds.dist * (1 - 1e-3) - epsn))
    nee_ok &= ~occ
    bsdf_val = cos_e / jnp.pi
    bsdf_pdf = jnp.where(ds.delta, 0.0, bsdf_val)
    mis_e = m.mis_weight(ds.pdf, bsdf_pdf)
    sw_e = sw_factor(cos_e, eta)
    L_nee = jnp.where(
        nee_ok[:, None],
        weight * em_w * (bsdf_val * jnp.pi * sw_e * mis_e)[:, None], 0.0)

    # pass-through continuation
    out_p = jnp.where(passthrough[:, None],
                      zits.p + refr_d * eps0[:, None], exit_p)
    out_d = jnp.where(passthrough[:, None], refr_d, out_d)
    weight_final = jnp.where(passthrough[:, None], jnp.ones((n, 3)), cont_w)
    pdf = jnp.where(passthrough, 1.0, pdf_cos)

    alive = (passthrough | do_vae) & ~dead & ~absorbed
    return SSEvent(alive=alive, passthrough=passthrough,
                   out_p=out_p, out_d=out_d, out_n=exit_n,
                   weight=weight_final, pdf=pdf,
                   L_nee=jnp.where(do_vae[:, None], L_nee, 0.0),
                   absorbed=absorbed, absorb_p=absorb_p), sampler
