"""Classical isotropic dipole BSSRDF (Jensen et al. 2001).

Capability analog of reference src/subsurface/dipole.cpp (not built there,
subsurface/CMakeLists.txt:3, but part of the fork's subsurface family):
  preprocess  — surface point set with per-point direct irradiance
                (irrproc.cpp worker; blue-noise set replaced by area-uniform
                samples, the octree by a dense gather — the flat sum
                over ~1k points is a few fused FLOPs per lane, cheaper than
                divergent tree traversal)
  eval        — Mo(p) = sum_i Rd(||p - xi||) E_i A_i with the standard
                dipole Rd (dipole.cpp IsotropicDipoleQuery:11-45; NOTE the
                snapshot passes the *unsquared* distance into r^2 — we use
                the published r^2 formulation), Lo = Ft/(pi) * Mo.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.fresnel import fresnel_dielectric

CHUNK = 256


def fresnel_diffuse_reflectance(eta):
    """Polynomial fit of the diffuse Fresnel reflectance (fresnel.h
    fresnel_diffuse_reflectance; Egan & Hilgeman)."""
    e = eta
    return np.where(
        e < 1.0,
        -0.4399 + 0.7099 / e - 0.3319 / e ** 2 + 0.0636 / e ** 3,
        -1.4399 / e ** 2 + 0.7099 / e + 0.6681 + 0.0636 * e)


def dipole_constants(sigma_s, sigma_a, g, eta):
    """(zr, zv, sigma_tr, fdr) per channel (dipole.cpp configure :105-118)."""
    sigma_s = np.asarray(sigma_s, np.float64)
    sigma_a = np.asarray(sigma_a, np.float64)
    sigma_sp = sigma_s * (1.0 - g)
    sigma_tp = sigma_sp + sigma_a
    fdr = float(fresnel_diffuse_reflectance(1.0 / eta))
    A = (1.0 + fdr) / (1.0 - fdr)
    mfp = 1.0 / np.maximum(sigma_tp, 1e-9)
    sigma_tr = np.sqrt(3.0 * sigma_a * sigma_tp)
    zr = mfp
    zv = mfp * (1.0 + 4.0 / 3.0 * A)
    return (zr.astype(np.float32), zv.astype(np.float32),
            sigma_tr.astype(np.float32), np.float32(fdr))


def compute_irradiance(scene, points, normals, n_light_samples: int = 8,
                       seed: int = 13):
    """Direct irradiance E at surface points (irrproc.cpp:28-62 worker):
    NEE-estimated, batched over points."""
    from ..core.rng import make_sampler
    from ..core.types import Ray
    from ..accel.intersect import ray_test
    from ..emitter.dispatch import sample_emitter_direction

    pts = jnp.asarray(points)
    nrm = jnp.asarray(normals)
    n = pts.shape[0]

    @jax.jit
    def one_round(scene, k):
        sampler = make_sampler(jnp.arange(n, dtype=jnp.uint32), k, seed)
        u2, sampler = sampler.next_2d()
        u1, sampler = sampler.next_1d()
        ds, em_w = sample_emitter_direction(scene, pts, u2, u1)
        cos_i = jnp.sum(ds.d * nrm, -1)
        ok = (ds.pdf > 0) & (cos_i > 0)
        eps = (1.0 + jnp.max(jnp.abs(pts), -1)) * 1e-4
        occ = ray_test(scene, Ray(o=pts + ds.d * eps[:, None], d=ds.d,
                                  maxt=ds.dist * (1 - 1e-3) - eps))
        val = em_w * cos_i[:, None]
        return jnp.where((ok & ~occ)[:, None], val, 0.0)

    E = jnp.zeros((n, 3))
    for k in range(n_light_samples):
        E = E + one_round(scene, k)
    return E / n_light_samples


def dipole_lo(scene, p, wi_cos, active):
    """Outgoing radiance at entry points p with incident cosine wi_cos:
    Lo = Ft(cos)/pi * Mo(p).  Sums over the precomputed irradiance point
    set in chunks (the octree replacement)."""
    ss = scene.ssub
    zr = ss.dip_consts[0:3]
    zv = ss.dip_consts[3:6]
    sigma_tr = ss.dip_consts[6:9]
    eta = ss.dip_consts[9]

    n = p.shape[0]
    pts = ss.dip_points        # (P, 3)
    E = ss.dip_irradiance      # (P, 3)
    area = ss.dip_area         # (P,)
    P = pts.shape[0]

    def chunk_body(c, acc):
        sl = jax.lax.dynamic_slice_in_dim(pts, c * CHUNK, CHUNK, 0)
        El = jax.lax.dynamic_slice_in_dim(E, c * CHUNK, CHUNK, 0)
        Al = jax.lax.dynamic_slice_in_dim(area, c * CHUNK, CHUNK, 0)
        r2 = jnp.sum((p[:, None, :] - sl[None, :, :]) ** 2, -1)  # (N, C)
        r2 = r2[..., None]                                        # (N, C, 1)
        dr = jnp.sqrt(r2 + zr * zr)
        dv = jnp.sqrt(r2 + zv * zv)
        c1 = zr * (sigma_tr + 1.0 / dr)
        c2 = zv * (sigma_tr + 1.0 / dv)
        rd = (1.0 / (4.0 * jnp.pi)) * (
            c1 * jnp.exp(-sigma_tr * dr) / (dr * dr)
            + c2 * jnp.exp(-sigma_tr * dv) / (dv * dv))
        return acc + jnp.sum(rd * El[None] * Al[None, :, None], axis=1)

    n_chunks = (P + CHUNK - 1) // CHUNK
    mo = jax.lax.fori_loop(0, n_chunks, chunk_body, jnp.zeros((n, 3)))
    fr, _, _, _ = fresnel_dielectric(wi_cos, eta)
    lo = (1.0 - fr)[:, None] / jnp.pi * mo
    return jnp.where(active[:, None], lo, 0.0)
