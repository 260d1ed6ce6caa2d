"""Quantitative VAE-BSSRDF validation against the volpath3d ground truth.

The reference's own training methodology (sss_particle_tracer.h:242,335):
the learned model approximates the exit-position distribution and
absorption probability of a brute-force random walk inside the shape.
This tool reruns that comparison on a unit sphere across an
(albedo, g, eta, sigma_t) grid:

  * ground truth — ssub/volpath3d.sample_paths on the EXACT sphere
    implicit f(p) = |p|^2 - 1 (degree-2 fits the degree-3 basis exactly),
    conditioned on >= 1 scatter (the VAE handles zero-scatter paths by the
    separate analytic passthrough test, vaescatter.cpp:281-305);
  * model — the full production plumbing via ssub/event.subsurface_event
    on a triangulated sphere scene: per-vertex poly fit -> feature
    normalization -> light-space rotation -> decoder -> surface
    projection (so a regression ANYWHERE in that chain moves the stats).

Reported per grid point: absorption probability (VAE head vs GT rate) and
the exit-distance distribution ||exit - entry|| (mean + quantiles).

    python tools/vae_validate.py [--n 8192] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def uv_sphere(n_theta=24, n_phi=48, radius=1.0):
    verts, faces = [], []
    for i in range(n_theta + 1):
        th = np.pi * i / n_theta
        for j in range(n_phi):
            ph = 2 * np.pi * j / n_phi
            verts.append([radius * np.sin(th) * np.cos(ph),
                          radius * np.sin(th) * np.sin(ph),
                          radius * np.cos(th)])
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces += [[a, d, b], [a, c, d]]      # outward winding
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def sphere_coeffs():
    """f(p) = x^2 + y^2 + z^2 - 1 in the ssub/poly.py monomial order."""
    import jax.numpy as jnp
    c = np.zeros(20, np.float32)
    c[0] = -1.0
    c[4] = 1.0    # x^2
    c[7] = 1.0    # y^2
    c[9] = 1.0    # z^2
    return jnp.asarray(c)


def run_point(sigma_t, albedo, g, eta, n=8192, seed=0):
    import jax.numpy as jnp

    import liverrenderer as lr
    from liverrenderer.accel.intersect import ray_intersect
    from liverrenderer.core.rng import make_sampler
    from liverrenderer.core.types import Ray
    from liverrenderer.ssub import volpath3d
    from liverrenderer.ssub.event import subsurface_event

    verts, faces = uv_sphere()
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {
            "type": "perspective", "fov": 30.0,
            "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 8, "height": 8,
                     "rfilter": {"type": "box"}},
        },
        "blob": {"type": "mesh", "vertices": verts, "faces": faces,
                 "subsurface": {"type": "vaescatter",
                                "sigmaT": {"type": "rgb",
                                           "value": [sigma_t] * 3},
                                "albedo": {"type": "rgb",
                                           "value": [albedo] * 3},
                                "g": g, "eta": eta}},
        "lamp": {"type": "point", "position": [3.0, 3.0, 3.0],
                 "intensity": {"type": "rgb", "value": [10.0] * 3}},
    }
    scene = lr.load_dict(d)

    # entry: N identical camera-style rays straight down +z onto the pole
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 4.0]]), (n, 1))
    dd = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    si = ray_intersect(scene, Ray(o=o, d=dd, maxt=jnp.full((n,), jnp.inf)))
    assert bool(si.valid.all())
    sampler = make_sampler(jnp.arange(n, dtype=jnp.uint32),
                           jnp.zeros((n,), jnp.uint32),
                           jnp.uint32(seed), kind=scene.sampler_kind, spp=1)

    ev, _ = subsurface_event(scene, si, dd, sampler,
                             jnp.ones((n,), bool))
    vae_exit = np.asarray(ev.alive & ~ev.passthrough)
    entry = np.asarray(si.p)
    r_vae = np.linalg.norm(np.asarray(ev.out_p) - entry, axis=-1)[vae_exit]
    went_vae = np.asarray(~ev.passthrough)
    stats_vae = {
        "absorb_p": float(np.asarray(ev.absorb_p)[0]),
        "passthrough_rate": float(np.asarray(ev.passthrough).mean()),
        "n_exits": int(vae_exit.sum()),
        "exit_mean": float(r_vae.mean()),
        "exit_q": [float(q) for q in np.quantile(r_vae,
                                                 [0.25, 0.5, 0.75, 0.9])],
        "absorbed_rate": float(np.asarray(ev.absorbed)[went_vae].mean()),
    }

    # ground truth: exact-sphere random walk from the same entry point,
    # conditioned on >= 1 scatter
    sampler2 = make_sampler(jnp.arange(n, dtype=jnp.uint32),
                            jnp.ones((n,), jnp.uint32),
                            jnp.uint32(seed + 1), kind=scene.sampler_kind,
                            spp=2)
    entry_gt = jnp.asarray(entry / np.linalg.norm(entry, axis=-1,
                                                  keepdims=True)
                           * (1.0 - 1e-5))
    res, _ = volpath3d.sample_paths(sphere_coeffs(), entry_gt, dd,
                                    sigma_t, albedo, g, sampler2,
                                    max_bounces=512, eta=eta)
    scat = np.asarray(res.n_bounces) >= 1
    absorbed = np.asarray(res.absorbed)
    exited = np.asarray(res.exited) & scat & ~absorbed
    r_gt = np.linalg.norm(np.asarray(res.out_p) - entry, axis=-1)[exited]
    stats_gt = {
        "absorb_rate": float(absorbed[scat].mean()),
        "zero_scatter_rate": float((~scat).mean()),
        "n_exits": int(exited.sum()),
        "exit_mean": float(r_gt.mean()),
        "exit_q": [float(q) for q in np.quantile(r_gt,
                                                 [0.25, 0.5, 0.75, 0.9])],
    }
    return {"params": {"sigma_t": sigma_t, "albedo": albedo, "g": g,
                       "eta": eta},
            "vae": stats_vae, "gt": stats_gt}


GRID = [
    (50.0, 0.95, 0.0, 1.0),
    (100.0, 0.99, 0.0, 1.0),
    (50.0, 0.90, 0.0, 1.0),
    (50.0, 0.95, 0.5, 1.0),
    (100.0, 0.95, 0.0, 1.3),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import jax
    if a.cpu:
        jax.config.update("jax_platforms", "cpu")
    from liverrenderer.compile_cache import enable_compile_cache
    enable_compile_cache()
    rows = []
    for st, al, g, eta in GRID:
        row = run_point(st, al, g, eta, n=a.n)
        rows.append(row)
        print(json.dumps(row))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
