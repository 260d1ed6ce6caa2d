"""Object-level SSS radiance cross-check (VERDICT r4 #3b).

Renders the SAME translucent sphere three ways and compares object-region
radiance:

  * volpath  — brute-force ground truth: dielectric boundary + an actual
    homogeneous interior medium, path-traced with the volumetric
    integrator (the transport the VAE was trained to imitate);
  * vae      — the learned vaescatter BSSRDF through the production hook
    (ssub/event.py);
  * dipole   — the classical Jensen dipole (ssub/dipole.py).

If the vaescatter render sits near/between the brute-force and dipole
estimates, object-level SSS radiance is validated END-TO-END without any
external golden — the check the stale SphereLiverPoint golden cannot
provide.

    python tools/sss_bracket.py [--cpu] [--res 64] [--spp 64]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SIGMA_T = 30.0
ALBEDO = 0.95
G = 0.0
ETA = 1.3


def scene_dict(mode, res, verts, faces):
    import liverrenderer as lr
    d = {
        "type": "scene",
        "integrator": ({"type": "volpath", "max_depth": 256}
                       if mode == "volpath"
                       else {"type": "path", "max_depth": 6}),
        "sensor": {
            "type": "perspective", "fov": 38.0,
            "to_world": lr.Transform().look_at([0, 0, 4.0], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
        },
        # env-only illumination: a point light would be unreachable by the
        # brute-force path tracer (BSDF sampling cannot hit a delta light
        # and NEE cannot connect through the delta dielectric boundary),
        # while the BSSRDFs' diffusion approximation subsumes the boundary
        # crossing — the env is the one emitter all three estimators
        # sample fairly
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }
    blob = {"type": "mesh", "vertices": verts, "faces": faces}
    if mode == "volpath":
        blob["bsdf"] = {"type": "dielectric", "int_ior": ETA,
                        "ext_ior": 1.0}
        blob["interior"] = {
            "type": "homogeneous",
            "sigma_t": {"type": "rgb", "value": [SIGMA_T] * 3},
            "albedo": {"type": "rgb", "value": [ALBEDO] * 3},
            "phase": {"type": "hg", "g": G},
        }
    else:
        blob["subsurface"] = {"type": mode,
                              "sigmaT": {"type": "rgb",
                                         "value": [SIGMA_T] * 3},
                              "albedo": {"type": "rgb",
                                         "value": [ALBEDO] * 3},
                              "g": G, "eta": ETA}
    d["blob"] = blob
    return d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--spp-gt", type=int, default=None,
                    help="volpath spp (default: 4x --spp)")
    ap.add_argument("--out", default="results/sss_bracket.json")
    a = ap.parse_args()
    import jax
    if a.cpu:
        jax.config.update("jax_platforms", "cpu")
    from liverrenderer.compile_cache import enable_compile_cache
    enable_compile_cache()

    import liverrenderer as lr
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vae_validate import uv_sphere
    verts, faces = uv_sphere()

    out = {"params": {"sigma_t": SIGMA_T, "albedo": ALBEDO, "g": G,
                      "eta": ETA},
           "config": f"{a.res}x{a.res}"}
    imgs = {}
    for mode in ("volpath", "vaescatter", "dipole"):
        spp = (a.spp_gt or a.spp * 4) if mode == "volpath" else a.spp
        sc = lr.load_dict(scene_dict(mode, a.res, verts, faces))
        img = np.asarray(lr.render(sc, spp=spp, seed=3))
        imgs[mode] = img
        lr.write_image(f"results/sss_bracket_{mode}.png", img)

    # object mask: pixels whose primary ray hits the sphere (projected
    # disc) — approximate by the central disc of the 38-deg framing
    h = w = a.res
    yy, xx = np.mgrid[0:h, 0:w]
    cx = cy = (a.res - 1) / 2
    # sphere radius 1 at distance 4, fov 38 deg -> angular radius
    ang = np.arcsin(1.0 / 4.0)
    px_r = np.tan(ang) / np.tan(np.deg2rad(38.0 / 2)) * (w / 2)
    mask = ((xx - cx) ** 2 + (yy - cy) ** 2) < (0.9 * px_r) ** 2
    for mode, img in imgs.items():
        out[mode] = {
            "spp": (a.spp_gt or a.spp * 4) if mode == "volpath" else a.spp,
            "object_mean": [float(v) for v in img[mask].reshape(-1, 3)
                            .mean(0)],
            "image_mean": [float(v) for v in img.reshape(-1, 3).mean(0)],
        }
    gt = np.asarray(out["volpath"]["object_mean"])
    for mode in ("vaescatter", "dipole"):
        v = np.asarray(out[mode]["object_mean"])
        out[mode]["ratio_vs_volpath"] = [float(x) for x in
                                         v / np.maximum(gt, 1e-9)]
    os.makedirs("results", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
