"""spp -> SSIM convergence curves for the weak golden scenes (VERDICT r2 #2).

Renders each scene ONCE-compiled (fixed res, fixed spp chunk) across many
seeds and reports cumulative RMSE/SSIM vs the reference golden after 1, 2,
4, ... chunks.  If SSIM climbs with spp the residual is noise; if it
plateaus the plateau value bounds the bias.

    python tools/ssim_curve.py [--scenes A,B,...] [--ds 2] [--chunk 128]
        [--chunks 8] [--out results/ssim_curve.json]

Reference analog: results.py RMSE/SSIM plots over the shipped goldens.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from liverrenderer.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

SCENES_DIR = "/root/reference/scenes"


def run_scene(name, ds, chunk, n_chunks, variant=None, seed_base=100):
    import liverrenderer as lr
    from liverrenderer.pipeline.evaluate import CONFIGS, _load_scene
    from liverrenderer.pipeline.results import rmse, ssim
    from liverrenderer.tonemap import tonemap

    xml, golden, mask, opts = CONFIGS[name]
    opts = dict(opts)
    opts.pop("denoise_probe", None)
    if variant:
        opts.update(variant)
    gpath = os.path.join(SCENES_DIR, golden)
    is_ldr = gpath.lower().endswith(".png")
    g = lr.read_image(gpath, srgb_to_linear=False)[..., :3]
    gh, gw = g.shape[0] - g.shape[0] % ds, g.shape[1] - g.shape[1] % ds
    g = g[:gh, :gw]
    h, w = gh // ds, gw // ds
    gd = g.reshape(h, ds, w, ds, 3).mean((1, 3))
    b = np.clip(gd, 0, 1)

    scene = _load_scene(os.path.join(SCENES_DIR, xml), opts, w, h, chunk)
    acc = np.zeros((h, w, 3), np.float64)
    curve = []
    t_start = time.time()
    for i in range(n_chunks):
        img = np.asarray(lr.render(scene, spp=chunk, seed=seed_base + i),
                         np.float64)
        acc += img
        mean = acc / (i + 1)
        disp = tonemap(mean) if is_ldr else mean
        a = np.clip(np.asarray(disp), 0, 1)
        pt = {"spp": chunk * (i + 1), "rmse": round(rmse(a, b), 5),
              "ssim": round(ssim(a, b), 5)}
        curve.append(pt)
        print(f"  {name}: spp={pt['spp']} rmse={pt['rmse']} "
              f"ssim={pt['ssim']} ({time.time() - t_start:.0f}s)",
              flush=True)
    np.save(f"results/curve_{name.lower()}_mean.npy",
            (acc / n_chunks).astype(np.float32))
    return {"config": f"{w}x{h} ds{ds} chunk {chunk}spp"
                      + (f" variant={variant}" if variant else ""),
            "curve": curve, "wall_s": round(time.time() - t_start, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default=(
        "Liver-SingleMesh,GlissonCapsule,SphereLiverConstEnv"))
    ap.add_argument("--ds", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--out", default="results/ssim_curve.json")
    ap.add_argument("--variant", default=None,
                    help="JSON opts override, e.g. "
                         "'{\"integrator\": \"biovolpath06\"}'")
    ap.add_argument("--tag", default=None, help="suffix for the result key")
    ap.add_argument("--seed-base", type=int, default=100,
                    help="first RNG seed (seed spread studies)")
    a = ap.parse_args()

    variant = json.loads(a.variant) if a.variant else None
    out = {}
    if os.path.exists(a.out):
        with open(a.out) as f:
            out = json.load(f)
    for name in a.scenes.split(","):
        key = name + (f"+{a.tag}" if a.tag else "")
        print(f"== {key} ==", flush=True)
        out[key] = run_scene(name, a.ds, a.chunk, a.chunks, variant,
                             seed_base=a.seed_base)
        with open(a.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
