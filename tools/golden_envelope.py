"""Golden-parity envelope analysis (VERDICT r4 #2).

The reference ships each liver scene's render from THREE of its own
variants (Mitsuba 3 CPU / Mitsuba 3 GPU / Mitsuba 0.6); their mutual
SSIM/RMSE is the reference's *self*-disagreement band — the tightest
parity any reimplementation can be held to.  This tool computes the full
triangle: every golden pair, plus our converged mean render (saved by
tools/ssim_curve.py) against each golden, at the same downsample.

    python tools/golden_envelope.py [--ds 8]
        -> results/golden_envelope_r5.json

Round-5 findings (ds8):
  GlissonCapsule — ours-vs-M0.6 SSIM 0.904 / RMSE 0.0144 BEATS the
  reference's own M3CPU-vs-M0.6 agreement (0.8835 / 0.0281): the
  envelope is cleared.  Seed spread of our curve at 16k spp: 0.0012
  across 3 seeds (ssim_curve_glisson_r5.json).
  Parenchyma — ours-vs-M3CPU RMSE 0.0185 beats M3CPU-vs-M0.6 (0.0193);
  SSIM 0.921 at 16k spp and still climbing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCENES = {
    "GlissonCapsule": {
        "goldens": {
            "M3CPU": "GlissonCapsule/mitsuba3/outputs/Mitsuba3/CPU/"
                     "glissoncapsule.png",
            "M3GPU": "GlissonCapsule/mitsuba3/outputs/Mitsuba3/GPU/"
                     "glissoncapsule.png",
            "M06": "GlissonCapsule/mitsuba3/outputs/Mitsuba0.6/"
                   "glissoncapsule.png",
        },
        "ours": "results/curve_glissoncapsule_mean.npy",
    },
    "Parenchyma": {
        "goldens": {
            "M3CPU": "Parenchyma/mitsuba3/outputs/Mitsuba/CPU/"
                     "parenchyma.png",
            "M3GPU": "Parenchyma/mitsuba3/outputs/Mitsuba/GPU/"
                     "parenchyma.png",
            "M06": "Parenchyma/mitsuba3/outputs/Mitsuba0.6/parenchyma.png",
        },
        "ours": "results/curve_parenchyma_mean.npy",
    },
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ds", type=int, default=8)
    ap.add_argument("--out", default="results/golden_envelope_r5.json")
    a = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import liverrenderer as lr
    from liverrenderer.pipeline.results import rmse, ssim
    from liverrenderer.tonemap import tonemap

    ds = a.ds

    def dsz(img):
        h, w = img.shape[0] // ds * ds, img.shape[1] // ds * ds
        return np.clip(img[:h, :w].reshape(h // ds, ds, w // ds, ds, 3)
                       .mean((1, 3)), 0, 1)

    out = {}
    for name, cfg in SCENES.items():
        imgs = {}
        for tag, rel in cfg["goldens"].items():
            p = os.path.join("/root/reference/scenes", rel)
            if not os.path.exists(p):
                continue
            imgs[tag] = dsz(lr.read_image(p, srgb_to_linear=False)[..., :3])
        if os.path.exists(cfg["ours"]):
            imgs["ours"] = np.clip(
                np.asarray(tonemap(np.load(cfg["ours"]))), 0, 1)
        tags = list(imgs)
        pairs = {}
        for i, t1 in enumerate(tags):
            for t2 in tags[i + 1:]:
                pairs[f"{t1}_vs_{t2}"] = {
                    "ssim": round(ssim(imgs[t1], imgs[t2]), 4),
                    "rmse": round(rmse(imgs[t1], imgs[t2]), 5)}
        out[name] = {"ds": ds, "pairs": pairs}
    with open(a.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
