"""End-to-end render time with each triangle intersector on the GPU.

    python tools/strategy_e2e.py [--spp 4] [--out FILE]

Renders the liver stand-in (biovolpath, 5,122 triangles) at 1920x1080 and
the Cornell box (surface `path`, 36 triangles) at 1080x1080 through
`lr.render` with the intersector forced to the Pallas kernel, XLA's chunked
sweep and XLA's lockstep BVH.  Every strategy renders the same seeds: the
liver's warm wall time differs several-fold from seed to seed (the regen
loop runs until the slowest paths of the sample budget finish), so only
same-seed times compare.  The first call of each strategy compiles and is
reported apart.  Prints the card line and one JSON line per render; needs
a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

STRATEGIES = ("pallas", "brute", "bvh")
SEEDS = (7, 6)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    dev = jax.devices()[0]
    assert dev.platform == "gpu", dev
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)

    import liverrenderer as lr
    from liverrenderer.compile_cache import enable_compile_cache
    from liverrenderer.scene.synthetic import liver_standin
    enable_compile_cache()

    cb = lr.cornell_box()
    cb["sensor"]["film"].update(width=1080, height=1080,
                                rfilter={"type": "box"})
    scenes = {
        "liver_1920x1080": lr.load_dict(liver_standin(seed=0, spp=a.spp)),
        "cornell_1080x1080": lr.load_dict(cb),
    }
    rows = []
    for name, base in scenes.items():
        for strat in STRATEGIES:
            sc = base.replace(intersector=strat)
            for k, seed in enumerate((SEEDS[0],) + SEEDS):
                t0 = time.perf_counter()
                img = np.asarray(lr.render(sc, spp=a.spp, seed=seed))
                dt = time.perf_counter() - t0
                row = {"scene": name, "tris": sc.n_tris, "strategy": strat,
                       "spp": a.spp, "seed": seed, "first_call": k == 0,
                       "wall_s": dt,
                       "paths_per_s": sc.film_w * sc.film_h * a.spp / dt,
                       "mean": float(img.mean()),
                       "finite": bool(np.isfinite(img).all()),
                       "card": card, "kind": dev.device_kind}
                rows.append(row)
                print(json.dumps(row), flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
