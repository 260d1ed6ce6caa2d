"""Probe the lockstep-BVH intersector on the device across mesh sizes
(each in a subprocess, so a device fault stays in one size)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def child(subdiv: int):
    import time

    import jax
    from liverrenderer.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    import liverrenderer as lr
    from liverrenderer.accel.intersect import ray_intersect_preliminary
    from liverrenderer.core.types import Ray
    from bench_stream import icosphere, make_rays

    v, f = icosphere(subdiv)
    rng = np.random.default_rng(0)
    o, d = make_rays(N := 1 << 17, rng)
    scene = lr.load_dict({
        "type": "scene",
        "integrator": {"type": "path"},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": lr.Transform().look_at([0, 0, 3], [0, 0, 0],
                                                      [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 8, "height": 8}},
        "mesh": {"type": "mesh", "vertices": v, "faces": f},
    }).replace(intersector="bvh")
    ray = Ray(o=jnp.asarray(o), d=jnp.asarray(d),
              maxt=jnp.full((N,), jnp.inf))

    @jax.jit
    def go(sc, r):
        return ray_intersect_preliminary(sc, r)

    out = go(scene, ray)
    t = np.asarray(out[0])
    t0 = time.perf_counter()
    out = go(scene, ray)
    hit = float((np.asarray(out[1]) >= 0).mean())
    dt = time.perf_counter() - t0
    print(json.dumps({"tris": int(len(f)), "rays_per_s": round(N / dt),
                      "ms": round(dt * 1e3, 2), "hit_rate": round(hit, 3)}))


def main():
    for subdiv in (4, 5, 6, 7):
        r = subprocess.run([sys.executable, __file__, str(subdiv)],
                           timeout=1800, capture_output=True, text=True,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        tail = r.stdout.strip().splitlines()[-1:] or ["(no output)"]
        if r.returncode == 0:
            print(f"subdiv {subdiv}: {tail[0]}")
        else:
            err = (r.stderr or r.stdout).strip().splitlines()[-1:]
            print(f"subdiv {subdiv}: FAULT rc={r.returncode} {err}")


if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(int(sys.argv[1]))
    else:
        main()
