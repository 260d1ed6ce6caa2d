"""Time the triangle intersectors on the GPU and tune the Pallas kernel.

    python tools/intersect_sweep.py [--rays N] [--out FILE]

1. Compiles the Pallas kernel at the liver stand-in's 5,120 triangles and
   compares it with XLA's chunked sweep (`intersect._brute_tris`).
2. Sweeps the kernel's ray block, triangle chunk, warps and pipeline stages.
3. Times the kernel, the XLA sweep and the lockstep BVH on displaced
   icospheres of 1,280 to 327,680 triangles, for the crossover points
   (`MAX_BRUTE_TRIS`, `MAX_KERNEL_TRIS`).

Prints one JSON line per measurement and the card line; needs a GPU.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _median_ms(fn, reps=10):
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * sorted(ts)[len(ts) // 2]


def _scene(subdiv):
    import liverrenderer as lr
    from liverrenderer.scene.geometry import compute_vertex_normals, icosphere
    from liverrenderer.scene.synthetic import _HALF_EXTENT
    m = icosphere(subdiv)
    v = (m.vertices * _HALF_EXTENT).astype(np.float32)
    return lr.load_dict({
        "type": "scene",
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 8, "height": 8}},
        "liver": {"type": "mesh", "vertices": v, "faces": m.faces,
                  "normals": compute_vertex_normals(v, m.faces)}})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 16)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = jax.devices()[0]
    assert dev.platform == "gpu", dev
    rows = []

    def emit(row):
        row.update(card=card, kind=dev.device_kind)
        rows.append(row)
        print(json.dumps(row), flush=True)

    from liverrenderer.compile_cache import enable_compile_cache
    enable_compile_cache()
    from chip_smoke import _probe_rays
    from liverrenderer.accel import intersect as ix
    from liverrenderer.accel import pallas_intersect as pk

    def strat(fn):
        return jax.jit(lambda sc, ray: fn(
            sc, ray, jnp.full(ray.maxt.shape, jnp.inf), False)[:2])

    kern, brute, bvh = strat(ix._pallas_tris), strat(ix._brute_tris), \
        strat(ix._bvh_tris)
    ray = _probe_rays(a.rays, seed=1)

    # 1. compile + check at 5,120 triangles
    sc = _scene(4)
    tk, pk_ = map(np.asarray, kern(sc, ray))
    tb, pb = map(np.asarray, brute(sc, ray))
    hit = (pk_ >= 0) & (pb >= 0)
    emit({"what": "check", "tris": sc.n_tris,
          "prim_agree": float((pk_ == pb).mean()),
          "hit_agree": float(((pk_ >= 0) == (pb >= 0)).mean()),
          "t_rel_max": float((np.abs(tk - tb) / np.abs(tb))[hit].max())})

    # 2. kernel configuration sweep at 5,120 triangles
    from liverrenderer.scene.synthetic import liver_mesh
    v, f, _ = liver_mesh(0)
    from liverrenderer.accel.bvh import build_bvh
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    perm = build_bvh(v0, v1, v2).perm
    n = a.rays
    for block, chunk, warps, stages in itertools.product(
            (64, 128, 256), (16, 32, 64), (2, 4, 8), (1, 2)):
        buf, boxes, _, center = pk.pack_tris(v0, v1, v2, perm, chunk=chunk)
        o = ray.o - jnp.asarray(center)[None]
        npad = -(-n // block) * block
        rays = jnp.concatenate([o.T, ray.d.T, jnp.full((1, n), jnp.inf),
                                jnp.zeros((1, n))], 0)
        rays = jnp.pad(rays, ((0, 0), (0, npad - n)))
        try:
            ms = _median_ms(lambda: pk._call_kernel(
                rays, jnp.asarray(buf), jnp.asarray(boxes), block=block,
                chunk=chunk, num_warps=warps, num_stages=stages))
            emit({"what": "config", "block": block, "chunk": chunk,
                  "num_warps": warps, "num_stages": stages, "ms": ms})
        except Exception as e:  # noqa: BLE001 — report and keep sweeping
            emit({"what": "config", "block": block, "chunk": chunk,
                  "num_warps": warps, "num_stages": stages,
                  "error": f"{type(e).__name__}: {str(e)[:300]}"})

    # 3. strategies across triangle counts
    for subdiv in (3, 4, 5, 6, 7):
        sc = _scene(subdiv)
        row = {"what": "strategy", "tris": sc.n_tris, "rays": n}
        for name, fn in (("kernel", kern), ("brute", brute), ("bvh", bvh)):
            try:
                row[name + "_ms"] = _median_ms(lambda: fn(sc, ray), reps=5)
            except Exception as e:  # noqa: BLE001
                row[name + "_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        emit(row)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
