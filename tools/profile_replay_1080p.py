"""Profile the 1080p fwd+bwd replay schedule (VERDICT r4 #8).

In ONE process on the GPU: per-partition wall times of the tiled replay's
stored-forward and backward-walk executions on the seeded liver stand-in
at 1920x1080@16spp, against the same-process primal — so the fwd+bwd cost
ratio decomposes into (stored-forward overhead) + (walk cost) +
(scheduling overhead).

    python tools/profile_replay_1080p.py
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from liverrenderer.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import liverrenderer as lr  # noqa: E402
from liverrenderer.integrators import prb_replay as pr  # noqa: E402
from liverrenderer.integrators import regen as regen_mod  # noqa: E402
from liverrenderer.scene.synthetic import liver_standin  # noqa: E402

SPP = 16


def timed(fn, *args):
    r = fn(*args)
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
        else x, r)
    t0 = time.perf_counter()
    r = fn(*args)
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
        else x, r)
    return time.perf_counter() - t0, r


def main():
    sc = lr.load_dict(liver_standin(seed=0, spp=SPP))
    n_pix = sc.film_w * sc.film_h
    tile_pix = min(regen_mod.TILE_PIX, n_pix)
    n_tiles = (n_pix + tile_pix - 1) // tile_pix
    spp_chunk = pr._pool_spp_cap(sc, tile_pix)
    out = {"tiles": n_tiles, "tile_pix": tile_pix, "spp_chunk": spp_chunk}

    # primal, same process
    np.asarray(lr.render(sc, spp=SPP, seed=0))
    t0 = time.perf_counter()
    np.asarray(lr.render(sc, spp=SPP, seed=1))
    t_primal = time.perf_counter() - t0
    out["primal_s"] = round(t_primal, 3)

    # per-partition stored forward + walk
    sc_det = pr._detach(sc)
    params = {"media.params": sc.media.params}
    seed = jnp.uint32(1)
    t_fwd, (film, pool) = timed(
        pr._tile_fwd_jit, sc_det, seed, jnp.uint32(0), jnp.uint32(0),
        SPP, spp_chunk, tile_pix)
    out["tile_fwd_s"] = round(t_fwd, 3)
    g_rgb = jnp.zeros((n_pix, 3)).at[:].set(1.0 / (n_pix * 3))
    t_walk, _ = timed(
        pr._tile_walk_jit, sc, params, seed, g_rgb, pool,
        jnp.uint32(0), jnp.uint32(0), SPP, spp_chunk, tile_pix)
    out["tile_walk_s"] = round(t_walk, 3)
    est = n_tiles * (t_fwd + t_walk)
    out["est_fwdbwd_s"] = round(est, 3)
    out["est_ratio"] = round(est / t_primal, 3)

    # full render_grad, same process
    def loss_fn(im):
        return jnp.mean(im)
    loss, grads, _ = lr.render_grad(sc, params, loss_fn, spp=SPP, seed=0)
    np.asarray(grads["media.params"])
    t0 = time.perf_counter()
    loss, grads, _ = lr.render_grad(sc, params, loss_fn, spp=SPP, seed=1)
    np.asarray(grads["media.params"])
    t_full = time.perf_counter() - t0
    out["render_grad_s"] = round(t_full, 3)
    out["ratio"] = round(t_full / t_primal, 3)
    out["sched_overhead_s"] = round(t_full - est, 3)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
