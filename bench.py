"""Benchmark: paths/s on one GPU for the seeded liver stand-in.

The stand-in (scene/synthetic.py) follows the reference's own liver render
configuration: biovolpath, 12 bounces, 1920x1080 at 256 spp.  Reported:
primal paths/s at 428x240@64spp (same aspect as 1080p), the forward+backward
rate of the replay adjoint (gradients w.r.t. the liver medium coefficients),
the Cornell box through the surface-path regen wavefront, the one-device
sharded regen path, and the full 1080p primal and fwd+bwd.

Needs a GPU: with none it exits non-zero and prints no result.  Prints the
card line, then ONE JSON line naming the device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

W, H, SPP = 428, 240, 64
REPS = 5


def _wall(fn, reps):
    """Best and mean wall seconds of `reps` warm calls (first call
    compiles and is not counted)."""
    jax.block_until_ready(fn(0))
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i + 1))
        ts.append(time.perf_counter() - t0)
    return min(ts), sum(ts) / len(ts)


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU found (JAX platform: {dev.platform})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)

    import liverrenderer as lr
    from liverrenderer.compile_cache import enable_compile_cache
    from liverrenderer.integrators.regen import regen_applicable
    from liverrenderer.parallel.mesh import make_mesh, render_regen_sharded
    from liverrenderer.scene.synthetic import liver_standin
    enable_compile_cache()

    def standin(w, h, spp):
        return lr.load_dict(liver_standin(seed=0, width=w, height=h,
                                          spp=spp))

    def loss_fn(im):
        return jnp.mean(im)

    scene = standin(W, H, SPP)
    n_paths = W * H * SPP
    dt_primal, dt_primal_avg = _wall(
        lambda s: lr.render(scene, spp=SPP, seed=s), REPS)

    spp_b = 16
    params = {"media.params": scene.media.params}
    grads = lr.render_grad(scene, params, loss_fn, spp=spp_b, seed=0)[1]
    dt_fwdbwd, _ = _wall(lambda s: lr.render_grad(
        scene, params, loss_fn, spp=spp_b, seed=s)[1], REPS)

    extra = {
        "config": f"{W}x{H}@{SPP}spp biovolpath d12 liver stand-in",
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()), "card": card,
        "primal_s": dt_primal, "primal_s_mean": dt_primal_avg,
        "fwdbwd_paths_per_s": W * H * spp_b / dt_fwdbwd,
        "fwdbwd_s": dt_fwdbwd,
        "fwdbwd_over_primal_cost": dt_fwdbwd / dt_primal * (SPP / spp_b),
        "grad_finite": bool(np.isfinite(
            np.asarray(grads["media.params"])).all()),
    }

    # Cornell box 256^2 @ 64 spp through the surface-path regen wavefront
    d = lr.cornell_box()
    d["integrator"] = {"type": "path", "max_depth": 8}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": 256, "height": 256,
                           "rfilter": {"type": "box"}}
    cb = lr.load_dict(d)
    assert regen_applicable(cb, "primal")
    dt_cb, _ = _wall(lambda s: lr.render(cb, spp=64, seed=s), REPS)
    extra["cornell_256_64spp_path_regen"] = {
        "wall_s": dt_cb, "paths_per_s": 256 * 256 * 64 / dt_cb}

    # the sharded regen program on a one-device mesh: the single-device
    # tile program plus a trivial psum
    mesh1 = make_mesh(1)
    dt_mesh, _ = _wall(lambda s: render_regen_sharded(
        scene, mesh1, spp=SPP, seed=s), REPS)
    extra["mesh1_regen_sharded"] = {
        "wall_s": dt_mesh, "paths_per_s": n_paths / dt_mesh,
        "overhead_vs_single": dt_mesh / dt_primal - 1.0}

    # the reference configuration: 1920x1080 @ 256 spp primal, and fwd+bwd
    # at 1080p@16spp through the tiled replay adjoint, with a same-process
    # 16-spp primal for the cost ratio
    sc_hd = standin(1920, 1080, 256)
    dt_hd, _ = _wall(lambda s: lr.render(sc_hd, spp=256, seed=s), 2)
    extra["hd_1080p_256spp"] = {"wall_s": dt_hd,
                                "paths_per_s": 1920 * 1080 * 256 / dt_hd}
    hd_params = {"media.params": sc_hd.media.params}
    dt_hd16, _ = _wall(lambda s: lr.render(sc_hd, spp=16, seed=s), 2)
    dt_hdg, _ = _wall(lambda s: lr.render_grad(
        sc_hd, hd_params, loss_fn, spp=16, seed=s)[1], 2)
    extra["hd_1080p_fwdbwd_16spp"] = {
        "wall_s": dt_hdg, "fwdbwd_paths_per_s": 1920 * 1080 * 16 / dt_hdg,
        "primal_16spp_wall_s": dt_hd16,
        "fwdbwd_over_primal_cost": dt_hdg / dt_hd16}
    print(json.dumps({
        "metric": "liver stand-in paths/s on one GPU (primal; fwd+bwd in "
                  "extra)",
        "value": n_paths / dt_primal, "unit": "paths/s", "extra": extra}))


if __name__ == "__main__":
    main()
