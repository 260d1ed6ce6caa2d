"""Smoke test of the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases (a)-(f)
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

Phases, each of which fails the run:
  (a) the device is a GPU (no CPU fallback); prints the card line.
  (b) the Pallas intersection kernel at real widths (64k and 1M rays x the
      5,120-triangle liver stand-in) against XLA's chunked sweep, and the
      sweep against the lockstep BVH, with timings.
  (c) `lr.render` of the liver stand-in at 1920x1080@16spp (regen wavefront).
  (d) `lr.render_grad` (replay adjoint) of the medium at 428x240@16spp.
  (e) the plain reference: the stand-in at 64x36@8spp rendered and
      differentiated on the GPU and, in a second process held to the host
      CPU (on cores this process does not use), at the same seed.
  (f) the Cornell box through the surface `path` regen at 256x256@64spp.

The last line of standard output is one JSON object with the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# phase (e): the GPU and the CPU walk the same counter-RNG paths, so only
# float rounding separates them (transcendentals, summation order, scatter
# atomics, the kernel's Baldwin-Weber against the sweep's Moeller-Trumbore).
# A path that flips a decision on that rounding still moves the result: on
# an H100 the image differed by 5.2e-5 (one pixel by 0.09) and the gradient
# by 3.8e-4.  A lower-precision path moves it further: camera rays rounded
# to TF32 moved the CPU's own image by 4.5e-3 and its gradient by 2.9e-3
# (PERF.md).  The limits sit between the two; the seed-to-seed difference
# is about 0.2.
REF_RES = (64, 36)
REF_SPP = 8
REF_IMG_TOL = 5e-4          # image relative L1
REF_GRAD_TOL = 1e-3         # gradient relative L2
# kernel vs XLA sweep: share of rays whose hit triangle must agree (shared
# edges may go either way) and relative t error on agreeing hits (float32)
PRIM_AGREE_MIN = 0.9999
T_REL_TOL = 1e-5
# sharded vs single-card: the same paths on the same kind of card; only the
# order of float32 sums differs (film atomics, the per-card gradient
# reductions, NCCL's psum over the cards)
SHARD_IMG_TOL = 1e-5
SHARD_GRAD_TOL = 1e-4
# ray counts of phase (b); the BVH is timed at the first
PROBE_RAYS = (1 << 16, 1 << 20)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(devices) -> None:
    """Phase (a): the run needs a GPU; a CPU is refused, never a fallback."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform: {kind})")


def _timed(fn, reps=1):
    """(first-call seconds, median warm seconds, last result).  One warm
    call by default: a 1080p render's wall time varies severalfold from
    call to call on the card (PERF.md), so more calls buy little here."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return first, sorted(warm)[len(warm) // 2], out


def _log(msg):
    print(msg, flush=True)


def _standin(width, height, spp):
    import liverrenderer as lr
    from liverrenderer.scene.synthetic import liver_standin
    return lr.load_dict(liver_standin(seed=0, width=width, height=height,
                                      spp=spp))


def _probe_rays(n, seed):
    """Half the rays start outside the liver and aim into its bounding box,
    half start inside it (the medium-scattering case) in random directions."""
    import numpy as np

    from liverrenderer.core.types import Ray
    from liverrenderer.scene.synthetic import _HALF_EXTENT
    rng = np.random.default_rng(seed)
    h = n // 2
    out = rng.normal(size=(h, 3))
    out = 0.3 * out / np.linalg.norm(out, axis=1, keepdims=True)
    aim = rng.uniform(-1, 1, (h, 3)) * _HALF_EXTENT
    inside = rng.uniform(-0.5, 0.5, (n - h, 3)) * _HALF_EXTENT
    o = np.concatenate([out, inside])
    d = np.concatenate([aim - out, rng.normal(size=(n - h, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    import jax.numpy as jnp
    return Ray(o=jnp.asarray(o, jnp.float32), d=jnp.asarray(d, jnp.float32),
               maxt=jnp.full((n,), jnp.inf, jnp.float32))


def phase_b(results):
    """Kernel vs XLA sweep at 64k and 1M rays; sweep vs BVH at 64k."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import liverrenderer as lr
    from liverrenderer.accel import intersect as ix
    from liverrenderer.scene.synthetic import liver_mesh
    v, f, n = liver_mesh(0)
    scene = lr.load_dict({
        "type": "scene",
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 8, "height": 8}},
        "liver": {"type": "mesh", "vertices": v, "faces": f, "normals": n}})
    assert scene.n_tris == 5120, scene.n_tris

    def strategy(fn):
        return jax.jit(lambda sc, ray: fn(
            sc, ray, jnp.full(ray.maxt.shape, jnp.inf), False)[:2])

    kern, brute, bvh = (strategy(ix._pallas_tris), strategy(ix._brute_tris),
                        strategy(ix._bvh_tris))
    for n_rays in PROBE_RAYS:
        ray = _probe_rays(n_rays, seed=n_rays)
        _, tk_s, (tk, pk) = _timed(lambda: kern(scene, ray), reps=5)
        _, tb_s, (tb, pb) = _timed(lambda: brute(scene, ray), reps=5)
        tk, pk, tb, pb = map(np.asarray, (tk, pk, tb, pb))
        hit = (pb >= 0) & (pk >= 0)
        with np.errstate(invalid="ignore"):          # inf - inf on misses
            rel = np.abs(tk - tb) / np.maximum(np.abs(tb), 1e-30)
        # a different triangle at the same distance is a shared-edge tie
        agree = (pk == pb) | (hit & (rel <= T_REL_TOL))
        frac = float(agree.mean())
        same = hit & (pk == pb)
        t_bad = float((rel[same] > T_REL_TOL).mean()) if same.any() else 0.0
        row = {"rays": n_rays, "tris": scene.n_tris,
               "kernel_ms": tk_s * 1e3, "xla_brute_ms": tb_s * 1e3,
               "hit_share": float((pb >= 0).mean()),
               "prim_agree": frac, "t_rel_max": float(rel[same].max()),
               "t_rel_over_tol_share": t_bad}
        if n_rays == PROBE_RAYS[0]:
            _, tv_s, (tv, pv) = _timed(lambda: bvh(scene, ray), reps=5)
            row["xla_bvh_ms"] = tv_s * 1e3
            with np.errstate(invalid="ignore"):
                row["bvh_prim_agree"] = float(
                    ((np.asarray(pv) == pb)
                     | (np.abs(np.asarray(tv) - tb)
                        <= T_REL_TOL * np.abs(tb))).mean())
        _log(f"(b) {json.dumps(row)}")
        assert frac >= PRIM_AGREE_MIN, f"kernel prim agreement {frac}"
        assert t_bad <= 1.0 - PRIM_AGREE_MIN, f"kernel t mismatch {t_bad}"
        if "bvh_prim_agree" in row:
            assert row["bvh_prim_agree"] >= PRIM_AGREE_MIN, row
        results.setdefault("b", []).append(row)


def phase_c(results):
    import numpy as np

    import liverrenderer as lr
    from liverrenderer.integrators.regen import regen_applicable
    sc = _standin(1920, 1080, 16)
    assert regen_applicable(sc, "primal")
    first, warm, img = _timed(lambda: lr.render(sc, spp=16, seed=0))
    img = np.asarray(img)
    paths = sc.film_w * sc.film_h * 16
    row = {"res": f"{sc.film_w}x{sc.film_h}@16spp", "tris": sc.n_tris,
           "first_call_s": first, "compile_s_est": first - warm,
           "warm_s": warm, "paths_per_s": paths / warm,
           "mean": float(img.mean())}
    _log(f"(c) {json.dumps(row)}")
    assert img.shape == (sc.film_h, sc.film_w, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    results["c"] = row


def _mean_loss(img):
    import jax.numpy as jnp
    return jnp.mean(img)


def phase_d(results):
    import numpy as np

    import liverrenderer as lr
    sc = _standin(428, 240, 16)
    params = {"media.params": sc.media.params}
    first, warm, out = _timed(
        lambda: lr.render_grad(sc, params, _mean_loss, spp=16, seed=0))
    g = np.asarray(out[1]["media.params"])
    row = {"res": f"{sc.film_w}x{sc.film_h}@16spp", "first_call_s": first,
           "compile_s_est": first - warm, "warm_s": warm,
           "paths_per_s": sc.film_w * sc.film_h * 16 / warm,
           "grad_norm": float(np.linalg.norm(g))}
    _log(f"(d) {json.dumps(row)}")
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    results["d"] = row


def _render_and_grad(seed):
    import numpy as np

    import liverrenderer as lr
    sc = _standin(*REF_RES, REF_SPP)
    img = np.asarray(lr.render(sc, spp=REF_SPP, seed=seed))
    _, g, _ = lr.render_grad(sc, {"media.params": sc.media.params},
                             _mean_loss, spp=REF_SPP, seed=seed)
    return img, np.asarray(g["media.params"]).ravel()


def _rel_l1(a, b):
    import numpy as np
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _rel_l2(a, b):
    import numpy as np
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def cpu_reference() -> None:
    """Phase (e)'s host half, in a process of its own that sees no GPU:
    the stand-in rendered and differentiated at seeds 0 and 1.  Prints one
    JSON line {seed: {"img": [...], "grad": [...]}}."""
    from liverrenderer.compile_cache import enable_compile_cache
    enable_compile_cache()
    out = {}
    for seed in (0, 1):
        img, g = _render_and_grad(seed)
        out[seed] = {"img": img.tolist(), "grad": g.tolist()}
    print(json.dumps(out))


def split_cores():
    """(this process's cores, the CPU reference's cores): disjoint halves,
    so the reference does not take cores from the GPU phases' host work.
    None for both where there are too few cores to split."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return None, None
    half = len(cores) // 2
    return cores[:half], cores[half:]


class CpuReference:
    """The CPU reference process, started before the GPU phases and read in
    phase (e).  Output goes to temporary files, so a full pipe never stalls
    it."""

    def __init__(self, cores):
        here = os.path.dirname(os.path.abspath(__file__))
        pin = f"os.sched_setaffinity(0, {cores!r}); " if cores else ""
        code = f"import os; {pin}import chip_smoke; chip_smoke.cpu_reference()"
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        self.out = tempfile.TemporaryFile("w+")
        self.err = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen([sys.executable, "-c", code], cwd=here,
                                     env=env, stdout=self.out,
                                     stderr=self.err, text=True)

    def result(self, timeout):
        rc = self.proc.wait(timeout=timeout)
        self.out.seek(0)
        self.err.seek(0)
        if rc != 0:
            raise RuntimeError(f"CPU reference failed (rc {rc}):\n"
                               + self.err.read()[-3000:])
        import numpy as np
        res = json.loads(self.out.read().strip().splitlines()[-1])
        return [(np.asarray(res[s]["img"], np.float32),
                 np.asarray(res[s]["grad"], np.float32)) for s in ("0", "1")]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def phase_e(results):
    """GPU vs the host CPU at one seed.  Matmul precision is "highest"
    (package default), so the GPU takes no TF32 route."""
    import jax
    import numpy as np
    assert jax.config.jax_default_matmul_precision == "highest"
    t0 = time.perf_counter()
    img_g, g_g = _render_and_grad(0)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (img_c0, g_c0), (img_c1, g_c1) = results["cpu_reference"].result(
        timeout=900)
    wait_s = time.perf_counter() - t0
    seed_img = _rel_l1(img_c1, img_c0)
    seed_grad = _rel_l2(g_c1, g_c0)
    dev_img = _rel_l1(img_g, img_c0)
    dev_grad = _rel_l2(g_g, g_c0)
    cos = float(g_g @ g_c0 / max(np.linalg.norm(g_g)
                                 * np.linalg.norm(g_c0), 1e-30))
    row = {"res": f"{REF_RES[0]}x{REF_RES[1]}@{REF_SPP}spp",
           "gpu_first_calls_s": gpu_s, "cpu_wait_s": wait_s,
           "img_rel_l1_gpu_cpu": dev_img, "img_tol": REF_IMG_TOL,
           "img_rel_l1_cpu_seed0_seed1": seed_img,
           "img_max_abs_gpu_cpu": float(np.abs(img_g - img_c0).max()),
           "grad_rel_l2_gpu_cpu": dev_grad, "grad_tol": REF_GRAD_TOL,
           "grad_rel_l2_cpu_seed0_seed1": seed_grad,
           "grad_cos_gpu_cpu": cos,
           "grad_norm_ratio_gpu_cpu": float(np.linalg.norm(g_g)
                                            / np.linalg.norm(g_c0))}
    _log(f"(e) {json.dumps(row)}")
    assert img_g.shape == img_c0.shape and g_g.shape == g_c0.shape
    assert np.isfinite(img_g).all() and np.isfinite(g_g).all()
    # the limits are meaningful only well inside Monte Carlo noise
    assert REF_IMG_TOL < 0.1 * seed_img and REF_GRAD_TOL < 0.1 * seed_grad
    # the relative L2 bound holds the gradient's norm ratio within
    # 1 +- tol and its cosine above 1 - tol^2 / 2
    assert dev_img <= REF_IMG_TOL, row
    assert dev_grad <= REF_GRAD_TOL, row
    results["e"] = row


def phase_f(results):
    import numpy as np

    import liverrenderer as lr
    from liverrenderer.integrators.regen import regen_applicable
    d = lr.cornell_box()
    d["sensor"]["film"].update(width=256, height=256, rfilter={"type": "box"})
    sc = lr.load_dict(d)
    assert sc.integrator == "path" and regen_applicable(sc, "primal")
    first, warm, img = _timed(lambda: lr.render(sc, spp=64, seed=0))
    img = np.asarray(img)
    row = {"res": "256x256@64spp", "tris": sc.n_tris, "first_call_s": first,
           "warm_s": warm, "paths_per_s": 256 * 256 * 64 / warm,
           "mean": float(img.mean())}
    _log(f"(f) {json.dumps(row)}")
    assert np.isfinite(img).all() and img.mean() > 0
    results["f"] = row


def four_cards(results, width=256, height=144, spp=64):
    """Sharded regen primal and replay adjoint on 4 cards against the
    one-card fast paths."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import numpy as np

    import liverrenderer as lr
    from liverrenderer import film as film_mod
    from liverrenderer.integrators import regen
    from liverrenderer.parallel.mesh import (make_mesh,
                                             render_grad_replay_sharded,
                                             render_regen_sharded)
    assert len(jax.devices()) >= 4, jax.devices()
    sc = _standin(width, height, spp)
    mesh = make_mesh(4)
    params = {"media.params": sc.media.params}
    one = (lambda: regen.render_regen_host(sc, 0, spp),
           lambda: lr.render_grad(sc, params, _mean_loss, spp=spp, seed=0))
    four = (lambda: render_regen_sharded(sc, mesh, spp=spp, seed=0),
            lambda: render_grad_replay_sharded(sc, mesh, params, _mean_loss,
                                               spp=spp, seed=0))

    def first_calls(fns):
        t0 = time.perf_counter()
        for fn in fns:
            jax.block_until_ready(fn())
        return time.perf_counter() - t0

    # first calls (compilation) of both sides at once: XLA compiles outside
    # the GIL; the timed calls below run one at a time
    with ThreadPoolExecutor(2) as ex:
        first1, first4 = (f.result() for f in
                          [ex.submit(first_calls, fns) for fns in (one, four)])
    _, t1, ref = _timed(one[0], reps=3)
    _, t4, got = _timed(four[0], reps=3)
    _, g1_s, o1 = _timed(one[1], reps=3)
    _, g4_s, o4 = _timed(four[1], reps=3)
    img1 = np.asarray(film_mod.develop(ref))
    img4 = np.asarray(film_mod.develop(got))
    g1 = np.asarray(o1[1]["media.params"]).ravel()
    g4 = np.asarray(o4[1]["media.params"]).ravel()
    row = {"res": f"{sc.film_w}x{sc.film_h}@{spp}spp", "devices": 4,
           "first_calls_1card_s": first1, "first_calls_4cards_s": first4,
           "regen_t1_s": t1, "regen_t4_s": t4,
           "regen_eff_t1_over_4t4": t1 / (4 * t4),
           "img_rel_l1": _rel_l1(img4, img1),
           "img_max_abs": float(np.abs(img4 - img1).max()),
           "grad_t1_s": g1_s, "grad_t4_s": g4_s,
           "grad_eff_t1_over_4t4": g1_s / (4 * g4_s),
           "grad_rel_l2": _rel_l2(g4, g1),
           "img_tol": SHARD_IMG_TOL, "grad_tol": SHARD_GRAD_TOL}
    _log(f"(4) {json.dumps(row)}")
    assert np.isfinite(img4).all() and np.isfinite(g4).all()
    assert row["img_rel_l1"] <= SHARD_IMG_TOL, row
    assert row["grad_rel_l2"] <= SHARD_GRAD_TOL, row
    results["four_cards"] = row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)

    own_cores, ref_cores = (None, None) if args.four_cards else split_cores()
    if own_cores:
        # before JAX starts its thread pools, which inherit the mask
        os.sched_setaffinity(0, own_cores)
    import jax
    require_gpu(jax.devices())
    import liverrenderer  # noqa: F401  (fails outside a checkout)
    from liverrenderer.compile_cache import enable_compile_cache
    cache = enable_compile_cache()

    dev = jax.devices()[0]
    _log(f"card: {card_line()}")
    _log(f"(a) platform={dev.platform} kind={dev.device_kind} "
         f"count={len(jax.devices())} jax={jax.__version__} cache={cache} "
         f"cores={own_cores or 'all'} reference_cores={ref_cores or 'all'}")
    results = {}
    if args.four_cards:
        phases = [four_cards]
    else:
        results["cpu_reference"] = CpuReference(ref_cores)
        phases = [phase_b, phase_c, phase_d, phase_e, phase_f]
    try:
        for phase in phases:
            t0 = time.perf_counter()
            phase(results)
            _log(f"phase {phase.__name__} done in "
                 f"{time.perf_counter() - t0:.1f} s")
    finally:
        if "cpu_reference" in results:
            results["cpu_reference"].stop()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
