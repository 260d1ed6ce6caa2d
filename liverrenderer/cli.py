"""Command-line renderer: `python -m liverrenderer.cli scene.xml ...`.

Analog of the reference `mitsuba` CLI (src/mitsuba/mitsuba.cpp:148-447):
scene loading with -D parameter overrides, render, EXR/PNG output, render
timing written alongside (LiverRenderer.py time.txt convention), optional
AOV and gradient modes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="liverrenderer",
        description="differentiable renderer (mitsuba CLI analog)")
    ap.add_argument("scene", help="scene .xml file")
    ap.add_argument("-o", "--output", default=None,
                    help="output image (.exr/.png); default: scene dir")
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="key=value", help="override a scene $parameter")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--integrator", default=None,
                    help="override the scene's integrator")
    ap.add_argument("--aovs", default=None,
                    help="comma-separated AOV names instead of radiance")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a jax.profiler device trace (XLA ops "
                         "and kernels on the device) into DIR for "
                         "TensorBoard")
    ap.add_argument("--sensor-medium", dest="unused", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .compile_cache import enable_compile_cache
    enable_compile_cache()

    import numpy as np

    import liverrenderer as lr
    from .log import log

    overrides = {}
    for kv in args.define:
        k, _, v = kv.partition("=")
        overrides[k] = v
    if args.integrator:
        overrides["integrator"] = args.integrator

    t0 = time.time()
    scene = lr.load_file(args.scene, **overrides)
    log(f"loaded {args.scene} ({scene.n_tris} tris, "
        f"{scene.film_w}x{scene.film_h}, integrator={scene.integrator})")

    out = args.output
    if out is None:
        base = os.path.splitext(os.path.basename(args.scene))[0]
        out = os.path.join(os.path.dirname(os.path.abspath(args.scene)),
                           base + "_render.exr")

    t1 = time.time()
    trace_ctx = None
    if args.trace:
        from .log import device_trace
        trace_ctx = device_trace(args.trace)
        trace_ctx.__enter__()
    if args.aovs:
        aovs = lr.render_aovs(scene, tuple(args.aovs.split(",")),
                              seed=args.seed)
        for name, img in aovs.items():
            stem, ext = os.path.splitext(out)
            img = np.asarray(img)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, -1)
            lr.write_image(f"{stem}_{name}{ext}", img)
            log(f"wrote {stem}_{name}{ext}")
    else:
        img = np.asarray(lr.render(scene, spp=args.spp, seed=args.seed))
        lr.write_image(out, img)
        if out.lower().endswith(".exr"):
            lr.write_image(os.path.splitext(out)[0] + ".png", img)
        log(f"wrote {out}")
    if trace_ctx is not None:
        trace_ctx.__exit__(None, None, None)
    t2 = time.time()

    # LiverRenderer.py time.txt convention (:374-380)
    spp = args.spp or scene.spp
    with open(os.path.join(os.path.dirname(os.path.abspath(out)),
                           "time.txt"), "w") as f:
        f.write(f"Scene: {os.path.basename(args.scene)}\n")
        f.write(f"Resolution: {scene.film_w}x{scene.film_h}\n")
        f.write(f"SPP: {spp}\n")
        f.write(f"Load time: {t1 - t0:.4f} s\n")
        f.write(f"Render time: {(t2 - t1) / 60.0:.4f} min\n")
    log(json.dumps({"load_s": round(t1 - t0, 3),
                    "render_s": round(t2 - t1, 3),
                    "paths_per_s": round(
                        scene.film_w * scene.film_h * spp / max(t2 - t1,
                                                                1e-9))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
