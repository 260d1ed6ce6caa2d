"""Progressive/interactive renderer (realtime viewer analog).

Capability analog of the reference's GLFW realtime viewer
(src/mitsuba/realtime.hpp:341-630 runRealtimeRenderer): per-frame renders
with EMA accumulation or denoised display, camera dollying, and a per-stage
timing report.  This environment has no display or OptiX, so frames are
written to disk (or yielded to a callback) instead of blitted to a GL
texture; the accumulation/denoise/timing structure mirrors the reference
(--imode ema|denoise).
"""
from __future__ import annotations

import time

import numpy as np


def run_viewer(scene, n_frames: int = 16, spp: int = 1, mode: str = "ema",
               ema_alpha: float = 0.1, out_pattern: str | None = None,
               camera_orbit_deg: float = 0.0, frame_callback=None):
    """Render `n_frames` progressive frames.

    mode='ema': exponential moving average accumulation (realtime.hpp:379,
    506-516); mode='denoise': per-frame joint-bilateral denoise
    (OptixDenoiser stand-in); mode='accum': plain running average.
    Returns the final frame (h, w, 3).
    """
    import jax.numpy as jnp

    import liverrenderer as lr
    from .log import log, scoped_phase, phase_report
    from .scene.transform import Transform

    acc = None
    aovs = None
    if mode == "denoise":
        with scoped_phase("aovs"):
            aovs = lr.render_aovs(scene, ("albedo", "sh_normal",
                                          "emission"))

    for frame in range(n_frames):
        sc = scene
        if camera_orbit_deg:
            angle = camera_orbit_deg * frame / max(n_frames - 1, 1)
            rot = Transform().rotate([0, 1, 0], angle).matrix
            to_w = jnp.asarray(rot, jnp.float32) @ scene.sensor.to_world
            sc = scene.replace(sensor=scene.sensor.replace(to_world=to_w))
            # camera moved: restart accumulation (parameters_changed)
            acc = None

        with scoped_phase("render"):
            img = np.asarray(lr.render(sc, spp=spp, seed=frame))

        with scoped_phase("accumulate"):
            if mode == "ema":
                acc = img if acc is None else \
                    ema_alpha * img + (1.0 - ema_alpha) * acc
            elif mode == "accum":
                acc = img if acc is None else \
                    (acc * frame + img) / (frame + 1)
            else:  # denoise
                from .denoise import atrous_denoise
                acc = np.asarray(atrous_denoise(
                    img, np.asarray(aovs["albedo"]),
                    np.asarray(aovs["sh_normal"]),
                    emission=np.asarray(aovs["emission"])))

        if out_pattern:
            with scoped_phase("write"):
                lr.write_image(out_pattern.format(frame=frame), acc)
        if frame_callback:
            frame_callback(frame, acc)

    log(phase_report())
    return acc


def denoise(img: np.ndarray, albedo: np.ndarray | None = None,
            normal: np.ndarray | None = None, radius: int = 3,
            sigma_s: float = 2.0, sigma_r: float = 0.2,
            sigma_n: float = 0.3) -> np.ndarray:
    """AOV-guided joint-bilateral denoiser.

    Stand-in for the reference's OptixDenoiser wrapper (optixdenoiser.cpp,
    Denoise.py): cross-bilateral weights from color distance + albedo +
    normal feature buffers.  Pure numpy; adequate for the viewer and the
    Denoise.py-style batch tool."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    acc = np.zeros_like(img)
    wsum = np.zeros((h, w, 1), np.float32)
    lum = img.mean(-1, keepdims=True)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            sy = slice(max(dy, 0), h + min(dy, 0))
            sx = slice(max(dx, 0), w + min(dx, 0))
            ty = slice(max(-dy, 0), h + min(-dy, 0))
            tx = slice(max(-dx, 0), w + min(-dx, 0))
            wgt = np.exp(-(dx * dx + dy * dy) / (2 * sigma_s ** 2))
            d_lum = lum[ty, tx] - lum[sy, sx]
            wgt = wgt * np.exp(-(d_lum ** 2) / (2 * sigma_r ** 2))
            if albedo is not None:
                d_a = ((albedo[ty, tx] - albedo[sy, sx]) ** 2).sum(
                    -1, keepdims=True)
                wgt = wgt * np.exp(-d_a / (2 * sigma_r ** 2))
            if normal is not None:
                d_n = ((normal[ty, tx] - normal[sy, sx]) ** 2).sum(
                    -1, keepdims=True)
                wgt = wgt * np.exp(-d_n / (2 * sigma_n ** 2))
            acc[ty, tx] += img[sy, sx] * wgt
            wsum[ty, tx] += wgt
    return acc / np.maximum(wsum, 1e-8)


def main(argv=None):
    """`python -m liverrenderer.viewer scene.xml` — progressive render
    with frames written to ./frames_NNN.png (Denoise.py-style batch use:
    --mode denoise --frames 1)."""
    import argparse

    import liverrenderer as lr

    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--mode", choices=("ema", "accum", "denoise"),
                    default="ema")
    ap.add_argument("--orbit", type=float, default=0.0)
    ap.add_argument("--out", default="frame_{frame:03d}.png")
    ap.add_argument("-D", "--define", action="append", default=[])
    a = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in a.define)
    scene = lr.load_file(a.scene, **overrides)
    run_viewer(scene, a.frames, a.spp, a.mode, out_pattern=a.out,
               camera_orbit_deg=a.orbit)


if __name__ == "__main__":
    main()
