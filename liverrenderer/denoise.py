"""Edge-avoiding à-trous wavelet denoiser (SVGF-style single frame).

The reference wraps NVIDIA's OptiX AI denoiser (src/render/optixdenoiser.cpp,
Denoise.py) — a hardware-vendor black box with albedo/normal guide buffers.
This redesign uses the same guide buffers to drive a
multi-iteration edge-avoiding à-trous wavelet filter (Dammertz et al. 2010,
plus the variance-modulated luminance weight of SVGF, Schied et al. 2017):

  * 5x5 B3-spline kernel dilated 2^i per iteration — receptive field grows
    exponentially while work stays O(25 N) per pass;
  * edge-stopping weights: luminance difference normalized by a local
    variance estimate (noise-aware: smooth where the signal is noisy, stop
    where a real edge exceeds the noise), normal dot-product raised to a
    power, and albedo distance;
  * everything is jnp stacked shifts + elementwise math — XLA fuses each
    iteration into a handful of kernels, on any JAX backend.

Exceeds the old single-pass joint-bilateral stand-in (viewer.denoise) in
both receptive field and noise-awareness; that one remains for tiny
previews.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

# B3 spline taps
_B3 = jnp.asarray([1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16])


def _shift2(x: Array, dy: int, dx: int) -> Array:
    """Shift with edge clamp (no wrap-around ghosting)."""
    h, w = x.shape[0], x.shape[1]
    ys = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
    return x[ys][:, xs]


def _luminance(img: Array) -> Array:
    return (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
            + 0.0722 * img[..., 2])


def _local_variance(lum: Array) -> Array:
    """3x3 local variance of luminance — the noise estimate when no
    per-pixel sample-moment buffer is available."""
    s1 = jnp.zeros_like(lum)
    s2 = jnp.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = _shift2(lum, dy, dx)
            s1 = s1 + v
            s2 = s2 + v * v
    mean = s1 / 9.0
    return jnp.maximum(s2 / 9.0 - mean * mean, 0.0)


def atrous_denoise(img, albedo=None, normal=None, variance=None,
                   emission=None, iterations: int = 5, sigma_l: float = 4.0,
                   sigma_a: float = 0.15, sigma_n: float = 128.0):
    """Denoise an (h, w, 3) radiance image guided by AOV buffers.

    variance: optional (h, w) per-pixel luminance variance of the
    estimator (from render_moments); estimated locally when absent.
    emission: optional (h, w, 3) direct-emission AOV — blocks filtering
    across emitter silhouettes (a light edge looks exactly like a
    firefly to the color+variance weights: bright pixel, huge sample
    variance on the mixed boundary pixels; only a semantic guide can
    tell them apart).
    Returns the filtered (h, w, 3) image.
    """
    img = jnp.asarray(img, jnp.float32)
    albedo = None if albedo is None else jnp.asarray(albedo, jnp.float32)
    normal = None if normal is None else jnp.asarray(normal, jnp.float32)
    emission = None if emission is None \
        else _luminance(jnp.asarray(emission, jnp.float32))

    # filter demodulated irradiance (SVGF): albedo texture detail is
    # re-applied afterwards, so it never blurs and the filtered signal is
    # piecewise-smooth
    if albedo is not None:
        demod = jnp.maximum(albedo, 0.05)
        work = img / demod
    else:
        demod = None
        work = img

    lum0 = _luminance(work)
    if variance is None:
        var = _local_variance(lum0)
    else:
        var = jnp.asarray(variance, jnp.float32)
        if demod is not None:
            # variance was measured on the modulated radiance; rescale to
            # the demodulated space the filter operates in
            var = var / jnp.maximum(_luminance(demod) ** 2, 1e-4)

    taps = [(dy - 2, dx - 2, float(_B3[dy] * _B3[dx]))
            for dy in range(5) for dx in range(5)]

    out = work
    for it in range(iterations):
        step = 1 << it
        lum = _luminance(out)

        acc = jnp.zeros_like(out)
        acc_v = jnp.zeros_like(lum)
        wsum = jnp.zeros_like(lum)
        for dy, dx, k in taps:
            sy, sx = dy * step, dx * step
            c = _shift2(out, sy, sx)
            l_q = _shift2(lum, sy, sx)
            # SYMMETRIC variance normalization: taking the max of both
            # endpoints' variance lets an outlier (huge variance) both
            # accept its neighbors and be accepted by them, so firefly
            # energy redistributes instead of being destroyed (an
            # asymmetric center-only denominator systematically darkens)
            v_q = _shift2(var, sy, sx)
            denom_l = sigma_l * jnp.sqrt(
                jnp.maximum(jnp.maximum(var, v_q), 0.0)) + 1e-3
            w = k * jnp.exp(-jnp.abs(lum - l_q) / denom_l)
            if normal is not None:
                n_q = _shift2(normal, sy, sx)
                # environment pixels carry a ZERO normal (no hit): the
                # power weight must be neutral for bg<->bg pairs and
                # blocking for bg<->surface, not zero for everything —
                # 0^128 = 0 on every tap INCLUDING the center once made
                # whole env backgrounds divide 0-by-epsilon to black
                # (Liver-SingleMesh ds4: image mean 0.22 -> 0.05)
                has_n = jnp.sum(normal * normal, -1) > 1e-6
                has_q = jnp.sum(n_q * n_q, -1) > 1e-6
                ndot = jnp.clip(jnp.sum(normal * n_q, -1), 0.0, 1.0)
                w = w * jnp.where(has_n & has_q, ndot ** sigma_n,
                                  (has_n == has_q).astype(jnp.float32))
            if albedo is not None:
                a_q = _shift2(albedo, sy, sx)
                d_a = jnp.sum((albedo - a_q) ** 2, -1)
                w = w * jnp.exp(-d_a / jnp.maximum(sigma_a, 1e-6))
            if emission is not None:
                e_q = _shift2(emission, sy, sx)
                d_e = jnp.abs(emission - e_q) \
                    / (1.0 + jnp.maximum(emission, e_q))
                w = w * jnp.exp(-8.0 * d_e)
            acc = acc + c * w[..., None]
            acc_v = acc_v + v_q * w * w
            wsum = wsum + w
        out = acc / jnp.maximum(wsum, 1e-8)[..., None]
        var = acc_v / jnp.maximum(wsum * wsum, 1e-8)

    if demod is not None:
        out = out * demod
    return out


def estimator_variance(scene, spp: int, seed: int = 0):
    """Per-pixel luminance variance OF THE MEAN from the sample moments
    (render_moments).  This is the right noise estimate for the
    edge-stopping weights: a directly-visible emitter has huge spatial
    contrast but near-zero sample variance (every sample lands on it), so
    it is treated as a true edge; a noisy indirect pixel has huge sample
    variance and gets smoothed.  A local spatial variance proxy cannot
    tell these apart."""
    import liverrenderer as lr
    mean, m2 = lr.render_moments(scene, spp=spp, seed=seed)
    var_rgb = jnp.maximum(jnp.asarray(m2) - jnp.asarray(mean) ** 2, 0.0)
    var_lum = (0.2126 * var_rgb[..., 0] + 0.7152 * var_rgb[..., 1]
               + 0.0722 * var_rgb[..., 2])
    return jnp.asarray(mean), var_lum / max(spp, 1)


def denoise_render(scene, spp: int = 16, seed: int = 0, iterations: int = 5):
    """Render + AOVs + moment-based variance + denoise in one call
    (Denoise.py batch analog)."""
    import numpy as np

    import liverrenderer as lr
    img, var = estimator_variance(scene, spp, seed)
    aovs = lr.render_aovs(scene, ("albedo", "sh_normal", "emission"),
                          seed=seed)
    out = atrous_denoise(img, aovs["albedo"], aovs["sh_normal"],
                         variance=var, emission=aovs["emission"],
                         iterations=iterations)
    return np.asarray(out)


def main(argv=None):
    """Batch denoiser CLI (the reference Denoise.py workflow: load scene,
    render + AOVs, denoise, write EXR/PNG):

        python -m liverrenderer.denoise scene.xml -o out.exr --spp 32
    """
    import argparse

    ap = argparse.ArgumentParser(description="render + denoise a scene")
    ap.add_argument("scene")
    ap.add_argument("-o", "--output", default="denoised.exr")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import jax
    if a.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .compile_cache import enable_compile_cache
    enable_compile_cache()

    import liverrenderer as lr
    scene = lr.load_file(a.scene)
    out = denoise_render(scene, spp=a.spp, seed=a.seed,
                         iterations=a.iterations)
    lr.write_image(a.output, out)
    if a.output.lower().endswith(".exr"):
        lr.write_image(a.output[:-4] + ".png", out)
    print(f"wrote {a.output}")


if __name__ == "__main__":
    main()
