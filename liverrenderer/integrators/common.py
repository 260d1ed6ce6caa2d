"""Render orchestration: wavefront construction, pass splitting, film splat.

Wavefront analog of reference SamplingIntegrator::render (integrator.cpp:151-397):
the wavefront is film_w x film_h x spp_per_pass lanes (integrator.cpp:275);
when the total sample budget exceeds `max_wavefront` it is split into passes
accumulated on the film (integrator.cpp:279-293).  The per-pass work is one
jit-compiled program: ray gen -> integrator loop -> filtered splat.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import film as film_mod
from ..core.rng import make_sampler
from ..scene.ir import Scene
from ..sensor.perspective import sample_ray
from . import path as path_mod
from . import volpath as volpath_mod

MAX_WAVEFRONT = 1 << 22   # lanes per pass (bounds device memory per pass)


def _integrator_sample(scene: Scene, sampler, ray, mode="primal"):
    name = scene.integrator
    if name in ("path", "direct", "prb", "prb_basic"):
        return path_mod.sample(scene, sampler, ray, mode=mode)
    if name == "volprim_rf_basic":
        from . import volprim as volprim_mod
        return volprim_mod.sample(scene, sampler, ray, mode=mode)
    if name == "volpathmis" and not volpath_mod._has_bio(scene) \
            and not scene.spectral:
        # true spectral MIS over the per-channel distance-sampling
        # strategies (volpathmis.cpp SpectralMis variant); bio media keep
        # their one-hot channel semantics in volpath.py.  Under the
        # SPECTRAL variant the RGB-channel MIS is subsumed by the
        # wavelength-packet tracking (channel = packet entry), so
        # spectral volpathmis scenes run the spectral volpath machinery.
        from . import volpathmis as volpathmis_mod
        return volpathmis_mod.sample(scene, sampler, ray, mode=mode)
    if name in ("volpath", "volpathmis", "biovolpath", "biovolpath06",
                "prbvolpath"):
        return volpath_mod.sample(scene, sampler, ray, mode=mode)
    if name == "stokes":
        # lr.render on a stokes scene yields S0 (= the unpolarized image);
        # render_stokes exposes the full Stokes AOVs (stokes.cpp)
        from .stokes import sample_stokes
        S, sampler = sample_stokes(scene, sampler, ray)
        return S[:, :, 0], jnp.ones(S.shape[0], bool), sampler
    raise ValueError(f"unknown integrator {name}")


def render_pass(scene: Scene, seed: int, spp_pass: int, sample_offset: int,
                mode: str = "primal"):
    """Render one pass: (h*w*spp_pass) lanes -> (h, w, 4) film accumulator."""
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    n = n_pix * spp_pass

    lane = jnp.arange(n, dtype=jnp.uint32)
    pix = lane // spp_pass
    samp = lane % spp_pass + sample_offset
    sampler = make_sampler(pix, samp, seed, kind=scene.sampler_kind,
                           spp=scene.spp)

    # film position: pixel corner + jitter (box) / + filter offset
    px = (pix % w).astype(jnp.float32)
    py = (pix // w).astype(jnp.float32)
    uf, sampler = sampler.next_2d()
    pos = jnp.stack([px, py], -1) + uf

    from ..scene.ir import SENSOR_IRRADIANCEMETER, SENSOR_THINLENS
    from ..sensor.perspective import ray_weight
    if scene.sensor.stype in (SENSOR_THINLENS, SENSOR_IRRADIANCEMETER):
        ua, sampler = sampler.next_2d()
    else:
        ua = None
    ray = sample_ray(scene, pos, ua)
    L, valid, sampler = _integrator_sample(scene, sampler, ray, mode=mode)
    L = jnp.where(jnp.isfinite(L), L, 0.0)  # NaN guard (vaescatter.cpp:469)
    rw = ray_weight(scene)
    if rw != 1.0:
        L = L * rw
    return film_mod.splat(w, h, scene.rfilter, pos, L)


@partial(jax.jit, static_argnames=("spp", "spp_pass", "mode"))
def _render_jit(scene: Scene, seed, spp: int, spp_pass: int,
                mode: str = "primal"):
    n_passes = (spp + spp_pass - 1) // spp_pass

    if n_passes == 1:
        acc = render_pass(scene, seed, spp_pass, 0, mode)
    else:
        def body(i, acc):
            return acc + render_pass(scene, seed, spp_pass,
                                     i * spp_pass, mode)
        acc = jax.lax.fori_loop(
            0, n_passes, body,
            jnp.zeros((scene.film_h, scene.film_w, 4), jnp.float32))
    return film_mod.develop(acc)


def render(scene: Scene, spp: int | None = None, seed: int = 0,
           mode: str = "primal", control=None):
    """Render the scene to an (h, w, 3) linear-RGB image (mi.render analog).

    control: optional regen.RenderControl — wall-clock timeout /
    cooperative cancel / progress, honored between the host scheduler's
    device executions (reference integrator.h:290-302 semantics).  Only
    regen-able configurations are cancellable; the fixed-wavefront
    fallback is a single device program."""
    spp = spp or scene.spp
    from .regen import regen_applicable, render_regen_host
    if regen_applicable(scene, mode):
        return film_mod.develop(render_regen_host(scene, seed, spp,
                                                  control=control))
    n_pix = scene.film_w * scene.film_h
    # VAE-SSS events carry heavy per-lane state (20 poly coeffs, frame
    # matrices, NN activations) whose trailing-dim tiling padding scales
    # with the wavefront — cap those passes well below MAX_WAVEFRONT.
    # NOTE: the cap bounds spp_pass only, so it binds when n_pix <= 2^17;
    # larger SSS films take the regen path above (64k-lane wavefront,
    # pixel-tiled) whenever the filter allows — this fixed-wavefront
    # fallback only sees big-film SSS under exotic filters/modes
    max_wf = (1 << 17) if scene.ssub.enabled else MAX_WAVEFRONT
    spp_pass = max(1, min(spp, max_wf // max(n_pix, 1)))
    while spp % spp_pass != 0:
        spp_pass -= 1
    return _render_jit(scene, seed, spp, spp_pass, mode)
