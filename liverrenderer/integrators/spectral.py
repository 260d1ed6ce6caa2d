"""Spectral film rendering (the reference `specfilm` analog).

src/films/specfilm.cpp accumulates per-channel spectral responses and is
only available in spectral variants (it rejects identically in RGB
builds); with the spectral transport variant (scene.spectral,
core/spectrum.py) this module provides the wavefront counterpart: a
per-pixel BINNED spectral radiance image.

Estimator: each lane carries N_SPEC hero wavelengths with uniform pdf
1/span; the integral of radiance over bin b is estimated by
(span / (spp * N_SPEC)) * sum of L_i for lambda_i in bin b.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import spectrum as spec
from ..core.rng import make_sampler
from ..scene.ir import Scene
from ..sensor.perspective import sample_ray
from . import path as path_mod


# lanes per device execution: spectral lanes carry an N_SPEC wavelength
# packet (heavier than RGB), and one unchunked jit over w*h*spp lanes
# exhausts device memory at film scale — split the spp axis
# into passes exactly like common.render's spp_pass loop
MAX_SPEC_WAVEFRONT = 1 << 20


def render_specfilm(scene: Scene, n_bins: int = 16, spp: int = 16,
                    seed: int = 0):
    """(h, w, n_bins) binned spectral radiance over [SPEC_MIN, SPEC_MAX).

    Requires a spectral-variant scene (load_dict(..., variant="spectral"));
    surface-path transport only, box binning of the wavelength axis.
    The spp axis is split into bounded device executions; the counter RNG
    keys on the global (pixel, sample) pair so any chunking reproduces the
    unchunked estimate bit-for-bit."""
    assert scene.spectral, "render_specfilm needs the spectral variant"
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    spp_pass = max(1, min(spp, MAX_SPEC_WAVEFRONT // max(n_pix, 1)))
    while spp % spp_pass != 0:
        spp_pass -= 1
    acc = None
    for p in range(spp // spp_pass):
        film = _specfilm_pass(scene, jnp.asarray(seed, jnp.uint32),
                              jnp.uint32(p * spp_pass), n_bins, spp,
                              spp_pass)
        acc = film if acc is None else acc + film
    return (acc / (spp * spec.N_SPEC)).reshape(h, w, n_bins)


@partial(jax.jit, static_argnames=("n_bins", "spp", "spp_pass"))
def _specfilm_pass(scene: Scene, seed, samp0, n_bins: int, spp: int,
                   spp_pass: int):
    """Unnormalized (n_pix, n_bins) accumulator over samples
    [samp0, samp0 + spp_pass) of each pixel."""
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    n = n_pix * spp_pass
    lane = jnp.arange(n, dtype=jnp.uint32)
    pix = lane // spp_pass
    samp = lane % spp_pass + samp0
    sampler = make_sampler(pix, samp, seed,
                           kind=scene.sampler_kind, spp=spp)
    px = (pix % w).astype(jnp.float32)
    py = (pix // w).astype(jnp.float32)
    uf, sampler = sampler.next_2d()
    pos = jnp.stack([px, py], -1) + uf
    ray = sample_ray(scene, pos)

    st = path_mod.init_state(ray, sampler, scene)
    st = jax.lax.while_loop(
        lambda s: jnp.any(s.active) & jnp.all(s.depth < scene.max_depth),
        lambda s: path_mod.bounce(scene, s), st)

    span = spec.SPEC_MAX - spec.SPEC_MIN
    bins = jnp.clip(((st.lam - spec.SPEC_MIN) / span
                     * n_bins).astype(jnp.int32), 0, n_bins - 1)
    ipix = jnp.clip(pos[:, 1].astype(jnp.int32), 0, h - 1) * w \
        + jnp.clip(pos[:, 0].astype(jnp.int32), 0, w - 1)
    L = jnp.where(jnp.isfinite(st.L), st.L, 0.0)
    film = jnp.zeros((n_pix, n_bins))
    idx = ipix[:, None] * n_bins + bins                  # (N, N_SPEC)
    return film.reshape(-1).at[idx.reshape(-1)].add(
        (L * span).reshape(-1)).reshape(n_pix, n_bins)
