"""Film accumulation: filtered sample splatting + develop.

Wavefront replacement of the reference ImageBlock/Film pipeline
(src/render/imageblock.cpp:119-126 atomic `dr::scatter_reduce` splats;
film.cpp develop with weight division): samples are splatted with
`Array.at[].add` scatter-adds (atomic adds on a GPU, so sums are not
bitwise repeatable), with a weight channel accumulated alongside.

Reconstruction filters (src/rfilters/{box,gaussian,tent}.cpp): the footprint
loop is static (unrolled), radius depends on the filter type.
"""
from __future__ import annotations

import jax.numpy as jnp

from .scene.ir import (FILTER_BOX, FILTER_CATMULLROM, FILTER_GAUSSIAN,
                       FILTER_LANCZOS, FILTER_MITCHELL, FILTER_TENT)


def filter_radius(rfilter: int) -> int:
    return {FILTER_BOX: 0, FILTER_GAUSSIAN: 2, FILTER_TENT: 1,
            FILTER_MITCHELL: 2, FILTER_CATMULLROM: 2,
            FILTER_LANCZOS: 3}[rfilter]


def _mitchell_1d(x, B, C):
    """Mitchell-Netravali kernel (reference src/rfilters/mitchell.cpp;
    catmullrom.cpp is the B=0, C=0.5 special case)."""
    x = jnp.abs(x)
    x2, x3 = x * x, x * x * x
    near = ((12.0 - 9.0 * B - 6.0 * C) * x3
            + (-18.0 + 12.0 * B + 6.0 * C) * x2 + (6.0 - 2.0 * B)) / 6.0
    far = ((-B - 6.0 * C) * x3 + (6.0 * B + 30.0 * C) * x2
           + (-12.0 * B - 48.0 * C) * x + (8.0 * B + 24.0 * C)) / 6.0
    return jnp.where(x < 1.0, near, jnp.where(x < 2.0, far, 0.0))


def _lanczos_1d(x, tau=3.0):
    """Lanczos-sinc windowed filter (src/rfilters/lanczos.cpp, tau=3)."""
    x = jnp.abs(x)
    pix = jnp.pi * jnp.maximum(x, 1e-6)
    sinc = jnp.sin(pix) / pix
    wind = jnp.sin(pix / tau) / (pix / tau)
    w = jnp.where(x < 1e-6, 1.0, sinc * wind)
    return jnp.where(x < tau, w, 0.0)


def _filter_weight(rfilter: int, dx, dy):
    if rfilter == FILTER_BOX:
        return jnp.ones_like(dx)
    if rfilter == FILTER_GAUSSIAN:
        # reference gaussian.cpp: std = 0.5, truncated at 4*std = 2px
        std = 0.5
        alpha = -1.0 / (2.0 * std * std)
        r2 = 2.0 * 2.0
        wx = jnp.maximum(jnp.exp(alpha * dx * dx) - jnp.exp(alpha * r2), 0.0)
        wy = jnp.maximum(jnp.exp(alpha * dy * dy) - jnp.exp(alpha * r2), 0.0)
        return wx * wy
    if rfilter == FILTER_TENT:
        return jnp.maximum(1.0 - jnp.abs(dx), 0.0) \
            * jnp.maximum(1.0 - jnp.abs(dy), 0.0)
    if rfilter == FILTER_MITCHELL:
        return _mitchell_1d(dx, 1 / 3, 1 / 3) * _mitchell_1d(dy, 1 / 3, 1 / 3)
    if rfilter == FILTER_CATMULLROM:
        return _mitchell_1d(dx, 0.0, 0.5) * _mitchell_1d(dy, 0.0, 0.5)
    if rfilter == FILTER_LANCZOS:
        return _lanczos_1d(dx) * _lanczos_1d(dy)
    raise ValueError(rfilter)


def splat(w: int, h: int, rfilter: int, pos, value):
    """Splat per-sample radiance into an (h, w, 4) RGB+weight accumulator.

    pos: (N,2) continuous film coords; value: (N,3).
    """
    img = jnp.zeros((h * w, 4), jnp.float32)
    r = filter_radius(rfilter)
    if r == 0:
        px = jnp.clip(pos[..., 0].astype(jnp.int32), 0, w - 1)
        py = jnp.clip(pos[..., 1].astype(jnp.int32), 0, h - 1)
        idx = py * w + px
        data = jnp.concatenate([value, jnp.ones(value.shape[:-1] + (1,))], -1)
        img = img.at[idx].add(data)
        return img.reshape(h, w, 4)

    # discretized sample position relative to pixel centers
    cx = pos[..., 0] - 0.5
    cy = pos[..., 1] - 0.5
    bx = jnp.floor(cx).astype(jnp.int32)
    by = jnp.floor(cy).astype(jnp.int32)
    for oy in range(-r + 1, r + 1):
        for ox in range(-r + 1, r + 1):
            px = bx + ox
            py = by + oy
            wgt = _filter_weight(rfilter, px.astype(jnp.float32) - cx,
                                 py.astype(jnp.float32) - cy)
            inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            wgt = jnp.where(inside, wgt, 0.0)
            idx = jnp.clip(py, 0, h - 1) * w + jnp.clip(px, 0, w - 1)
            data = jnp.concatenate([value * wgt[..., None], wgt[..., None]], -1)
            img = img.at[idx].add(data)
    return img.reshape(h, w, 4)


def develop(acc):
    """Weight-divide the accumulator (reference film->develop())."""
    wch = acc[..., 3:4]
    return jnp.where(wch > 0, acc[..., 0:3] / jnp.maximum(wch, 1e-12), 0.0)
