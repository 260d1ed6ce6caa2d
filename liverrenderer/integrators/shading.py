"""Shading-frame post-processing: bump/normal mapping.

Capability analog of reference src/bsdfs/{bumpmap,normalmap}.cpp, folded to
the shape level (scene/builder.py stores the perturbation texture per shape):
the frame is perturbed once per interaction, before any BSDF dispatch.
Without ray differentials we use a fixed uv finite-difference step for the
height-map gradient.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import math as m
from ..core.types import SurfaceInteraction
from ..scene.ir import Scene
from ..texture.eval import eval_texture, eval_texture_grad_mono


def shading_frame_with_bump(scene: Scene, si: SurfaceInteraction, ray):
    """Perturb si.sh_frame by the shape's bump/normal map (if any).

    The height gradient comes from the bilinear patch of ONE quad texture
    tap (texture/eval.py eval_texture_grad_mono) — one per-lane gather
    instead of several, so the reference's finite-difference taps
    (bumpmap.cpp) are folded into the analytic patch derivative.
    """
    if not scene.has_bump:
        return si
    shape = jnp.maximum(si.shape, 0)
    btex = m.table_lookup(scene.shape_bump_tex, shape)
    bscale = m.table_lookup(scene.shape_bump_scale, shape)
    has_bump = (btex >= 0) & si.valid & (bscale > 0)
    has_nmap = (btex >= 0) & si.valid & (bscale < 0)

    frame = si.sh_frame
    n = frame.n
    new_n = n
    if scene.has_heightmap:
        _, dhdu, dhdv = eval_texture_grad_mono(scene.textures, btex, si.uv)
        dhdu = dhdu * jnp.abs(bscale)
        dhdv = dhdv * jnp.abs(bscale)
        n_bump = m.normalize(n - dhdu[:, None] * frame.s
                             - dhdv[:, None] * frame.t)
        new_n = jnp.where(has_bump[:, None], n_bump, new_n)
    if scene.has_normalmap:
        rgb = eval_texture(scene.textures, btex, si.uv)
        tn = m.normalize(2.0 * rgb - 1.0)
        n_nmap = m.normalize(tn[:, 0:1] * frame.s + tn[:, 1:2] * frame.t
                             + tn[:, 2:3] * n)
        new_n = jnp.where(has_nmap[:, None], n_nmap, new_n)

    new_frame = m.make_frame(new_n)
    wi_local = new_frame.to_local(-ray.d)
    use = (has_bump | has_nmap)
    return si.replace(
        sh_frame=m.make_frame(jnp.where(use[:, None], new_n, n)),
        wi=jnp.where(use[:, None], wi_local, si.wi))
