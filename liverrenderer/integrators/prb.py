"""Differentiable rendering: gradients of image losses w.r.t. scene params.

Wavefront replacement for the reference's AD-integrator machinery
(python/ad/integrators/common.py ADIntegrator/RBIntegrator, prb.py
PRBIntegrator, prbvolpath.py): instead of a Dr.Jit AD tape with a two-pass
radiative-backprop replay, the wavefront loop runs as a bounded `lax.scan`
(integrators/{path,volpath}.sample mode='ad') under reverse-mode `jax.grad`,
with `jax.checkpoint` rematerializing each bounce so memory stays
O(state x 1), and detached-sampling rules enforced by stop_gradient at every
sampling density (core/math.mis_weight, emitter weights, volpath ratios —
mirroring common.py:294-306 detach semantics).

Pass-level gradient accumulation replaces PRB's O(1)-memory replay: render
passes are independent MC estimates, so grad(sum of passes) = sum of
per-pass grads — each pass's backward runs on its own wavefront
(common.py spp splitting, integrator.cpp:275-293, applied to the adjoint).
Because the sampler is counter-based (core/rng.py), every pass replays its
primal randoms exactly in the backward recomputation, which is the PRB
replay property (common.py:752-775) for free.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import jax
import jax.numpy as jnp

from .. import film as film_mod
from ..scene.ir import Scene
from ..util import apply_params
from .common import render_pass

Array = jax.Array


@partial(jax.jit, static_argnames=("spp", "spp_pass", "loss_fn"))
def _grad_jit(scene: Scene, params: Dict[str, Array], seed, spp: int,
              spp_pass: int, loss_fn: Callable):
    """Returns (loss, grads, image). loss_fn: (image) -> scalar."""
    n_passes = (spp + spp_pass - 1) // spp_pass
    h, w = scene.film_h, scene.film_w

    def render_p(p, i):
        sc = apply_params(scene, p)
        acc = render_pass(sc, seed, spp_pass, i * spp_pass, mode="ad")
        return acc

    # primal image (all passes, no grad) to evaluate dL/dI once.  The
    # regenerating wavefront renders it ~3x faster than the fixed scan;
    # dL/dI on an independent unbiased primal estimate keeps the adjoint
    # unbiased (detached-loss evaluation, common.py primal phase).
    from .regen import regen_applicable, render_regen
    sc_primal = apply_params(scene, params)
    if regen_applicable(sc_primal, "primal"):
        acc = jax.lax.stop_gradient(render_regen(sc_primal, seed, spp))
    else:
        def body(i, acc):
            return acc + jax.lax.stop_gradient(
                render_p(params, i))
        acc = jax.lax.fori_loop(0, n_passes, body,
                                jnp.zeros((h, w, 4), jnp.float32))
    image = film_mod.develop(acc)
    loss, dL_dI = jax.value_and_grad(loss_fn)(image)

    # adjoint: per-pass VJP with the same seeds (PRB replay), accumulated
    def pass_grad(i, g_acc):
        def f(p):
            acc_i = render_p(p, i)
            # develop(total) = sum_i acc_i[rgb] / total_weight; the filter
            # weights carry no parameter dependence, so differentiate each
            # pass's rgb against the detached total weight channel.
            wch = jax.lax.stop_gradient(jnp.maximum(acc[..., 3:4], 1e-12))
            img_i = acc_i[..., 0:3] / wch
            return jnp.sum(img_i * dL_dI)
        gi = jax.grad(f)(params)
        return jax.tree_util.tree_map(jnp.add, g_acc, gi)

    g0 = jax.tree_util.tree_map(jnp.zeros_like, params)
    grads = jax.lax.fori_loop(0, n_passes, pass_grad, g0)
    return loss, grads, image


def render_grad(scene: Scene, params: Dict[str, Array], loss_fn: Callable,
                spp: int = 16, seed: int = 0, spp_pass: int | None = None,
                replay: bool | None = None):
    """Differentiable render: returns (loss, grads wrt params, image).

    `params` is a dict of leaf overrides (util.traverse keys); `loss_fn`
    maps the developed (h, w, 3) image to a scalar.

    Dispatches to the PRB replay adjoint (prb_replay.py, ~one forward +
    one replay walk) whenever the configuration supports it; pass
    replay=False to force the scan adjoint (used by its own tests).
    """
    from .prb_replay import render_grad_replay, replay_applicable
    if replay is None:
        replay = replay_applicable(scene, params, spp)
    if replay:
        out = render_grad_replay(scene, params, loss_fn, spp=spp, seed=seed)
    else:
        out = None
    if out is None:
        out = _render_grad_scan(scene, params, loss_fn, spp, seed, spp_pass)
    if "vertices" in params:
        # visibility (boundary) terms: primarily-visible silhouettes
        # (film-space line integral) + one-indirect-bounce silhouettes
        # (direction-domain line integral at the first hit) —
        # integrators/projective.py; reference direct_projective +
        # prb_projective indirect phase
        from .projective import boundary_gradient, indirect_boundary_gradient
        loss, grads, image = out
        delta = jax.grad(lambda im: loss_fn(im))(image)
        g_b = boundary_gradient(scene, params, delta, seed=seed + 7)
        # indirect silhouettes at interior vertices: sample the prefix
        # depth up to 3 bounces (capped by the transport depth) — the
        # reference PSIntegrator's (pixel^2, depth) boundary domain
        g_i = indirect_boundary_gradient(scene, params, delta,
                                         seed=seed + 13,
                                         depth_max=max(
                                             1, min(3, scene.max_depth - 2)))
        grads = dict(grads)
        grads["vertices"] = grads["vertices"] + g_b + g_i
        out = (loss, grads, image)
    return out


def _render_grad_scan(scene: Scene, params: Dict[str, Array],
                      loss_fn: Callable, spp: int, seed: int,
                      spp_pass: int | None):
    n_pix = scene.film_w * scene.film_h
    from .common import MAX_WAVEFRONT
    max_pass = max(1, min(spp, (MAX_WAVEFRONT // 4) // max(n_pix, 1)))
    spp_pass = spp_pass or max_pass
    while spp % spp_pass != 0:
        spp_pass -= 1
    return _grad_jit(scene, params, seed, spp, spp_pass, loss_fn)


def render_fwd_grad(scene: Scene, params: Dict[str, Array], spp: int = 16,
                    seed: int = 0):
    """Forward-mode: d(image)/d(params) as a JVP with unit tangents.

    Analog of ADIntegrator.render_forward (common.py:112-168).  Returns
    (image, jvp_image) for tangents = ones_like(params) — callers wanting a
    specific tangent direction pass scaled params.
    """
    def f(p):
        sc = apply_params(scene, p)
        from .common import _render_jit
        return _render_jit(sc, seed, spp, spp, "ad")
    tangents = jax.tree_util.tree_map(jnp.ones_like, params)
    return jax.jvp(f, (params,), (tangents,))
