"""Ground-truth subsurface random walk (the reference's Volpath3D particle
tracer, sss_particle_tracer.h:74-505): the brute-force sampler the VAE was
trained against, kept as the validation oracle and training-data machinery.

Design: N walkers advance in lockstep in a bounded `lax.while_loop`
(free flight -> surface test against the implicit degree-3 polynomial via
sphere-trace-style marching -> HG scatter or absorb), all branchless masked
selects.  The reference's per-path recursion (samplePathsBatch
:242-335) becomes one wavefront.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..phase.dispatch import phase_sample
from ..scene.ir import PHASE_HG
from .poly import eval_poly

Array = jax.Array

_MARCH_STEPS = 24


@struct.dataclass
class WalkResult:
    """ScatterSamplingRecord analog (sss_particle_tracer.h:9-16)."""
    out_p: Array       # (N, 3) exit position (on the poly surface)
    out_d: Array       # (N, 3) exit direction
    absorbed: Array    # (N,) bool
    exited: Array      # (N,) bool
    n_bounces: Array   # (N,) int32


def _poly_crossing(coeffs, p0, d, t_max):
    """First t in (0, t_max] with f(p0 + t d) >= 0 (inside is f < 0),
    found by fixed-count marching + one secant refinement — the analog of
    the reference's polynomial sphere trace (intersectPolynomial :382)."""
    n = p0.shape[0]
    dt = t_max / _MARCH_STEPS

    def body(i, carry):
        t_hit, f_prev, found = carry
        t = (i + 1).astype(jnp.float32) * dt
        f = eval_poly(coeffs, p0 + t[:, None] * d)
        cross = (f >= 0.0) & ~found
        # secant step between the bracketing samples
        denom = jnp.where(jnp.abs(f - f_prev) > 1e-12, f - f_prev, 1.0)
        t_ref = t - dt + dt * jnp.clip(-f_prev / denom, 0.0, 1.0)
        t_hit = jnp.where(cross, t_ref, t_hit)
        return t_hit, f, cross | found

    f0 = eval_poly(coeffs, p0)
    t_hit, _, found = jax.lax.fori_loop(
        0, _MARCH_STEPS, body,
        (jnp.full((n,), jnp.inf), f0, jnp.zeros((n,), bool)))
    return t_hit, found


def sample_paths(coeffs, entry_p, entry_d, sigma_t, albedo, g, sampler,
                 max_bounces: int = 256, eta: float = 1.0):
    """Random-walk N packets through the homogeneous medium bounded by the
    implicit surface f(x) = 0 (inside f < 0).

    coeffs: (20,) or (N, 20) degree-3 polynomial; entry_p/entry_d: (N, 3)
    world-frame entry points/directions (entry_d pointing inside);
    sigma_t/albedo/g/eta scalars.  Returns (WalkResult, sampler).

    eta != 1 enables INTERNAL FRESNEL RE-ENTRY at the boundary — the
    reference tracer's exit handling (sss_particle_tracer.h:202-215):
    a walker reaching the surface reflects back inside with probability
    F(cos_theta_i, eta) and otherwise exits REFRACTED; with eta == 1
    every boundary crossing exits straight through (F == 0), bitwise the
    historical behavior except for one extra (unused) RNG draw.
    """
    n = entry_p.shape[0]
    if coeffs.ndim == 1:
        coeffs = jnp.broadcast_to(coeffs, (n,) + coeffs.shape)
    sigma_t = jnp.asarray(sigma_t, jnp.float32)
    march_span = 12.0 / sigma_t        # covers ~12 mean free paths
    from ..core.fresnel import fresnel_dielectric
    from ..core import math as cm
    from .poly import eval_poly_grad, onb_duff

    st = dict(
        p=entry_p, d=entry_d,
        alive=jnp.ones((n,), bool),
        absorbed=jnp.zeros((n,), bool),
        exited=jnp.zeros((n,), bool),
        out_p=entry_p, out_d=entry_d,
        bounces=jnp.zeros((n,), jnp.int32),
        sampler=sampler,
        it=jnp.int32(0),
    )

    def cond(st):
        return jnp.any(st["alive"]) & (st["it"] < max_bounces)

    def body(st):
        sampler = st["sampler"]
        u1, sampler = sampler.next_1d()
        u2, sampler = sampler.next_2d()
        ua, sampler = sampler.next_1d()

        uf, sampler = sampler.next_1d()

        # free flight
        t_free = -jnp.log(jnp.maximum(1.0 - u1, 1e-9)) / sigma_t
        # surface crossing before the collision?
        t_surf, found = _poly_crossing(coeffs, st["p"], st["d"],
                                       jnp.minimum(t_free, march_span))
        reaches = st["alive"] & found & (t_surf <= t_free)
        p_hit = st["p"] + t_surf[:, None] * st["d"]

        # internal Fresnel at the boundary (sss_particle_tracer.h:202-215):
        # outward normal = grad f (inside is f < 0); the local frame is
        # (b1, b2, n_out); wi points away from the surface (back inside)
        n_out = eval_poly_grad(coeffs, p_hit)
        n_out = n_out / jnp.maximum(
            jnp.linalg.norm(n_out, axis=-1, keepdims=True), 1e-12)
        b1, b2 = onb_duff(n_out)
        wi_l = jnp.stack([jnp.sum(-st["d"] * b1, -1),
                          jnp.sum(-st["d"] * b2, -1),
                          jnp.sum(-st["d"] * n_out, -1)], -1)
        F, ctt, _, eta_ti = fresnel_dielectric(wi_l[..., 2], eta)
        re_enter = reaches & (uf < F)
        exits = reaches & ~re_enter
        refl_l = cm.reflect(wi_l)
        refr_l = cm.refract_local(wi_l, ctt, eta_ti)

        def to_world(v):
            return v[..., 0:1] * b1 + v[..., 1:2] * b2 \
                + v[..., 2:3] * n_out

        d_refl = to_world(refl_l)
        d_refr = to_world(refr_l)
        out_p = jnp.where(exits[:, None], p_hit, st["out_p"])
        out_d = jnp.where(exits[:, None], d_refr, st["out_d"])
        # re-entering walkers restart just inside the boundary
        p_re = p_hit - n_out * (1e-3 / sigma_t)

        # collision: absorb or scatter (HG)
        collides = st["alive"] & ~reaches
        absorb = collides & (ua >= albedo)
        p_new = st["p"] + jnp.minimum(t_free, march_span)[:, None] * st["d"]
        ptype = jnp.full((n,), PHASE_HG, jnp.int32)
        gl = jnp.full((n,), g, jnp.float32)
        d_new, _, _ = phase_sample(ptype, gl, st["d"], u2)

        alive = (collides & ~absorb) | re_enter
        p_next = jnp.where(re_enter[:, None], p_re,
                           jnp.where(collides[:, None], p_new, st["p"]))
        d_next = jnp.where(re_enter[:, None], d_refl,
                           jnp.where((collides & ~absorb)[:, None],
                                     d_new, st["d"]))
        return dict(
            p=p_next,
            d=d_next,
            alive=alive,
            absorbed=st["absorbed"] | absorb,
            exited=st["exited"] | exits,
            out_p=out_p, out_d=out_d,
            bounces=st["bounces"] + collides.astype(jnp.int32),
            sampler=sampler,
            it=st["it"] + 1,
        )

    st = jax.lax.while_loop(cond, body, st)
    # walkers still alive at the bounce cap count as absorbed (reference
    # caps path length the same way)
    res = WalkResult(out_p=st["out_p"], out_d=st["out_d"],
                     absorbed=st["absorbed"] | st["alive"],
                     exited=st["exited"], n_bounces=st["bounces"])
    return res, st["sampler"]


def flat_halfspace_coeffs():
    """f(x) = z: the z<0 half space (canonical training geometry)."""
    c = jnp.zeros(20, jnp.float32)
    return c.at[3].set(1.0)     # the z-linear term (poly.py monomial order)
