"""Surface path tracer with NEE + MIS (the reference `path` plugin).

Re-derivation of src/integrators/path.cpp:95-350 as a wavefront program:
the recorded Dr.Jit megakernel loop (path.cpp:194) becomes a `lax.while_loop`
(primal) or bounded `lax.scan` (differentiable mode — reverse-mode AD needs a
static trip count) over a PathState SoA pytree; every bounce processes all
lanes branchlessly.

MIS/RR semantics match the reference:
  * emitter hits weighted by mis_weight(prev_bsdf_pdf, emitter_pdf),
    emitter_pdf = 0 for camera rays & delta bounces (path.cpp:207-223),
  * NEE with mis_weight(ds.pdf, bsdf_pdf) zeroed for delta emitters
    (path.cpp:247-259),
  * Russian roulette after rr_depth with throughput*eta^2 survival prob
    capped at 0.95, detached (path.cpp:320-336).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..accel.intersect import ray_intersect, ray_test
from ..bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
from ..core import math as m
from ..core.rng import Sampler
from ..core.types import Ray, SurfaceInteraction
from ..emitter.dispatch import (eval_emitter_hit, eval_environment,
                                pdf_emitter_direction,
                                sample_emitter_direction)
from ..scene.ir import F_DELTA, F_SMOOTH, Scene
from .shading import shading_frame_with_bump

Array = jax.Array


@struct.dataclass
class PathState:
    active: Array        # (N,) bool
    depth: Array         # (N,) int32
    ray_o: Array         # (N,3)
    ray_d: Array         # (N,3)
    L: Array             # (N,C) accumulated radiance (C=3 RGB; N_SPEC spectral)
    throughput: Array    # (N,C)
    lam: Array           # (N,N_SPEC) hero wavelengths ((N,1) dummy in RGB)
    eta: Array           # (N,)
    prev_p: Array        # (N,3) last scatter position (MIS ref point)
    prev_pdf: Array      # (N,) last bsdf sample pdf
    prev_smooth: Array   # (N,) bool: last bounce was a smooth (MIS-able) lobe
    sampler: Sampler
    valid: Array         # (N,) bool: ray contributed (alpha)


def init_state(ray: Ray, sampler: Sampler, scene: Scene) -> PathState:
    n = ray.o.shape[0]
    if scene.spectral:
        from ..core import spectrum as spec
        u, sampler = sampler.next_1d()
        lam = spec.sample_hero(u)
        C = spec.N_SPEC
    else:
        lam = jnp.zeros((n, 1))
        C = 3
    return PathState(
        active=jnp.ones((n,), bool),
        depth=jnp.zeros((n,), jnp.int32),
        ray_o=ray.o, ray_d=ray.d,
        L=jnp.zeros((n, C)),
        throughput=jnp.ones((n, C)),
        lam=lam,
        eta=jnp.ones((n,)),
        prev_p=ray.o,
        prev_pdf=jnp.ones((n,)),
        prev_smooth=jnp.zeros((n,), bool),
        sampler=sampler,
        valid=jnp.zeros((n,), bool),
    )


def bounce(scene: Scene, st: PathState, ad: bool = False) -> PathState:
    """One wavefront bounce.  ad=True applies the detached-sampling rule
    to the surface chain (path.cpp:294-306): the continuation ray is
    DETACHED and the throughput factor re-evaluated differentiably at the
    detached direction — attached VNDF/frame sampling has unbounded
    Jacobians at grazing configurations (1/cos terms) that NaN every
    reverse pass through rough lobes."""
    n = st.ray_o.shape[0]
    active = st.active
    ray = Ray(o=st.ray_o, d=st.ray_d, maxt=jnp.full((n,), jnp.inf))

    if scene.spectral:
        # spectral variant: lift RGB radiometric factors to the lane's
        # hero-wavelength packet (core/spectrum.py — reflectances by the
        # Smits basis, radiances D65-referenced per srgb_d65)
        from ..core import spectrum as _spec

        def refl(v):
            return _spec.smits_upsample(v, st.lam)

        def illum(v):
            return _spec.smits_upsample_illum(v, st.lam)
    else:
        def refl(v):
            return v
        illum = refl

    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)

    # ---------------- emission gathered along the BSDF-sampled ray --------
    em_val, eidx = eval_emitter_hit(scene, si, ray.d)
    env_val = eval_environment(scene, ray.d)
    em_val, env_val = illum(em_val), illum(env_val)
    hit_emitter = (eidx >= 0) & si.valid
    escaped = ~si.valid
    if scene.emitters.env_index >= 0:
        env_e = jnp.full((n,), scene.emitters.env_index, jnp.int32)
        eidx_mis = jnp.where(escaped, env_e, eidx)
    else:
        eidx_mis = eidx
    count_direct = (st.depth == 0) | ~st.prev_smooth
    em_pdf = pdf_emitter_direction(scene, st.prev_p, eidx_mis, si.p,
                                   si.ng, ray.d)
    em_pdf = jnp.where(count_direct, 0.0, em_pdf)
    mis_bsdf = m.mis_weight(st.prev_pdf, em_pdf)
    contrib = jnp.where(hit_emitter[:, None], em_val, 0.0) \
        + jnp.where(escaped[:, None], env_val, 0.0)
    hide = scene.hide_emitters & (st.depth == 0)
    gather = active & ~hide
    st = st.replace(L=st.L + jnp.where(
        gather[:, None], st.throughput * contrib * mis_bsdf[:, None], 0.0))

    active_next = active & si.valid & (st.depth + 1 < scene.max_depth)
    st = st.replace(valid=st.valid | (active & si.valid))

    # ---------------- emitter sampling (NEE) ------------------------------
    flags = m.table_lookup(scene.bsdfs.flags, jnp.maximum(
        m.table_lookup(scene.shape_bsdf, jnp.maximum(si.shape, 0)), 0))
    smooth_here = (flags & F_SMOOTH) != 0
    active_e = active_next & smooth_here
    u2, sampler = st.sampler.next_2d()
    u1, sampler = sampler.next_1d()
    ds, em_weight = sample_emitter_direction(scene, si.p, u2, u1)
    nee_valid = active_e & (ds.pdf > 0)
    sray = si.spawn_ray_to(ds.p)
    occluded = ray_test(scene, Ray(o=sray.o, d=sray.d, maxt=sray.maxt))
    nee_valid &= ~occluded
    wo_local = si.to_local(ds.d)
    bval, bpdf = bsdf_eval_pdf(
        scene, si, m.table_lookup(scene.shape_bsdf,
                                  jnp.maximum(si.shape, 0)), wo_local)
    mis_em = m.mis_weight(ds.pdf, jnp.where(ds.delta, 0.0, bpdf))
    st = st.replace(L=st.L + jnp.where(
        nee_valid[:, None],
        st.throughput * refl(bval) * illum(em_weight) * mis_em[:, None],
        0.0))

    # ---------------- BSDF sampling ---------------------------------------
    ub1, sampler = sampler.next_1d()
    ub2, sampler = sampler.next_2d()
    bs = bsdf_sample(scene, si,
                     m.table_lookup(scene.shape_bsdf,
                                    jnp.maximum(si.shape, 0)), ub1, ub2)
    wo_world = si.to_world(bs.wo)
    new_ray = si.spawn_ray(wo_world)
    weight = refl(bs.weight)
    if ad:
        # detach the ray; recover the bounce-local differentiable factor
        # by re-evaluating smooth lobes at the detached direction
        # (delta lobes keep the sampled weight — their Fresnel is attached
        # through wi only and eval() is zero by contract)
        new_ray = Ray(o=jax.lax.stop_gradient(new_ray.o),
                      d=jax.lax.stop_gradient(new_ray.d),
                      maxt=new_ray.maxt)
        wo_re = si.to_local(jax.lax.stop_gradient(wo_world))
        val2, _ = bsdf_eval_pdf(
            scene, si, m.table_lookup(scene.shape_bsdf,
                                      jnp.maximum(si.shape, 0)), wo_re)
        w_re = refl(val2) / jnp.maximum(
            jax.lax.stop_gradient(bs.pdf), 1e-12)[:, None]
        smooth_lobe = (bs.sampled_type & F_DELTA) == 0
        weight = jnp.where(smooth_lobe[:, None], w_re,
                           jax.lax.stop_gradient(refl(bs.weight)))
    throughput = st.throughput * weight
    eta = st.eta * bs.eta
    sampled_smooth = (bs.sampled_type & F_DELTA) == 0
    alive = active_next & (bs.pdf > 0) \
        & jnp.any(throughput != 0.0, axis=-1)

    # ---------------- BSSRDF hook (path.cpp:262-265) ----------------------
    # A transmission event through a vaescatter shape's boundary replaces
    # the ray continuation with the VAE-sampled exit ray (ssub/event.py);
    # dipole shapes instead gather the diffusion term additively.
    if scene.ssub.enabled:
        from ..scene.ir import SSUB_DIPOLE, SSUB_VAE
        ss_idx_l = m.table_lookup(scene.shape_subsurface,
                                  jnp.maximum(si.shape, 0))
        ss_t = scene.ssub.ss_type[jnp.maximum(ss_idx_l, 0)]
        ss_any = active_next & si.valid & (ss_idx_l >= 0) & \
            (si.wi[:, 2] > 0)
    if scene.ssub.enabled and scene.ssub.has_dipole:
        from ..ssub.dipole import dipole_lo
        dip_mask = ss_any & (ss_t == SSUB_DIPOLE)
        lo = dipole_lo(scene, si.p, si.wi[:, 2], dip_mask)
        st = st.replace(L=st.L + jnp.where(dip_mask[:, None],
                                           st.throughput * lo, 0.0))
    if scene.ssub.enabled and scene.ssub.has_vae:
        from ..ssub.event import subsurface_event
        ss_here = ss_any & (ss_t == SSUB_VAE)
        transmitted = (bs.wo[:, 2] * si.wi[:, 2]) < 0
        ss_mask = ss_here & transmitted & (bs.pdf > 0)
        ev, sampler = subsurface_event(scene, si, wo_world, sampler,
                                       ss_mask)
        st = st.replace(L=st.L + jnp.where(
            ss_mask[:, None], throughput * ev.L_nee, 0.0))
        epsq = (1.0 + jnp.max(jnp.abs(ev.out_p), -1)) * 1e-4
        ss_o = ev.out_p + ev.out_d * epsq[:, None]
        new_ray = Ray(
            o=jnp.where(ss_mask[:, None], ss_o, new_ray.o),
            d=jnp.where(ss_mask[:, None], ev.out_d, new_ray.d),
            maxt=new_ray.maxt)
        throughput = jnp.where(ss_mask[:, None], throughput * ev.weight,
                               throughput)
        alive = jnp.where(ss_mask, ev.alive, alive)
        bs = bs.replace(pdf=jnp.where(ss_mask, ev.pdf, bs.pdf))
        sampled_smooth = jnp.where(ss_mask, ~ev.passthrough, sampled_smooth)

    # ---------------- Russian roulette ------------------------------------
    urr, sampler = sampler.next_1d()
    tp_max = jnp.max(throughput, -1) * (eta * eta)
    q = jnp.minimum(tp_max, 0.95)
    perform_rr = st.depth + 1 >= scene.rr_depth
    rr_continue = (urr < q) | ~perform_rr
    throughput = jnp.where(
        perform_rr[:, None],
        throughput / jnp.maximum(jax.lax.stop_gradient(q), 1e-8)[:, None],
        throughput)
    alive &= rr_continue

    return st.replace(
        active=alive,
        depth=st.depth + 1,
        ray_o=jnp.where(alive[:, None], new_ray.o, st.ray_o),
        ray_d=jnp.where(alive[:, None], new_ray.d, st.ray_d),
        throughput=jnp.where(alive[:, None], throughput, st.throughput),
        eta=jnp.where(alive, eta, st.eta),
        prev_p=jnp.where(alive[:, None], si.p, st.prev_p),
        prev_pdf=jnp.where(alive, bs.pdf, st.prev_pdf),
        prev_smooth=jnp.where(alive, sampled_smooth, st.prev_smooth),
        sampler=sampler,
    )


def sample(scene: Scene, sampler: Sampler, ray: Ray, mode: str = "primal"):
    """Estimate radiance for each lane.  mode='primal' uses a while_loop
    (early exit when all lanes die); mode='ad' uses a scan with a static
    trip count so reverse-mode AD works (integrators/prb.py)."""
    st = init_state(ray, sampler, scene)
    if mode == "primal":
        st = jax.lax.while_loop(
            lambda s: jnp.any(s.active) & jnp.all(s.depth < scene.max_depth),
            lambda s: bounce(scene, s), st)
    else:
        # reverse-AD needs a static trip count; remat each bounce so the
        # backward pass recomputes instead of storing per-bounce activations
        # (the scan carry is the only retained state — PRB's memory profile).
        body = jax.checkpoint(lambda s: bounce(scene, s, ad=True))

        def step(s, _):
            return body(s), None
        st, _ = jax.lax.scan(step, st, None, length=scene.max_depth)
    L = st.L
    if scene.spectral:
        from ..core import spectrum as spec
        L = spec.spec_to_rgb_estimate(L, st.lam)
    return L, st.valid, st.sampler
