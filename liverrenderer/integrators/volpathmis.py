"""True spectral-MIS volumetric path tracer (the reference ``volpathmis``).

Re-derivation of src/integrators/volpathmis.cpp (SpectralMis variant,
volpathmis.cpp:98-687) as a wavefront program.  Instead of tracking a
throughput spectrum and one sampled channel's pdf, every lane carries two
3x3 *weight matrices*

    W[i, j] = prod over path events of ( p_j / f_i )

where row i is the spectral channel the contribution is evaluated in and
column j indexes the distance-sampling strategy that tracks channel j
(volpathmis.cpp:619-639 update_weights).  The balance-heuristic MIS weight
for channel i is then  n / sum_j W[i, j]  (:641-654), and MIS between the
NEE and unidirectional strategies sums the two matrices before the
row-reduce (:657-671).  ``p_over_f`` weights the unidirectional estimator;
``p_over_f_nee`` tracks the same path as if its last real scatter vertex
had been produced by emitter sampling.

All updates are elementwise (N,3,3) math — no gathers, no per-lane
branches — so the whole scheme is element-wise math; the only cost vs
the single-channel scheme is 18 extra floats of loop state per lane.

Bio media (the fork's liver transport) keep their one-hot channel
semantics and are routed to integrators/volpath.py by the dispatcher;
this module covers stock null-scattering media with chromatic extinction,
where spectral MIS is the variance win (volpathmis.cpp:15-66 variant
selection).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..accel.intersect import ray_intersect
from ..bsdf.dispatch import (bsdf_eval_pdf, bsdf_sample,
                             eval_null_transmission)
from ..core import math as m
from ..core.rng import Sampler
from ..core.types import Ray
from ..emitter.dispatch import (eval_emitter_hit, eval_environment,
                                pdf_emitter_direction,
                                sample_emitter_direction)
from ..media.dispatch import (finalize_interaction, medium_phase,
                              sample_interaction,
                              sample_interaction_candidate,
                              transmittance_eval_pdf)
from ..phase.dispatch import phase_eval, phase_sample
from ..scene.ir import F_DELTA, F_NULL, F_SMOOTH, Scene
from .shading import shading_frame_with_bump
from .volpath import _is_transition, _target_medium

Array = jax.Array
INF = jnp.inf
_N_CH = 3


def _spec(x, n):
    """Broadcast a scalar / (N,) / (N,3) quantity to (N,3)."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim == 0:
        return jnp.broadcast_to(x, (n, _N_CH))
    if x.ndim == 1:
        return jnp.broadcast_to(x[:, None], (n, _N_CH))
    return x


def update_weights(W, p, f, active):
    """W[i,j] *= p[j] / f[i]  (volpathmis.cpp:619-632): non-finite ratios
    and nan products zero the entry (a strategy that cannot produce the
    event has probability 0 there)."""
    n = W.shape[0]
    p = _spec(p, n)
    f = _spec(f, n)
    ratio = p[:, None, :] / f[:, :, None]          # (N, i, j)
    ratio = jnp.where(jnp.isfinite(ratio), ratio, 0.0)
    Wn = W * ratio
    Wn = jnp.where(jnp.isnan(Wn), 0.0, Wn)
    return jnp.where(active[:, None, None], Wn, W)


def mis_weight(W):
    """Balance heuristic over the n channel strategies (:641-649)."""
    s = jnp.sum(W, -1)                             # (N, 3)
    return jnp.where(s == 0.0, 0.0,
                     _N_CH / jnp.where(s == 0.0, 1.0, s))


def mis_weight2(W1, W2):
    """MIS'd throughput of two strategy families (:657-666)."""
    s = jnp.sum(W1 + W2, -1)
    return jnp.where(s == 0.0, 0.0,
                     _N_CH / jnp.where(s == 0.0, 1.0, s))


@struct.dataclass
class MisState:
    active: Array
    depth: Array
    ray_o: Array
    ray_d: Array
    L: Array
    p_over_f: Array        # (N,3,3) unidirectional weight matrix
    p_over_f_nee: Array    # (N,3,3) NEE-strategy weight matrix
    eta: Array
    medium: Array
    channel: Array         # distance-sampling channel (sampling only)
    prev_p: Array          # last real scatter vertex (MIS ref point)
    last_null: Array       # bool: last event was a null interaction
    specular_chain: Array
    valid: Array
    env_weight: Array      # (N,3) deferred environment MIS weight
    sampler: Sampler


def init_state(ray: Ray, sampler: Sampler, scene: Scene) -> MisState:
    n = ray.o.shape[0]
    u, sampler = sampler.next_1d()
    channel = jnp.minimum((u * 3).astype(jnp.int32), 2)
    eye = jnp.ones((n, _N_CH, _N_CH))
    return MisState(
        active=jnp.ones((n,), bool),
        depth=jnp.zeros((n,), jnp.int32),
        ray_o=ray.o, ray_d=ray.d,
        L=jnp.zeros((n, 3)),
        p_over_f=eye,
        p_over_f_nee=eye,
        eta=jnp.ones((n,)),
        medium=jnp.full((n,), scene.camera_medium, jnp.int32),
        channel=channel,
        prev_p=ray.o,
        last_null=jnp.zeros((n,), bool),
        specular_chain=jnp.ones((n,), bool),
        valid=jnp.zeros((n,), bool),
        env_weight=jnp.zeros((n, 3)),
        sampler=sampler,
    )


def sample_emitter_mis(scene: Scene, ref_p, medium, channel, W_in, sampler,
                       active, max_steps: int, bounded: bool):
    """NEE with per-channel ratio tracking (volpathmis.cpp:452-617
    sample_emitter): returns (W_nee_end, W_uni_end, emitted, ds, sampler).

    W_nee_end continues W_in as if the emitter-sampling strategy produced
    the connection; W_uni_end as if unidirectional sampling had walked the
    same shadow path.  ``emitted`` is the raw emitter radiance (the sample
    weight times its pdf, :460-461)."""
    n = ref_p.shape[0]
    u2, sampler = sampler.next_2d()
    u1, sampler = sampler.next_1d()
    ds, em_weight = sample_emitter_direction(scene, ref_p, u2, u1)
    emitted = em_weight * ds.pdf[:, None]
    active = active & (ds.pdf > 0)
    W_nee = update_weights(W_in, ds.pdf, 1.0, active)
    W_uni = W_in

    eps = (1.0 + jnp.max(jnp.abs(ref_p), -1)) * 1e-4
    o0 = ref_p + ds.d * eps[:, None]

    st = dict(active=active, o=o0,
              remaining=ds.dist * (1.0 - 1e-3) - eps,
              medium=medium, W_nee=W_nee, W_uni=W_uni, sampler=sampler)

    def body(st):
        active = st["active"] & (st["remaining"] > 0)
        ray = Ray(o=st["o"], d=ds.d, maxt=st["remaining"])
        si = ray_intersect(scene, ray)
        surf_t = jnp.minimum(si.t, st["remaining"])

        in_med = active & (st["medium"] >= 0)
        mei, sampler = sample_interaction(
            scene, st["medium"], st["o"], ds.d, surf_t, st["sampler"],
            channel, jnp.zeros((n,)), in_med)
        # free-flight ratio per channel (:555-559): pdf uses the escape
        # form when the surface (or the emitter) bounds the segment
        tr_a, ffpdf = transmittance_eval_pdf(scene, st["medium"], mei,
                                             surf_t)
        W_nee = update_weights(st["W_nee"], ffpdf, tr_a, in_med)
        W_uni = update_weights(st["W_uni"], ffpdf, tr_a, in_med)

        scattered = in_med & mei.valid
        # every medium collision on a shadow ray is treated as null (:570-577)
        null_prob = jnp.mean(
            mei.sigma_n / jnp.maximum(mei.combined_extinction, 1e-30), -1)
        W_nee = update_weights(W_nee, 1.0, mei.sigma_n, scattered)
        W_uni = update_weights(W_uni, null_prob, mei.sigma_n, scattered)

        hit_surface = active & ~scattered & si.valid & \
            (si.t < st["remaining"])
        null_tr = eval_null_transmission(
            scene, si, m.table_lookup(scene.shape_bsdf,
                                      jnp.maximum(si.shape, 0)))
        W_nee = update_weights(W_nee, 1.0, null_tr, hit_surface)
        W_uni = update_weights(W_uni, 1.0, null_tr, hit_surface)

        step = jnp.where(scattered, mei.t,
                         jnp.where(hit_surface, si.t + 2e-4, 0.0))
        o = st["o"] + ds.d * step[:, None]
        remaining = st["remaining"] - step
        medium2 = jnp.where(hit_surface & _is_transition(scene, si),
                            _target_medium(scene, si, ds.d), st["medium"])
        alive = (scattered | hit_surface) & (remaining > 0) & active \
            & (jnp.max(mis_weight(W_uni), -1) > 0)
        return dict(active=alive, o=o, remaining=remaining, medium=medium2,
                    W_nee=W_nee, W_uni=W_uni, sampler=sampler)

    # fixed per-lane dimension budget (see volpath.py NEE walk rationale)
    sampler_out = sampler.replace(dim=sampler.dim + jnp.uint32(128))
    if bounded:
        for _ in range(max_steps):
            st = body(st)
    else:
        def cond(c):
            s, it = c
            return jnp.any(s["active"]) & (it < 4096)
        (st, _) = jax.lax.while_loop(
            cond, lambda c: (body(c[0]), c[1] + 1), (st, 0))

    emitted = jnp.where(active[:, None], emitted, 0.0)
    return st["W_nee"], st["W_uni"], emitted, ds, sampler_out


def bounce(scene: Scene, st: MisState, bounded_nee: bool) -> MisState:
    n = st.ray_o.shape[0]
    sampler = st.sampler
    L = st.L
    depth = st.depth
    W = st.p_over_f
    W_nee = st.p_over_f_nee

    # ---------------- Russian roulette (volpathmis.cpp:233-245) ----------
    urr, sampler = sampler.next_1d()
    q = jnp.minimum(jnp.max(mis_weight(W), -1) * st.eta * st.eta, 0.95)
    perform_rr = st.active & ~st.last_null & (depth > scene.rr_depth)
    active = st.active & ~((urr >= q) & perform_rr)
    W = update_weights(W, jax.lax.stop_gradient(q), 1.0, perform_rr)
    active &= depth < scene.max_depth
    active &= jnp.any(mis_weight(W) != 0.0, -1)

    in_medium = active & (st.medium >= 0)

    # ---------------- medium sampling (candidate first) -------------------
    cand, sampler = sample_interaction_candidate(
        scene, st.medium, st.ray_o, st.ray_d, sampler, st.channel,
        jnp.zeros((n,)), in_medium)
    ray_maxt = jnp.where(in_medium & jnp.isfinite(cand["dist"]),
                         cand["dist"], INF)
    ray = Ray(o=st.ray_o, d=st.ray_d, maxt=ray_maxt)
    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)

    mei = finalize_interaction(cand, si.t, st.channel, in_medium)
    tr_a, ffpdf = transmittance_eval_pdf(scene, st.medium, mei, si.t)
    W = update_weights(W, ffpdf, tr_a, in_medium)
    W_nee = update_weights(W_nee, ffpdf, tr_a, in_medium)

    escaped = in_medium & ~mei.valid
    act_medium = in_medium & mei.valid

    # null vs real split by the MEAN null probability (:288-289)
    null_prob = jnp.mean(
        mei.sigma_n / jnp.maximum(mei.combined_extinction, 1e-30), -1)
    u_nr, sampler = sampler.next_1d()
    null_scatter = u_nr < null_prob
    act_null = act_medium & null_scatter
    act_real = act_medium & ~null_scatter
    last_null = act_null

    depth = jnp.where(act_real, depth + 1, depth)
    reached_max = depth >= scene.max_depth
    act_real &= ~reached_max

    W = update_weights(W, null_prob, mei.sigma_n, act_null)
    W_nee = update_weights(W_nee, 1.0, mei.sigma_n, act_null)

    W = update_weights(W, 1.0 - null_prob, mei.sigma_s, act_real)

    valid = st.valid | act_real
    specular_chain = st.specular_chain & ~act_real

    ptype, g, pprm = medium_phase(scene, st.medium)
    nee_med = act_real & (depth + 1 <= scene.max_depth)
    if not scene.needs_medium_nee:
        nee_med = jnp.zeros_like(nee_med)

    # ---------------- surface emission / escape ---------------------------
    active_surface = (active & ~in_medium) | escaped
    em_val, eidx = eval_emitter_hit(scene, si, st.ray_d)
    esc_env = ~si.valid
    if scene.emitters.env_index >= 0:
        eidx_mis = jnp.where(esc_env,
                             jnp.full((n,), scene.emitters.env_index,
                                      jnp.int32), eidx)
    else:
        eidx_mis = eidx
    count_direct = (st.depth == 0) | st.specular_chain
    hit_any = active_surface & ((eidx >= 0) & si.valid | esc_env)
    if scene.needs_surface_nee or scene.needs_medium_nee:
        em_pdf = pdf_emitter_direction(scene, st.prev_p, eidx_mis, si.p,
                                       si.ng, st.ray_d)
        # the emitter-pdf factor persists in p_over_f_nee (:393 is an
        # in-place update on the loop state)
        W_nee = update_weights(W_nee, em_pdf, 1.0,
                               hit_any & ~count_direct)
    hide = scene.hide_emitters & (st.depth == 0)
    gather = hit_any & ~hide & ~reached_max
    w_hit = jnp.where(count_direct[:, None], mis_weight(W),
                      mis_weight2(W, W_nee))
    L = L + jnp.where((gather & (eidx >= 0) & si.valid)[:, None],
                      w_hit * em_val, 0.0)
    env_weight = st.env_weight + jnp.where(
        (gather & esc_env)[:, None], w_hit, 0.0)

    active_surface &= si.valid & ~reached_max
    bsdf_idx = m.table_lookup(scene.shape_bsdf, jnp.maximum(si.shape, 0))

    # ---------------- NEE (shared walk: medium + surface lanes) -----------
    if scene.needs_surface_nee or scene.needs_medium_nee:
        flags = scene.bsdfs.flags[jnp.maximum(bsdf_idx, 0)]
        smooth_here = (flags & F_SMOOTH) != 0
        nee_s = active_surface & smooth_here & (depth + 1 < scene.max_depth)
        if not scene.needs_surface_nee:
            nee_s = jnp.zeros_like(nee_s)
        nee_any = nee_s | nee_med
        ref_p = jnp.where(nee_med[:, None], mei.p, si.p)
        W_nee_end, W_uni_end, emitted, ds_s, sampler = sample_emitter_mis(
            scene, ref_p, st.medium, st.channel, W, sampler, nee_any,
            scene.max_depth, bounded_nee)
        wo_local = si.to_local(ds_s.d)
        bval, bpdf = bsdf_eval_pdf(scene, si, bsdf_idx, wo_local)
        ph_val = phase_eval(ptype, g, m.dot(st.ray_d, ds_s.d), pprm,
                            st.ray_d, ds_s.d, scene.media.phase_types)
        cval = jnp.where(nee_med[:, None], ph_val[:, None], bval)
        cpdf = jnp.where(nee_med, ph_val, bpdf)
        W_nee_end = update_weights(W_nee_end, 1.0, cval, nee_any)
        W_uni_end = update_weights(
            W_uni_end, jnp.where(ds_s.delta, 0.0, cpdf), cval, nee_any)
        L = L + jnp.where(nee_any[:, None],
                          mis_weight2(W_nee_end, W_uni_end) * emitted, 0.0)

    # real scatter resets the NEE matrix to the unidirectional one (:339)
    W_nee = jnp.where(act_real[:, None, None], W, W_nee)

    # ---------------- phase sampling --------------------------------------
    u2p, sampler = sampler.next_2d()
    wo_med, _, ppdf = phase_sample(ptype, g, st.ray_d, u2p, pprm,
                                   scene.media.phase_types)
    wo_med = jax.lax.stop_gradient(wo_med)
    ppdf = jax.lax.stop_gradient(ppdf)
    pval = phase_eval(ptype, g, m.dot(st.ray_d, wo_med), pprm,
                      st.ray_d, wo_med, scene.media.phase_types)
    act_real &= ppdf > 0
    W = update_weights(W, ppdf, pval, act_real)
    W_nee = update_weights(W_nee, 1.0, pval, act_real)

    # ---------------- BSDF sampling ---------------------------------------
    ub1, sampler = sampler.next_1d()
    ub2, sampler = sampler.next_2d()
    bs = bsdf_sample(scene, si, bsdf_idx, ub1, ub2)
    wo_surf = si.to_world(bs.wo)
    surf_ok = active_surface & (bs.pdf > 0)
    non_null = surf_ok & ((bs.sampled_type & F_NULL) == 0)
    eta = jnp.where(surf_ok, st.eta * bs.eta, st.eta)
    depth = jnp.where(non_null, depth + 1, depth)
    valid = valid | non_null
    new_spec = (bs.sampled_type & F_DELTA) != 0
    smooth_lobe = ~new_spec
    specular_chain = (specular_chain | (non_null & new_spec)) \
        & ~(surf_ok & smooth_lobe)

    # f = bsdf_weight * pdf = raw bsdf value (:438)
    bsdf_f = bs.weight * bs.pdf[:, None]
    W_nee = jnp.where(non_null[:, None, None], W, W_nee)
    W = update_weights(W, bs.pdf, bsdf_f, surf_ok)
    W_nee = update_weights(W_nee, 1.0, bsdf_f, non_null)

    new_medium = jnp.where(surf_ok & _is_transition(scene, si),
                           _target_medium(scene, si, wo_surf), st.medium)

    # ---------------- assemble next ray -----------------------------------
    sr = si.spawn_ray(wo_surf)
    med_move = act_real | act_null
    next_o = jnp.where(med_move[:, None], mei.p,
                       jnp.where(surf_ok[:, None], sr.o, st.ray_o))
    next_d = jnp.where(act_real[:, None], wo_med,
                       jnp.where(surf_ok[:, None], wo_surf, st.ray_d))
    prev_p = jnp.where(act_real[:, None], mei.p,
                       jnp.where(non_null[:, None], si.p, st.prev_p))
    alive = (act_real | act_null | surf_ok) & (depth < scene.max_depth) \
        & jnp.any(mis_weight(W) != 0.0, -1)
    # null events keep the path bounded only through the iteration cap +
    # the mis_weight zero check (matches the reference's reliance on RR)

    return st.replace(
        active=alive,
        depth=depth,
        ray_o=next_o,
        ray_d=next_d,
        L=L,
        p_over_f=W,
        p_over_f_nee=W_nee,
        eta=eta,
        medium=jnp.where(med_move, st.medium, new_medium),
        prev_p=prev_p,
        last_null=last_null,
        specular_chain=specular_chain,
        valid=valid,
        env_weight=env_weight,
        sampler=sampler,
    )


def sample(scene: Scene, sampler: Sampler, ray: Ray, mode: str = "primal"):
    st = init_state(ray, sampler, scene)
    bounded = mode != "primal"
    max_iters = scene.max_depth * 4
    if mode == "primal":
        def cond(c):
            s, it = c
            return jnp.any(s.active) & (it < max_iters)

        def body(c):
            s, it = c
            return bounce(scene, s, bounded), it + 1
        st, _ = jax.lax.while_loop(cond, body, (st, 0))
    else:
        body = jax.checkpoint(lambda s: bounce(scene, s, bounded))

        def step(s, _):
            return body(s), None
        st, _ = jax.lax.scan(step, st, None, length=scene.max_depth)
    L = st.L + st.env_weight * eval_environment(scene, st.ray_d)
    return L, st.valid, st.sampler
