"""Volumetric path tracer with null scattering, NEE+MIS, and the fork's
tissueDepth-threaded bio-media transport.

One integrator covers the reference's `volpath` (src/integrators/volpath.cpp,
class renamed BioVolumetricPathIntegrator but stock logic), `volpathmis`
(single-channel spectral MIS via per-lane channel tracking), and the fork's
`biovolpath`/`biovolpath06` (tissueDepth threading + EBioType transmittance
semantics, biovolpath.cpp:95-379).  The variant is data-driven: lanes whose
medium is a bio medium follow the bio rules, others the stock null-scattering
rules — one fused wavefront kernel either way.

Reference semantics preserved:
  * per-lane RGB channel picked once (biovolpath.cpp:119-123),
  * free-flight throughput tr/tr_pdf (biovolpath.cpp:234-238),
  * null scatter weight sigma_n * maj_ch / sigma_n_ch (:248-251),
  * real scatter: stock weight sigma_s * maj_ch / sigma_t_ch; bio media
    multiply mei.transmittance (one-hot / kill, :266-274 + liver.cpp:521-534)
    and accumulate tissueDepth += |cos_z * t| (:269-273),
  * absorbed bio paths zero the per-channel accumulated result (:297-300),
  * NEE through media with ratio-tracked shadow walks (:382-541),
  * RR with eta^2-compressed throughput (:200-208).
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
from ..media.dispatch import (_index_spectrum, medium_is_bio, medium_phase,
                              sample_interaction, transmittance_eval_pdf)
from ..phase.dispatch import phase_eval, phase_sample
from ..scene.ir import (F_DELTA, F_NULL, F_SMOOTH, MEDIUM_GLISSON, Scene)
from .shading import shading_frame_with_bump

Array = jax.Array
INF = jnp.inf


@struct.dataclass
class VolpathState:
    active: Array
    depth: Array
    ray_o: Array
    ray_d: Array
    L: Array
    throughput: Array
    eta: Array
    medium: Array          # (N,) int32 current medium, -1 = vacuum
    tissue_depth: Array    # (N,) fork extension (biovolpath.cpp:129)
    channel: Array         # (N,) int32 tracked channel (RGB index, or the
    #                        hero-packet entry in the spectral variant)
    prev_p: Array
    prev_pdf: Array
    specular_chain: Array
    valid: Array
    env_weight: Array      # (N,C) deferred env contribution weight
    sampler: Sampler
    lam: Array = None      # (N,N_SPEC) hero wavelengths (spectral variant)


def _has_bio(scene: Scene) -> bool:
    """Bio (one-hot channel / absorber-kill) transport applies only when a
    bio medium is present AND the integrator is one of the bio family —
    stock volpath/volpathmis reach bio media through the base
    Medium::sample_interaction in the reference (media/dispatch.bio_mode)."""
    from ..media.dispatch import bio_mode
    from ..scene.ir import (MEDIUM_GLISSON, MEDIUM_LIVER, MEDIUM_PARENCHYMA)
    return bio_mode(scene) and any(
        t in scene.media.types_present
        for t in (MEDIUM_GLISSON, MEDIUM_PARENCHYMA, MEDIUM_LIVER))


def init_state(ray: Ray, sampler: Sampler, scene: Scene) -> VolpathState:
    n = ray.o.shape[0]
    u, sampler = sampler.next_1d()
    if scene.spectral:
        # spectral variant: a hero-wavelength packet per lane; the
        # tracked channel indexes PACKET ENTRIES — distance sampling at
        # the tracked wavelength, ratio weights per entry, and the bio
        # one-hot selects the tracked wavelength (the RGB one-hot scheme
        # is the 3-band degenerate case of this)
        from ..core import spectrum as spec
        ul, sampler = sampler.next_1d()
        lam = spec.sample_hero(ul)
        n_ch = spec.N_SPEC
        C = spec.N_SPEC
    else:
        lam = None
        n_ch = 3
        C = 3
    if sampler.samp is not None and sampler.pix is not None:
        # stratify the tracked channel over the pixel's sample
        # indices (exactly floor/ceil(spp/n_ch) samples per channel) with
        # a per-PIXEL hash rotation — removes the channel-allocation
        # variance of the one-hot bio estimator (chroma speckle on the
        # liver scenes) at identical expectation.  The dim draw stays so
        # the replay dimension budget is unchanged.
        rot = ((sampler.pix * jnp.uint32(2654435761)) >> jnp.uint32(16)) \
            .astype(jnp.int32) % n_ch
        channel = (sampler.samp.astype(jnp.int32) + rot) % n_ch
    else:
        channel = jnp.minimum((u * n_ch).astype(jnp.int32), n_ch - 1)
    return VolpathState(
        active=jnp.ones((n,), bool),
        depth=jnp.zeros((n,), jnp.int32),
        ray_o=ray.o, ray_d=ray.d,
        L=jnp.zeros((n, C)),
        throughput=jnp.ones((n, C)),
        eta=jnp.ones((n,)),
        medium=jnp.full((n,), scene.camera_medium, jnp.int32),
        tissue_depth=jnp.zeros((n,)),
        channel=channel,
        prev_p=ray.o,
        prev_pdf=jnp.ones((n,)),
        specular_chain=jnp.ones((n,), bool),
        valid=jnp.zeros((n,), bool),
        env_weight=jnp.zeros((n, C)),
        sampler=sampler,
        lam=lam,
    )


def _target_medium(scene: Scene, si, d):
    """Medium on the far side of a boundary (interaction.h target_medium):
    leaving (d . ng > 0) -> exterior, entering -> interior."""
    shape = jnp.maximum(si.shape, 0)
    outward = jnp.sum(d * si.ng, -1) > 0
    return jnp.where(outward, m.table_lookup(scene.shape_ext_medium, shape),
                     m.table_lookup(scene.shape_int_medium,
                                    shape)).astype(jnp.int32)


def _is_transition(scene: Scene, si):
    shape = jnp.maximum(si.shape, 0)
    return si.valid & ((m.table_lookup(scene.shape_int_medium, shape) >= 0)
                       | (m.table_lookup(scene.shape_ext_medium, shape) >= 0))


def _nee_is_analytic(scene: Scene) -> bool:
    """Static: shadow transmittance has a closed form when every medium is
    homogeneous and no BSDF transmits shadow rays (null/mask absent)."""
    from ..scene.ir import (BSDF_MASK, BSDF_NULL, BSDF_THINDIELECTRIC,
                            MEDIUM_HOMOGENEOUS)
    media_ok = all(t == MEDIUM_HOMOGENEOUS
                   for t in scene.media.types_present)
    bsdf_ok = not any(t in scene.bsdfs.types_present
                      for t in (BSDF_NULL, BSDF_MASK))
    return media_ok and bsdf_ok


def sample_emitter_attenuated(scene: Scene, ref_p, medium, channel,
                              tissue_depth, sampler, active, max_steps: int,
                              bounded: bool, lam=None):
    """NEE with transmittance estimation along the shadow path through media
    and null surfaces (biovolpath.cpp:382-541 sample_emitter).

    Fast path: homogeneous-only scenes use the analytic Beer-Lambert
    transmittance + a single occlusion test instead of a ratio-tracked walk
    (the reference always walks; the walk's gather-heavy loop is worth
    skipping whenever the closed form exists)."""
    from ..media.dispatch import _lift
    u2, sampler = sampler.next_2d()
    u1, sampler = sampler.next_1d()
    ds, em_weight = sample_emitter_direction(scene, ref_p, u2, u1)
    n = ref_p.shape[0]
    C = 3 if lam is None else lam.shape[-1]
    active = active & (ds.pdf > 0)
    if lam is not None:
        from ..core import spectrum as _spec
        em_weight = _spec.smits_upsample_illum(em_weight, lam)

    if _nee_is_analytic(scene):
        eps = (1.0 + jnp.max(jnp.abs(ref_p), -1)) * 1e-4
        o0 = ref_p + ds.d * eps[:, None]
        dist = ds.dist * (1.0 - 1e-3) - eps
        from ..accel.intersect import ray_test
        occ = ray_test(scene, Ray(o=o0, d=ds.d, maxt=dist))
        midx = jnp.maximum(medium, 0)
        prm = scene.media.params[midx]
        sig = _lift(prm[:, 0:3] * prm[:, 6:7], lam)
        in_med = (medium >= 0)[:, None]
        # env emitters have dist=inf: exp(-inf*sig) is 0 but its sigma
        # derivative is nan (0*inf); sanitize so the limit (0, grad 0) holds
        finite = jnp.isfinite(dist)
        dist_f = jnp.where(finite, dist, 0.0)[:, None]
        beer = jnp.where(finite[:, None], jnp.exp(-dist_f * sig), 0.0)
        tr = jnp.where(in_med, beer, 1.0)
        tr = jnp.where((active & ~occ)[:, None], tr, 0.0)
        return ds, em_weight * tr, sampler

    eps = (1.0 + jnp.max(jnp.abs(ref_p), -1)) * 1e-4
    o0 = ref_p + ds.d * eps[:, None]

    st = dict(
        active=active,
        o=o0,
        remaining=ds.dist * (1.0 - 1e-3) - eps,
        medium=medium,
        tr=jnp.ones((n, C)),
        sampler=sampler,
    )

    def body(st):
        active = st["active"] & (st["remaining"] > 0)
        ray = Ray(o=st["o"], d=ds.d, maxt=st["remaining"])
        si = ray_intersect(scene, ray)
        surf_t = jnp.minimum(si.t, st["remaining"])

        in_med = active & (st["medium"] >= 0)
        mei, sampler = sample_interaction(
            scene, st["medium"], st["o"], ds.d, surf_t, st["sampler"],
            channel, tissue_depth, in_med, lam=lam)
        tr_a, ffpdf = transmittance_eval_pdf(scene, st["medium"], mei, surf_t)
        tr_pdf = _index_spectrum(ffpdf, channel)
        # sampling densities are detached (PRB rule); without stop_gradient
        # the 1/max(x,1e-30)^2 backward Jacobian overflows fp32 to inf and
        # 0-cotangent masked lanes turn it into nan
        ratio = jnp.where(
            (tr_pdf > 0)[:, None],
            tr_a / jax.lax.stop_gradient(
                jnp.maximum(tr_pdf, 1e-30))[:, None], 0.0)
        tr = jnp.where(in_med[:, None], st["tr"] * ratio, st["tr"])

        scattered = in_med & mei.valid
        is_bio = medium_is_bio(scene, st["medium"])
        # stock media: ratio-track through the (null) collision
        maj_c = _index_spectrum(mei.combined_extinction, channel)
        sn_c = _index_spectrum(mei.sigma_n, channel)
        w_null = mei.sigma_n * jax.lax.stop_gradient(
            maj_c / jnp.maximum(sn_c, 1e-30))[:, None]
        w_evt = jnp.where(is_bio[:, None], mei.transmittance, w_null)
        tr = jnp.where(scattered[:, None], tr * w_evt, tr)

        # surface handling for lanes that reached the surface first
        hit_surface = active & ~scattered & si.valid & (si.t < st["remaining"])
        null_tr = eval_null_transmission(
            scene, si, m.table_lookup(scene.shape_bsdf,
                                      jnp.maximum(si.shape, 0)))
        null_tr = _lift(null_tr, lam)
        tr = jnp.where(hit_surface[:, None], tr * null_tr, tr)

        # advance — only lanes that keep walking move; escaped/dead lanes
        # must not step by remaining (inf for env emitters: 0*inf -> nan
        # origins whose intersections poison masked-lane gradients)
        step = jnp.where(scattered, mei.t,
                         jnp.where(hit_surface, si.t + 2e-4, 0.0))
        o = st["o"] + ds.d * step[:, None]
        remaining = st["remaining"] - step
        done = active & ~scattered & ~hit_surface   # escaped to the emitter
        medium2 = jnp.where(
            hit_surface & _is_transition(scene, si),
            _target_medium(scene, si, ds.d), st["medium"])
        # tr cutoff: a shadow walk whose transmittance fell below any
        # visible contribution must terminate — without it a grazing lane
        # (step ~ 2e-4, remaining = inf toward an env emitter) can cycle
        # the while_loop without end and hang the device
        alive = (scattered | hit_surface) & (remaining > 0) \
            & (jnp.max(tr, -1) > 1e-6) & active
        return dict(active=alive, o=o, remaining=remaining, medium=medium2,
                    tr=tr, sampler=sampler)

    # The walk consumes a FIXED per-lane dimension budget regardless of how
    # many collective while_loop iterations run: otherwise the iteration
    # count (a batch-collective property) would shift every lane's
    # subsequent RNG stream, making results depend on wavefront batching.
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

    tr = jnp.where(active[:, None], st["tr"], 0.0)
    return ds, em_weight * tr, sampler_out


def bounce(scene: Scene, st: VolpathState, bounded_nee: bool) -> VolpathState:
    n = st.ray_o.shape[0]
    sampler = st.sampler
    active = st.active

    if scene.spectral:
        # spectral variant: RGB radiometric inputs lifted to the lane's
        # hero-wavelength packet (reflectances by the Smits basis,
        # radiances D65-referenced per srgb_d65 — same scheme as the
        # surface family, path.py)
        from ..core import spectrum as _spec

        def refl(v):
            return _spec.smits_upsample(v, st.lam)

        def illum(v):
            return _spec.smits_upsample_illum(v, st.lam)
    else:
        def refl(v):
            return v
        illum = refl

    in_medium = active & (st.medium >= 0)
    throughput = st.throughput
    L = st.L
    tissue_depth = st.tissue_depth
    depth = st.depth

    # ================= medium sampling (candidate first) =================
    # The tentative collision distance bounds the surface query: the
    # intersect kernel's chunk culling then skips geometry beyond it
    # (most chunks, for dense media with short free paths).
    from ..media.dispatch import (finalize_interaction,
                                  sample_interaction_candidate)
    cand, sampler = sample_interaction_candidate(
        scene, st.medium, st.ray_o, st.ray_d, sampler, st.channel,
        tissue_depth, in_medium, lam=st.lam)
    ray_maxt = jnp.where(in_medium & jnp.isfinite(cand["dist"]),
                         cand["dist"], INF)
    ray = Ray(o=st.ray_o, d=st.ray_d, maxt=ray_maxt)
    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)

    mei = finalize_interaction(cand, si.t, st.channel, in_medium)
    tr_a, ffpdf = transmittance_eval_pdf(scene, st.medium, mei, si.t)
    tr_pdf = _index_spectrum(ffpdf, st.channel)
    tr_pdf_det = jax.lax.stop_gradient(jnp.maximum(tr_pdf, 1e-30))
    ratio = jnp.where((tr_pdf > 0)[:, None],
                      tr_a / tr_pdf_det[:, None], 0.0)
    throughput = jnp.where(in_medium[:, None], throughput * ratio, throughput)
    if _has_bio(scene):
        # bio media: score-function gradient of the free-flight event
        # (value 1 forward; d/d sigma = d log p — media/dispatch.py log_p)
        score = jnp.exp(mei.log_p - jax.lax.stop_gradient(mei.log_p))
        throughput = jnp.where(in_medium[:, None],
                               throughput * score[:, None], throughput)

    escaped = in_medium & ~mei.valid
    act_medium = in_medium & mei.valid

    # null vs real split (biovolpath.cpp:244-251)
    u_nr, sampler = sampler.next_1d()
    st_c = _index_spectrum(mei.sigma_t, st.channel)
    maj_c = _index_spectrum(mei.combined_extinction, st.channel)
    null_scatter = u_nr >= st_c / jnp.maximum(maj_c, 1e-30)
    act_null = act_medium & null_scatter
    act_real = act_medium & ~null_scatter

    sn_c = _index_spectrum(mei.sigma_n, st.channel)
    w_null = mei.sigma_n * jax.lax.stop_gradient(
        maj_c / jnp.maximum(sn_c, 1e-30))[:, None]
    throughput = jnp.where(act_null[:, None], throughput * w_null, throughput)

    depth = jnp.where(act_real, depth + 1, depth)
    reached_max = depth >= scene.max_depth
    act_real &= ~reached_max

    is_bio = medium_is_bio(scene, st.medium) & in_medium
    has_bio = _has_bio(scene)

    # real scatter weights
    w_real_stock = mei.sigma_s * jax.lax.stop_gradient(
        maj_c / jnp.maximum(st_c, 1e-30))[:, None]
    if has_bio:
        w_real = jnp.where(is_bio[:, None], mei.transmittance, w_real_stock)
        if scene.integrator == "biovolpath":
            # per-channel erase of the accumulated result where the event
            # transmittance is zero (biovolpath.cpp:298 spectral mask);
            # biovolpath06 has the same statement DISABLED by `&& false`
            # (biovolpath06.cpp:200), so 06 keeps pre-medium contributions
            kill = in_medium[:, None] & (mei.transmittance == 0.0)
            L = jnp.where(kill, 0.0, L)
        tissue_depth = jnp.where(
            act_real & is_bio,
            tissue_depth + jnp.abs(st.ray_d[:, 2] * mei.t), tissue_depth)
    else:
        w_real = w_real_stock
    throughput = jnp.where(act_real[:, None], throughput * w_real, throughput)

    ptype, g, pprm = medium_phase(scene, st.medium)
    nee_med = act_real & ~is_bio & (depth + 1 < scene.max_depth)
    if not scene.needs_medium_nee:
        nee_med = jnp.zeros_like(nee_med)  # biovolpath / no stock media

    # ---------------- phase sampling ----------------
    # Detached sampling (PRB): the sampled direction carries no derivative;
    # the phase parameter gradient re-enters through the value/pdf ratio
    # (prbvolpath.py detached phase handling).  Without the detach, d(wo)/dg
    # reaches downstream intersection Jacobians and reverse-mode NaNs.
    throughput_pre_phase = throughput
    u2p, sampler = sampler.next_2d()
    wo_med, _, ppdf = phase_sample(ptype, g, st.ray_d, u2p, pprm,
                                   scene.media.phase_types)
    wo_med = jax.lax.stop_gradient(wo_med)
    ppdf = jax.lax.stop_gradient(ppdf)
    pval = phase_eval(ptype, g, m.dot(st.ray_d, wo_med), pprm,
                      st.ray_d, wo_med, scene.media.phase_types)
    pw = pval / jnp.maximum(ppdf, 1e-20)
    act_real &= ppdf > 0
    throughput = jnp.where(act_real[:, None], throughput * pw[:, None],
                           throughput)

    # ================= surface interactions =================
    active_surface = (active & ~in_medium) | escaped
    bsdf_idx = m.table_lookup(scene.shape_bsdf, jnp.maximum(si.shape, 0))

    # emission gathered along the current ray.  Env radiance is NOT
    # evaluated here: escaping ends the path, so the (expensive, bilinear
    # envmap lookup) evaluation is deferred to a single post-loop pass —
    # the bounce only records the throughput-MIS weight (env_weight).
    em_val, eidx = eval_emitter_hit(scene, si, st.ray_d)
    esc_env = ~si.valid
    if scene.emitters.env_index >= 0:
        eidx_mis = jnp.where(esc_env,
                             jnp.full((n,), scene.emitters.env_index,
                                      jnp.int32), eidx)
    else:
        eidx_mis = eidx
    count_direct = (st.depth == 0) | st.specular_chain
    if scene.needs_surface_nee or scene.needs_medium_nee:
        em_pdf = pdf_emitter_direction(scene, st.prev_p, eidx_mis, si.p,
                                       si.ng, st.ray_d)
        em_pdf = jnp.where(count_direct, 0.0, em_pdf)
    else:
        em_pdf = jnp.zeros((n,))  # no NEE anywhere: BSDF sampling owns MIS
    mis_b = m.mis_weight(st.prev_pdf, em_pdf)
    contrib = jnp.where(((eidx >= 0) & si.valid)[:, None], illum(em_val),
                        0.0)
    hide = scene.hide_emitters & (st.depth == 0)
    gather = active_surface & ~hide & ~reached_max
    L = L + jnp.where(gather[:, None],
                      throughput * contrib * mis_b[:, None], 0.0)
    env_weight = st.env_weight + jnp.where(
        (gather & esc_env)[:, None], throughput * mis_b[:, None], 0.0)

    active_surface &= si.valid & ~reached_max
    valid = st.valid | active_surface | act_real

    # ---------------- NEE (one shared attenuated walk for medium-scatter
    # and surface lanes — they are mutually exclusive per lane).  Elided
    # entirely at trace time when statically unreachable (delta-only
    # surfaces + bio media: the liver scenes) — the walk costs ~40% of a
    # bounce even fully masked. ------------------------------------------
    if scene.needs_surface_nee or scene.needs_medium_nee:
        flags = scene.bsdfs.flags[jnp.maximum(bsdf_idx, 0)]
        smooth_here = (flags & F_SMOOTH) != 0
        nee_s = active_surface & smooth_here & (depth + 1 < scene.max_depth)
        if not scene.needs_surface_nee:
            nee_s = jnp.zeros_like(nee_s)
        nee_any = nee_s | nee_med
        ref_p = jnp.where(nee_med[:, None], mei.p, si.p)
        ds_s, emw_s, sampler = sample_emitter_attenuated(
            scene, ref_p, st.medium, st.channel, tissue_depth, sampler,
            nee_any, scene.max_depth, bounded_nee, lam=st.lam)
        wo_local = si.to_local(ds_s.d)
        bval, bpdf = bsdf_eval_pdf(scene, si, bsdf_idx, wo_local)
        ph_val = phase_eval(ptype, g, m.dot(st.ray_d, ds_s.d), pprm,
                            st.ray_d, ds_s.d, scene.media.phase_types)
        cpdf = jnp.where(nee_med, ph_val, bpdf)
        cval = jnp.where(nee_med[:, None], ph_val[:, None], refl(bval))
        mis_e = m.mis_weight(ds_s.pdf, jnp.where(ds_s.delta, 0.0, cpdf))
        tp_nee = jnp.where(nee_med[:, None], throughput_pre_phase,
                           throughput)
        L = L + jnp.where(nee_any[:, None],
                          tp_nee * cval * emw_s * mis_e[:, None], 0.0)

    # ---------------- BSDF sampling ----------------
    ub1, sampler = sampler.next_1d()
    ub2, sampler = sampler.next_2d()
    bs = bsdf_sample(scene, si, bsdf_idx, ub1, ub2)
    wo_surf = si.to_world(bs.wo)
    surf_ok = active_surface & (bs.pdf > 0)
    non_null = surf_ok & ((bs.sampled_type & F_NULL) == 0)
    throughput = jnp.where(surf_ok[:, None], throughput * refl(bs.weight),
                           throughput)
    eta = jnp.where(surf_ok, st.eta * bs.eta, st.eta)
    depth = jnp.where(non_null, depth + 1, depth)
    new_spec = (bs.sampled_type & F_DELTA) != 0

    # medium transition across the boundary
    new_medium = jnp.where(surf_ok & _is_transition(scene, si),
                           _target_medium(scene, si, wo_surf), st.medium)

    # ---------------- assemble next ray ----------------
    sr = si.spawn_ray(wo_surf)
    next_o = jnp.where(act_real[:, None], mei.p,
                       jnp.where(act_null[:, None], mei.p,
                                 jnp.where(surf_ok[:, None], sr.o, st.ray_o)))
    next_d = jnp.where(act_real[:, None], wo_med,
                       jnp.where(surf_ok[:, None], wo_surf, st.ray_d))

    prev_p = jnp.where(act_real[:, None], mei.p,
                       jnp.where(non_null[:, None], si.p, st.prev_p))
    prev_pdf = jnp.where(act_real, ppdf,
                         jnp.where(non_null, bs.pdf, st.prev_pdf))
    specular_chain = jnp.where(act_real, False,
                               jnp.where(non_null, new_spec,
                                         st.specular_chain))
    # null bsdf / null collision keep the specular chain flag
    alive = (act_real | act_null | surf_ok) \
        & jnp.any(throughput != 0.0, -1) & (depth < scene.max_depth)

    # ---------------- RR ----------------
    urr, sampler = sampler.next_1d()
    q = jnp.minimum(jnp.max(throughput, -1) * eta * eta, 0.95)
    perform_rr = depth > scene.rr_depth
    rr_keep = (urr < q) | ~perform_rr
    throughput = jnp.where(
        perform_rr[:, None],
        throughput / jnp.maximum(jax.lax.stop_gradient(q), 1e-8)[:, None],
        throughput)
    alive &= rr_keep

    return st.replace(
        active=alive,
        depth=depth,
        ray_o=next_o,
        ray_d=next_d,
        L=L,
        throughput=throughput,
        eta=eta,
        medium=jnp.where(act_real | act_null, st.medium, new_medium),
        tissue_depth=tissue_depth,
        prev_p=prev_p,
        prev_pdf=prev_pdf,
        specular_chain=specular_chain,
        valid=valid,
        env_weight=env_weight,
        sampler=sampler,
    )


def sample(scene: Scene, sampler: Sampler, ray: Ray, mode: str = "primal"):
    st = init_state(ray, sampler, scene)
    bounded = mode != "primal"
    # null collisions / null bsdfs don't increment depth, so cap total
    # iterations at a multiple of max_depth (the reference relies on RR).
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
    # deferred environment contribution (one lookup per path, not per bounce)
    env = eval_environment(scene, st.ray_d)
    if scene.spectral:
        from ..core import spectrum as spec
        env = spec.smits_upsample_illum(env, st.lam)
        return spec.spec_to_rgb_estimate(st.L + st.env_weight * env,
                                         st.lam), st.valid, st.sampler
    L = st.L + st.env_weight * env
    return L, st.valid, st.sampler
