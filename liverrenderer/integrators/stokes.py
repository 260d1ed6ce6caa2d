"""Polarized transport: the `stokes` integrator (reference
src/integrators/stokes.cpp + the polarized variants' Mueller-valued
Spectrum throughput).

Wavefront redesign: instead of templating the whole renderer on a polarized
Spectrum type, this dedicated wavefront loop carries a per-lane Mueller
throughput T (N, 3, 4, 4) alongside the scalar path state.  Directions are
sampled by the *scalar* BSDF dispatch (identical pdf), then the sampled
event's polarization transfer is applied as a normalized Mueller matrix
(M00 = 1) times the scalar weight — S0 therefore matches the unpolarized
renderer exactly, and S1..S3 carry the polarization state.

Estimator: path tracing with NEE + MIS (mirroring integrators/path.py's
balance-heuristic structure): emitter hits are weighted against the
emitter-sampling pdf, and each smooth vertex adds a light connection
whose polarization transfer (the same _event_mueller as the sampled
event, with the connection direction) is applied to the unpolarized
emitter Stokes vector.  Stokes vectors are expressed in the canonical
basis of each ray (core/mueller.py stokes_basis) with light travelling
along -ray.d; the film output is in the primary ray's canonical basis.

Polarizing events: smooth/rough conductor + smooth dielectric reflection
(s/p Fresnel Mueller, mueller.h specular_reflection), linear polarizer /
retarder / circular elements (axis from the shading frame rotated by
theta).  Everything else depolarizes (diffuse, plastic substrate, media
are out of scope here — reference behavior for pbasic variants).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..accel.intersect import ray_intersect, ray_test
from ..bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
from ..core import math as m
from ..core import mueller as mu
from ..core.rng import Sampler, make_sampler
from ..core.types import Ray
from ..scene.ir import (BSDF_CIRCULAR, BSDF_CONDUCTOR, BSDF_DIELECTRIC,
                        BSDF_POLARIZER, BSDF_RETARDER, BSDF_ROUGHCONDUCTOR,
                        F_DELTA, F_DELTA_REFL, F_GLOSSY_REFL, F_SMOOTH,
                        Scene)
from ..emitter.dispatch import (eval_emitter_hit, eval_environment,
                                pdf_emitter_direction,
                                sample_emitter_direction)
from ..sensor.perspective import sample_ray
from .shading import shading_frame_with_bump

Array = jax.Array


@struct.dataclass
class PolState:
    active: Array      # (N,)
    depth: Array
    ray_o: Array
    ray_d: Array
    S: Array           # (N, C, 4) accumulated camera Stokes per channel
    T: Array           # (N, C, 4, 4) Mueller path throughput
    prev_p: Array      # (N, 3) previous vertex (emitter-pdf reference)
    prev_pdf: Array    # (N,) bsdf pdf of the ray that produced this hit
    prev_smooth: Array  # (N,) last event was non-delta (MIS-countable)
    sampler: Sampler
    lam: Array = None  # (N, N_SPEC) hero wavelengths (spectral x polarized
    #                    variant — C = N_SPEC instead of 3 RGB channels)


def _event_mueller(scene: Scene, si, refl, d_in_light, d_out_light,
                   basis_in, basis_out, lam=None):
    """Normalized (M00=1) Mueller matrix of a scattering event (sampled
    OR a NEE connection), expressed from the canonical basis of the
    incoming light ray to the canonical basis of the outgoing
    (camera-side) ray.  `refl` marks lanes whose event is a reflection
    (Fresnel polarization applies); everything else depolarizes.

    lam: hero wavelengths (spectral x polarized variant) — the channel
    axis becomes the wavelength packet; conductor eta/k RGB rows are
    lifted to the packet by the Smits basis (a smooth interpolant — the
    reference's polarized-spectral variants read tabulated metal IORs
    that do not ship, so this is the documented substitution)."""
    n = d_in_light.shape[0]
    C = 3 if lam is None else lam.shape[-1]
    bidx = jnp.maximum(m.table_lookup(scene.shape_bsdf,
                                      jnp.maximum(si.shape, 0)), 0)
    btype = m.table_lookup(scene.bsdfs.btype, bidx)
    prm = m.table_lookup(scene.bsdfs.params, bidx)
    # default: depolarizer (diffuse & friends) — basis-independent
    M = jnp.broadcast_to(mu.depolarizer(1.0), (n, C, 4, 4))

    types = set(scene.bsdfs.types_present)

    # --- specular / rough Fresnel reflection (conductor, dielectric R) ----
    fresnel_types = types & {BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR,
                             BSDF_DIELECTRIC}
    if fresnel_types:
        # plane of incidence from the half vector (= microfacet normal)
        h = m.normalize(d_out_light - d_in_light)      # both light dirs
        ci = jnp.abs(jnp.sum(d_in_light * h, -1))
        s_axis = jnp.cross(d_in_light, h)
        sl = m.norm(s_axis)
        # near-normal incidence: plane undefined -> any axis, no phase diff
        s_axis = jnp.where((sl > 1e-6)[:, None],
                           s_axis / jnp.maximum(sl, 1e-6)[:, None],
                           basis_in)
        is_cond = (btype == BSDF_CONDUCTOR) | (btype == BSDF_ROUGHCONDUCTOR)
        eta_re = jnp.where(is_cond[:, None], prm[:, 0:3],
                           prm[:, 0:1])       # dielectric: real eta
        eta_im = jnp.where(is_cond[:, None], prm[:, 3:6], 0.0)
        if lam is not None:
            from ..core import spectrum as _spec
            eta_re = _spec.smits_upsample(eta_re, lam)
            eta_im = _spec.smits_upsample(eta_im, lam)
        # per-channel Mueller; normalize by the unpolarized reflectance
        Ms = []
        for c in range(C):
            Mc = mu.specular_reflection_fresnel(ci, eta_re[:, c],
                                                eta_im[:, c])
            Mc = Mc / jnp.maximum(Mc[:, 0:1, 0:1], 1e-12)
            Ms.append(Mc)
        M_sp = jnp.stack(Ms, 1)                        # (N,C,4,4)
        R_in = mu.rotator(mu.rotation_angle(d_in_light, basis_in, s_axis))
        R_out = mu.rotator(mu.rotation_angle(d_out_light, s_axis, basis_out))
        M_f = jnp.einsum("nij,ncjk,nkl->ncil", R_out, M_sp, R_in)
        sel = jnp.zeros(n, bool)
        for ftype in fresnel_types:
            sel = sel | (btype == ftype)
        # dielectric transmission keeps the scalar weight but depolarizes
        # (refraction phase out of scope round 1)
        sel = sel & refl
        M = jnp.where(sel[:, None, None, None], M_f, M)

    # --- polarizer / retarder / circular elements -------------------------
    elem_types = types & {BSDF_POLARIZER, BSDF_RETARDER, BSDF_CIRCULAR}
    if elem_types:
        theta = prm[:, 0]
        # transmission axis: shading-frame s rotated by theta about n,
        # projected perpendicular to the (straight) ray
        ax = si.sh_frame.s * jnp.cos(theta)[:, None] \
            + si.sh_frame.t * jnp.sin(theta)[:, None]
        ax = ax - jnp.sum(ax * d_in_light, -1, keepdims=True) * d_in_light
        axl = m.norm(ax)
        ax = jnp.where((axl > 1e-6)[:, None],
                       ax / jnp.maximum(axl, 1e-6)[:, None], basis_in)
        M_pol = mu.linear_polarizer(1.0) * 2.0          # M00 = 1
        M_ret = mu.linear_retarder(prm[:, 1])
        left = prm[:, 2] > 0.5
        M_cir = jnp.where(left[:, None, None],
                          mu.circular_polarizer(True) * 2.0,
                          mu.circular_polarizer(False) * 2.0)
        M_el = jnp.broadcast_to(jnp.eye(4), (n, 4, 4))
        if BSDF_POLARIZER in elem_types:
            M_el = jnp.where((btype == BSDF_POLARIZER)[:, None, None],
                             jnp.broadcast_to(M_pol, (n, 4, 4)), M_el)
        if BSDF_RETARDER in elem_types:
            M_el = jnp.where((btype == BSDF_RETARDER)[:, None, None],
                             M_ret, M_el)
        if BSDF_CIRCULAR in elem_types:
            M_el = jnp.where((btype == BSDF_CIRCULAR)[:, None, None],
                             M_cir, M_el)
        M_el = mu.rotate_mueller_basis(M_el, d_in_light, basis_in, ax,
                                       d_out_light, basis_out, ax)
        sel = jnp.zeros(n, bool)
        for ftype in elem_types:
            sel = sel | (btype == ftype)
        M = jnp.where(sel[:, None, None, None], M_el[:, None], M)

    return M


def bounce(scene: Scene, st: PolState) -> PolState:
    n = st.ray_o.shape[0]
    active = st.active
    ray = Ray(o=st.ray_o, d=st.ray_d, maxt=jnp.full((n,), jnp.inf))
    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)
    bidx = m.table_lookup(scene.shape_bsdf, jnp.maximum(si.shape, 0))

    if scene.spectral:
        # spectral x polarized: RGB radiometric inputs lifted to the
        # lane's wavelength packet (same scheme as path.py)
        from ..core import spectrum as _spec

        def refl(v):
            return _spec.smits_upsample(v, st.lam)

        def illum(v):
            return _spec.smits_upsample_illum(v, st.lam)
    else:
        def refl(v):
            return v
        illum = refl

    # ------- emission gathered along the bsdf ray, MIS-weighted ----------
    # (unpolarized sources: S += T[..., :, 0] * Le * mis)
    em_val, eidx = eval_emitter_hit(scene, si, ray.d)
    env_val = eval_environment(scene, ray.d)
    em_val, env_val = illum(em_val), illum(env_val)
    escaped = ~si.valid
    if scene.emitters.env_index >= 0:
        eidx_mis = jnp.where(escaped,
                             jnp.full((n,), scene.emitters.env_index,
                                      jnp.int32), eidx)
    else:
        eidx_mis = eidx
    count_direct = (st.depth == 0) | ~st.prev_smooth
    em_pdf = pdf_emitter_direction(scene, st.prev_p, eidx_mis, si.p,
                                   si.ng, ray.d)
    em_pdf = jnp.where(count_direct, 0.0, em_pdf)
    mis_bsdf = m.mis_weight(st.prev_pdf, em_pdf)
    contrib = jnp.where(((eidx >= 0) & si.valid)[:, None], em_val, 0.0) \
        + jnp.where(escaped[:, None], env_val, 0.0)
    S = st.S + jnp.where(active[:, None, None],
                         st.T[..., :, 0]
                         * (contrib * mis_bsdf[:, None])[:, :, None], 0.0)

    active_next = active & si.valid & (st.depth + 1 < scene.max_depth)
    d_out_light = -ray.d              # light leaves toward the camera
    basis_out = mu.stokes_basis(d_out_light)

    # ------- polarized NEE (stokes.cpp nested integrator does NEE via
    # its wrapped path tracer; here the connection's polarization
    # transfer is applied to the unpolarized emitter Stokes) -------------
    flags = m.table_lookup(scene.bsdfs.flags, jnp.maximum(bidx, 0))
    active_e = active_next & ((flags & F_SMOOTH) != 0)
    u2, sampler = st.sampler.next_2d()
    u1, sampler = sampler.next_1d()
    ds, em_weight = sample_emitter_direction(scene, si.p, u2, u1)
    nee_valid = active_e & (ds.pdf > 0)
    sray = si.spawn_ray_to(ds.p)
    occluded = ray_test(scene, Ray(o=sray.o, d=sray.d, maxt=sray.maxt))
    nee_valid &= ~occluded
    wo_local = si.to_local(ds.d)
    bval, bpdf = bsdf_eval_pdf(scene, si, bidx, wo_local)
    mis_em = m.mis_weight(ds.pdf, jnp.where(ds.delta, 0.0, bpdf))
    refl_nee = m.cos_theta(wo_local) * m.cos_theta(si.wi) > 0
    d_in_nee = -ds.d                  # light travels emitter -> surface
    M_nee = _event_mueller(scene, si, refl_nee, d_in_nee, d_out_light,
                           mu.stokes_basis(d_in_nee), basis_out,
                           lam=st.lam)
    T_nee = jnp.einsum("ncij,ncjk->ncik", st.T, M_nee)
    c_nee = refl(bval) * illum(em_weight) * mis_em[:, None]
    S = S + jnp.where(nee_valid[:, None, None],
                      T_nee[..., :, 0] * c_nee[:, :, None], 0.0)

    # ------- BSDF sampling ----------------------------------------------
    ub1, sampler = sampler.next_1d()
    ub2, sampler = sampler.next_2d()
    bs = bsdf_sample(scene, si, bidx, ub1, ub2)
    wo_world = si.to_world(bs.wo)
    new_ray = si.spawn_ray(wo_world)
    alive = active_next & (bs.pdf > 0) & jnp.any(bs.weight != 0.0, -1)

    d_in_light = -wo_world            # light arrives along the new ray
    basis_in = mu.stokes_basis(d_in_light)
    refl_bs = (bs.sampled_type & (F_DELTA_REFL | F_GLOSSY_REFL)) != 0
    M = _event_mueller(scene, si, refl_bs, d_in_light, d_out_light,
                       basis_in, basis_out, lam=st.lam)
    T = jnp.einsum("ncij,ncjk->ncik", st.T, M) \
        * refl(bs.weight)[:, :, None, None]

    return st.replace(
        active=alive,
        depth=st.depth + 1,
        ray_o=jnp.where(alive[:, None], new_ray.o, st.ray_o),
        ray_d=jnp.where(alive[:, None], new_ray.d, st.ray_d),
        S=S,
        T=jnp.where(alive[:, None, None, None], T, st.T),
        prev_p=jnp.where(alive[:, None], si.p, st.prev_p),
        prev_pdf=jnp.where(alive, bs.pdf, st.prev_pdf),
        prev_smooth=jnp.where(alive, (bs.sampled_type & F_DELTA) == 0,
                              st.prev_smooth),
        sampler=sampler,
    )


def sample_stokes(scene: Scene, sampler: Sampler, ray: Ray):
    """Per-lane Stokes estimate (N, 3, 4).  In the spectral x polarized
    variant the loop carries an (N, N_SPEC, 4) wavelength-packet Stokes
    state and converts each component to RGB at the end (CIE estimate),
    so callers always receive 3 channels."""
    n = ray.o.shape[0]
    if scene.spectral:
        from ..core import spectrum as spec
        ul, sampler = sampler.next_1d()
        lam = spec.sample_hero(ul)
        C = spec.N_SPEC
    else:
        lam = None
        C = 3
    st = PolState(
        active=jnp.ones((n,), bool),
        depth=jnp.zeros((n,), jnp.int32),
        ray_o=ray.o, ray_d=ray.d,
        S=jnp.zeros((n, C, 4)),
        T=jnp.broadcast_to(jnp.eye(4), (n, C, 4, 4)),
        prev_p=ray.o,
        prev_pdf=jnp.ones((n,)),
        prev_smooth=jnp.zeros((n,), bool),
        sampler=sampler,
        lam=lam,
    )
    st = jax.lax.while_loop(
        lambda s: jnp.any(s.active) & jnp.all(s.depth < scene.max_depth),
        lambda s: bounce(scene, s), st)
    S = st.S
    if scene.spectral:
        from ..core import spectrum as spec
        # CIE-convert each Stokes component (linear, so negatives in
        # S1..S3 are preserved)
        S = jnp.stack([spec.spec_to_rgb_estimate(S[:, :, k], st.lam)
                       for k in range(4)], -1)          # (N, 3, 4)
    return S, st.sampler


def render_stokes(scene: Scene, spp: int = 16, seed: int = 0):
    """Render the full Stokes vector: (h, w, 4, 3) float array
    (stokes.cpp AOV output S0..S3 per RGB channel)."""
    import numpy as np

    @jax.jit
    def run(scene, seed):
        w, h = scene.film_w, scene.film_h
        lanes = jnp.arange(w * h * spp, dtype=jnp.uint32)
        pix = lanes // spp
        samp = lanes % spp
        sampler = make_sampler(pix, samp, seed, kind=scene.sampler_kind,
                               spp=spp)
        px = (pix % w).astype(jnp.float32)
        py = (pix // w).astype(jnp.float32)
        uf, sampler = sampler.next_2d()
        pos = jnp.stack([px, py], -1) + uf
        ray = sample_ray(scene, pos)
        S, _ = sample_stokes(scene, sampler, ray)
        S = jnp.where(jnp.isfinite(S), S, 0.0)
        img = S.reshape(h, w, spp, 3, 4).mean(2)       # (h, w, 3, 4)
        return img.transpose(0, 1, 3, 2)               # (h, w, 4, 3)

    return np.asarray(run(scene, jnp.uint32(seed)))
