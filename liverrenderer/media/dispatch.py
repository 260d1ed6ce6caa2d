"""Participating-media sampling over the wavefront.

Functional re-derivation of the reference medium plugins:
  * homogeneous   — closed-form free flight (medium.cpp:42-82 base impl)
  * heterogeneous — majorant sampling; null/real split happens in the
                    integrator (heterogeneous.cpp:163-194 semantics)
  * glissonCapsule / parenchyma / liver — the fork's layered bio media
    (glissonCapsule.cpp:229-308, parenchyma.cpp, liver.cpp:227-539):
    competing-exponential element sampling with EBioType absorb/attenuate
    rules, selected by the `tissue_depth` carried in the integrator state.

Everything is one masked select over `scene.media.types_present` — no
virtual calls, one fused kernel.

Design deviations from the reference (documented intentionally):
  * The reference draws bio-media randoms from a per-lane PCG32 seeded by
    bit-reinterpreting the 1D sample (liver.cpp:233-235); we draw the needed
    uniforms from the lane's counter-based sampler directly — same
    distribution, replayable for PRB.
  * liver.cpp:246-250 selects the glisson layer with overlapping masked
    assignments whose *last* write wins, collapsing all depths <= layer4Limit
    into layer 3; the intent (per the layer-limit parameters) is binning by
    depth, which we implement: layer = #limits below tissue_depth.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.types import MediumInteraction, INF
from ..scene.ir import (MEDIUM_GLISSON, MEDIUM_HETEROGENEOUS,
                        MEDIUM_HOMOGENEOUS, MEDIUM_LIVER, MEDIUM_PARENCHYMA,
                        Scene)

# EBioType codes (reference src/media/organic_material.h:30-58)
BIO_ATTENUATOR = 0
BIO_ABSORBER = 1
BIO_ABSORBER_AND_ATTENUATOR = 2
HEPATOCYTE_MEAN_DIAMETER = 0.0025  # liver.cpp:515


def _index_spectrum(spec, channel):
    """spec: (N,C), channel: (N,) -> (N,). (biovolpath.cpp:84-93)

    Branchless select, NOT take_along_axis: a short select chain fuses
    into the bounce instead of a per-lane dynamic gather.  C = 3 (RGB) or
    N_SPEC (spectral variant: the tracked channel
    indexes the lane's hero-wavelength packet)."""
    ch = channel.astype(jnp.int32)
    out = spec[..., 0]
    for c in range(1, spec.shape[-1]):
        out = jnp.where(ch == c, spec[..., c], out)
    return out


def _lift(v3, lam):
    """RGB (N,3) -> per-lane spectral packet (N,N_SPEC) when lam is given
    (the spectral variant's Smits upsampling of RGB medium coefficients,
    core/spectrum.py), identity otherwise.  The analog of the reference's
    Spectrum-typed sigma_t in *_spectral_* builds (fwd.h:216)."""
    if lam is None:
        return v3
    from ..core import spectrum as spec
    return spec.smits_upsample(v3, lam)


def _select_rows(idx, *rows):
    """Per-lane pick among a tiny static set of (N, C) rows by idx."""
    out = rows[0]
    for r in range(1, len(rows)):
        out = jnp.where((idx == r)[..., None], rows[r], out)
    return out


def _eval_grid(scene: Scene, gid, p):
    """Trilinear grid lookup: world point -> density (N,).
    (reference src/volumes/grid.cpp interpolation)."""
    g2l = scene.media.grid_to_local[gid]
    pl = jnp.einsum("nij,nj->ni", g2l[:, :3, :3], p) + g2l[:, :3, 3]
    whd = scene.media.grid_whd[gid]          # (N, 3) = (D, H, W)
    D = whd[:, 0].astype(jnp.float32)
    H = whd[:, 1].astype(jnp.float32)
    W = whd[:, 2].astype(jnp.float32)
    x = jnp.clip(pl[:, 0], 0.0, 1.0) * (W - 1)
    y = jnp.clip(pl[:, 1], 0.0, 1.0) * (H - 1)
    z = jnp.clip(pl[:, 2], 0.0, 1.0) * (D - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    z0 = jnp.floor(z).astype(jnp.int32)
    fx, fy, fz = x - x0, y - y0, z - z0

    def fetch(zi, yi, xi):
        zi = jnp.clip(zi, 0, whd[:, 0] - 1)
        yi = jnp.clip(yi, 0, whd[:, 1] - 1)
        xi = jnp.clip(xi, 0, whd[:, 2] - 1)
        return scene.media.grids[gid, zi, yi, xi, 0]

    c = 0.0
    for dz in (0, 1):
        wz = jnp.where(dz == 0, 1 - fz, fz)
        for dy in (0, 1):
            wy = jnp.where(dy == 0, 1 - fy, fy)
            for dx in (0, 1):
                wx = jnp.where(dx == 0, 1 - fx, fx)
                c = c + wz * wy * wx * fetch(z0 + dz, y0 + dy, x0 + dx)
    return c


def _bio_compute_distance(scene: Scene, midx, mtype, prm, channel, sampler,
                          tissue_depth, lam=None):
    """Competing-exponential element sampling for the bio media.

    Returns (bio_type, distance, sampler).  Mirrors liver.cpp computeDistance
    (:227-477) / glissonCapsule.cpp computeDistance (:229-308):
      glisson layers: 2 attenuators (collagen, elastin), per-layer sigma;
      parenchyma: 3 absorbers (blood, bile, lipid-water) + hepatocyte with
      distance -log10(sigma+1)*log(r).
    """
    n = channel.shape[0]
    # layer binning by tissue depth (see module docstring re liver.cpp bug)
    limits = prm[:, 36:40]                          # (N, 4)
    layer = jnp.sum(tissue_depth[:, None] > limits, axis=1)  # 0..4
    # PARENCHYMA medium is always the parenchyma branch; GLISSON is always
    # glisson (clamped to layer 3); LIVER switches on layer.
    layer = jnp.where(mtype == MEDIUM_PARENCHYMA, 4, layer)
    layer = jnp.where(mtype == MEDIUM_GLISSON, jnp.minimum(layer, 3), layer)
    in_glisson = layer < 4

    lay = jnp.minimum(layer, 3)
    coll = _select_rows(lay, prm[:, 12:15], prm[:, 15:18], prm[:, 18:21],
                        prm[:, 21:24])
    elas = _select_rows(lay, prm[:, 24:27], prm[:, 27:30], prm[:, 30:33],
                        prm[:, 33:36])

    # parenchyma coefficients: PARENCHYMA rows pack at 12.., LIVER at 40..
    is_liver = mtype == MEDIUM_LIVER
    blood = jnp.where(is_liver[:, None], prm[:, 40:43], prm[:, 12:15])
    bile = jnp.where(is_liver[:, None], prm[:, 43:46], prm[:, 15:18])
    lipid = jnp.where(is_liver[:, None], prm[:, 48:51], prm[:, 18:21])
    hep = jnp.where(is_liver, prm[:, 46], prm[:, 21])
    # spectral variant: each element's RGB sigma lifted to the lane's
    # wavelength packet; the tracked channel then indexes wavelengths
    coll, elas = _lift(coll, lam), _lift(elas, lam)
    blood, bile, lipid = _lift(blood, lam), _lift(bile, lam), \
        _lift(lipid, lam)

    # six independent uniforms (2 glisson + 4 parenchyma elements),
    # drawn in 2 hashes instead of 6
    u6, sampler = sampler.next_nd(6)
    u6 = jnp.maximum(u6, 1e-7)            # guard r==0 (liver.cpp:322)
    us = [u6[:, i] for i in range(6)]

    def exp_dist(sig_rgb, u):
        att = _index_spectrum(sig_rgb, channel)
        d = -jnp.log(u) / jnp.maximum(att, 1e-20)
        return jnp.where(att > 0, d, INF)

    # ---- glisson branch: collagen vs elastin, both attenuators ----
    d_coll = exp_dist(coll, us[0])
    d_elas = exp_dist(elas, us[1])
    g_dist = jnp.minimum(d_coll, d_elas)
    g_type = jnp.full((n,), BIO_ATTENUATOR, jnp.int32)

    # ---- parenchyma branch: blood/bile/lipid absorbers + hepatocyte ----
    d_blood = exp_dist(blood, us[2])
    d_bile = exp_dist(bile, us[3])
    d_lipid = exp_dist(lipid, us[4])
    # hepatocyte: scalar sigma; reference uses -log10(sigma+1)*log(r)
    # (liver.cpp:376-378)
    log10_hep = jnp.log(jnp.maximum(hep + 1.0, 1.0)) / jnp.log(10.0)
    d_hep = jnp.where(hep > 0, -log10_hep * jnp.log(us[5]), INF)

    dists = jnp.stack([d_blood, d_bile, d_lipid, d_hep], -1)
    elem = jnp.argmin(dists, axis=-1)
    p_dist = jnp.min(dists, axis=-1)
    p_type = jnp.where(elem == 3, BIO_ABSORBER_AND_ATTENUATOR,
                       BIO_ABSORBER).astype(jnp.int32)

    bio_type = jnp.where(in_glisson, g_type, p_type)
    distance = jnp.where(in_glisson, g_dist, p_dist)

    # ---- differentiable event rates for the score estimator ----
    # competing exponentials: joint density of (t, chosen element e) is
    # rate_e * exp(-rate_total * t); escape prob is exp(-rate_total * s).
    # The hepatocyte uses t = -log10(sigma+1) * log(u), i.e. an exponential
    # with rate 1/log10(sigma+1).
    r_coll = _index_spectrum(coll, channel)
    r_elas = _index_spectrum(elas, channel)
    g_total = r_coll + r_elas
    g_chosen = jnp.where(d_coll <= d_elas, r_coll, r_elas)

    rate_hep = jnp.where(hep > 0, 1.0 / jnp.maximum(log10_hep, 1e-12), 0.0)
    r_blood = _index_spectrum(blood, channel)
    r_bile = _index_spectrum(bile, channel)
    r_lipid = _index_spectrum(lipid, channel)
    p_rates = jnp.stack([r_blood, r_bile, r_lipid, rate_hep], -1)
    p_total = jnp.sum(p_rates, -1)
    p_chosen = jnp.where(elem == 0, r_blood,
                         jnp.where(elem == 1, r_bile,
                                   jnp.where(elem == 2, r_lipid, rate_hep)))

    rate_total = jnp.where(in_glisson, g_total, p_total)
    rate_chosen = jnp.where(in_glisson, g_chosen, p_chosen)
    return bio_type, distance, rate_total, rate_chosen, sampler


def sample_interaction_candidate(scene: Scene, medium_idx, ray_o, ray_d,
                                 sampler, channel, tissue_depth, active,
                                 lam=None):
    """Phase 1 of free-flight sampling: draw the tentative collision
    distance and evaluate coefficients at the candidate point.

    The distance law never depends on the surface distance, so the
    integrator samples the medium FIRST and bounds its surface query by
    the candidate collision (accel chunk culling then skips geometry
    beyond it); `finalize_interaction` applies the real maxt afterwards.
    """
    n = ray_o.shape[0]
    midx = jnp.maximum(medium_idx, 0)
    med = scene.media
    mtype = m.table_lookup(med.mtype, midx)
    prm = m.table_lookup(med.params, midx)
    scale = prm[:, 6]
    sigma_t_base = _lift(prm[:, 0:3] * scale[:, None], lam)
    albedo = _lift(prm[:, 3:6], lam)
    C = sigma_t_base.shape[-1]

    u, sampler = sampler.next_1d()
    u = jnp.minimum(u, 1.0 - 1e-7)

    tp = med.types_present
    majorant = sigma_t_base
    if MEDIUM_HETEROGENEOUS in tp:
        maj_het = prm[:, 10:11] * scale[:, None] * jnp.ones((n, C))
        majorant = jnp.where((mtype == MEDIUM_HETEROGENEOUS)[:, None],
                             maj_het, majorant)
    maj_c = _index_spectrum(majorant, channel)

    # ---- tentative free-flight distance ----
    t_exp = -jnp.log(1.0 - u) / jnp.maximum(maj_c, 1e-20)
    dist = t_exp
    bio_type = jnp.full((n,), BIO_ATTENUATOR, jnp.int32)
    bio_present = any(t in tp for t in
                      (MEDIUM_GLISSON, MEDIUM_PARENCHYMA, MEDIUM_LIVER)) \
        and bio_mode(scene)
    if bio_present:
        btype, bdist, rate_total, rate_chosen, sampler = \
            _bio_compute_distance(scene, midx, mtype, prm, channel, sampler,
                                  tissue_depth, lam=lam)
        is_bio = mtype >= MEDIUM_GLISSON
        dist = jnp.where(is_bio, bdist, dist)
        bio_type = jnp.where(is_bio, btype, bio_type)
    else:
        is_bio = jnp.zeros((n,), bool)
        rate_total = rate_chosen = jnp.zeros((n,))

    # Detached sampling (prbvolpath differentiable delta tracking): the
    # sampled collision distance/point carries no derivative; parameter
    # gradients flow through the tr/pdf ratios and sigma evaluations only.
    # Without this, d(mei.p)/d(sigma) reaches downstream sqrt(disc~0)
    # intersection pullbacks and turns masked lanes into nan.
    dist = jax.lax.stop_gradient(dist)
    p = ray_o + ray_d * jnp.where(jnp.isfinite(dist), dist, 0.0)[:, None]

    # ---- local scattering coefficients at the candidate point ----
    sigma_t = sigma_t_base
    if MEDIUM_HETEROGENEOUS in tp:
        gid = jnp.maximum(med.grid_id[midx], 0)
        dens = _eval_grid(scene, gid, p) * scale
        sig_het = dens[:, None] * jnp.ones((n, C))
        sigma_t = jnp.where((mtype == MEDIUM_HETEROGENEOUS)[:, None],
                            sig_het, sigma_t)
    sigma_s = sigma_t * albedo
    if MEDIUM_PARENCHYMA in tp and not bio_mode(scene):
        # standard-path parenchyma: hard-coded (sigma_t, sigma_s),
        # majorant stays eval_sigmat (parenchyma.cpp:175-190) so null
        # collisions fill the gap
        par = (mtype == MEDIUM_PARENCHYMA)[:, None]
        st_hc = _lift(jnp.broadcast_to(
            jnp.asarray(_PARENCHYMA_SIGMA_T), (n, 3)), lam)
        ss_hc = _lift(jnp.broadcast_to(
            jnp.asarray(_PARENCHYMA_SIGMA_S), (n, 3)), lam)
        sigma_t = jnp.where(par, st_hc, sigma_t)
        sigma_s = jnp.where(par, ss_hc, sigma_s)
    sigma_n = jnp.maximum(majorant - sigma_t, 0.0)

    cand = dict(dist=dist, p=p, sigma_t=sigma_t, sigma_s=sigma_s,
                sigma_n=sigma_n, majorant=majorant, bio_type=bio_type,
                is_bio=is_bio, rate_total=rate_total,
                rate_chosen=rate_chosen, bio_present=bio_present)
    return cand, sampler


def finalize_interaction(cand, maxt, channel, active):
    """Phase 2: apply the true segment bound (surface distance) to the
    candidate collision — validity, bio transmittance semantics
    (liver.cpp:499-534) and the score-estimator log-likelihood."""
    dist = cand["dist"]
    n = dist.shape[0]
    C = cand["sigma_t"].shape[-1]
    valid = active & (dist <= maxt) & (dist > 0)
    t = jnp.where(valid, dist, INF)

    transmittance = jnp.ones((n, C))
    log_p = jnp.zeros((n,))
    if cand["bio_present"]:
        bio_type = cand["bio_type"]
        is_bio = cand["is_bio"]
        absorbed = (bio_type == BIO_ABSORBER) \
            | ((bio_type == BIO_ABSORBER_AND_ATTENUATOR)
               & (dist < HEPATOCYTE_MEAN_DIAMETER))
        onehot = jax.nn.one_hot(channel, C, dtype=jnp.float32)
        tr_bio = jnp.where(valid[:, None],
                           jnp.where(absorbed[:, None], 0.0, onehot),
                           jnp.ones((n, C)))
        transmittance = jnp.where(is_bio[:, None], tr_bio, transmittance)
        # absorbed lanes scatter nowhere: mark invalid scatter but keep t
        # finite so the integrator can kill them via transmittance==0

        # score estimator (unbiased d/d sigma of bio free flight): the
        # sampled distance/element are detached, the differentiable
        # log-likelihood of the realized event re-enters via
        # exp(log_p - stop(log_p)) in the integrator.
        t_det = jax.lax.stop_gradient(jnp.minimum(dist, maxt))
        t_det = jnp.where(jnp.isfinite(t_det), t_det, 0.0)
        scattered_b = jax.lax.stop_gradient(valid)
        lp_scatter = jnp.log(jnp.maximum(cand["rate_chosen"], 1e-20)) \
            - cand["rate_total"] * t_det
        lp_escape = -cand["rate_total"] * t_det
        lp = jnp.where(scattered_b, lp_scatter, lp_escape)
        log_p = jnp.where(is_bio & active, lp, 0.0)

    return MediumInteraction(
        t=t, p=cand["p"], sigma_s=cand["sigma_s"], sigma_n=cand["sigma_n"],
        sigma_t=cand["sigma_t"], combined_extinction=cand["majorant"],
        transmittance=transmittance, log_p=log_p)


def sample_interaction(scene: Scene, medium_idx, ray_o, ray_d, maxt,
                       sampler, channel, tissue_depth, active, lam=None):
    """Sample a free-flight distance in each lane's medium.

    Returns (mei: MediumInteraction, sampler).  mei.t = inf means the lane
    escaped the medium (reached the surface at maxt first).  For bio media
    mei.transmittance carries the one-hot/kill semantics
    (liver.cpp:521-534); stock media leave it at 1.
    """
    cand, sampler = sample_interaction_candidate(
        scene, medium_idx, ray_o, ray_d, sampler, channel, tissue_depth,
        active, lam=lam)
    return finalize_interaction(cand, maxt, channel, active), sampler


def transmittance_eval_pdf(scene: Scene, medium_idx, mei: MediumInteraction,
                           surf_t):
    """Analytic transmittance + free-flight pdf along [0, min(mei.t, surf_t)]
    wrt the majorant (reference medium.cpp:92-104)."""
    t = jnp.minimum(mei.t, surf_t)
    t = jnp.where(jnp.isfinite(t), t, 0.0)
    tr = jnp.exp(-t[:, None] * mei.combined_extinction)
    pdf = jnp.where((surf_t < mei.t)[:, None], tr,
                    tr * mei.combined_extinction)
    return tr, pdf


def medium_phase(scene: Scene, medium_idx):
    """(phase_type, g, param_row) lanes for the medium table — the row
    carries the extended phases' parameters (phase/dispatch.py)."""
    midx = jnp.maximum(medium_idx, 0)
    prm = m.table_lookup(scene.media.params, midx)
    return prm[:, 8].astype(jnp.int32), prm[:, 7], prm


def bio_mode(scene: Scene) -> bool:
    """Whether the bio competing-exponential sampling applies.

    Mirrors the reference's dispatch-by-overload: only biovolpath /
    biovolpath06 call the 5-arg tissueDepth `sample_interaction`
    (computeDistance + one-hot transmittance + absorber kills);
    every other integrator (stock volpath, volpathmis, prbvolpath)
    reaches the bio media through the BASE Medium::sample_interaction —
    standard majorant free flight with `get_scattering_coefficients`
    (parenchyma.cpp:303 overload vs medium.cpp:42 base; the
    SphereLiverConstEnv ball rendered 10x too dark when the bio kills
    were applied under stock volpath)."""
    return scene.integrator in ("biovolpath", "biovolpath06")


# parenchyma.cpp:182-183 hard-codes the standard-path coefficients
# (sigma_t, sigma_s) instead of using its volumes
_PARENCHYMA_SIGMA_T = (77.2 / 255.0, 105.0 / 255.0, 149.0 / 255.0)
_PARENCHYMA_SIGMA_S = (74.0 / 255.0, 88.0 / 255.0, 101.0 / 255.0)


def medium_is_bio(scene: Scene, medium_idx):
    midx = jnp.maximum(medium_idx, 0)
    is_bio_type = scene.media.mtype[midx] >= MEDIUM_GLISSON
    if not bio_mode(scene):
        return jnp.zeros_like(is_bio_type)
    return is_bio_type
