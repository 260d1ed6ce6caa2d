"""Quantitative VAE-BSSRDF validation vs the volpath3d ground truth
(VERDICT r3 #3): the reference's own training methodology
(sss_particle_tracer.h:242,335) — the learned model must reproduce the
brute-force walk's absorption probability and exit-position distribution
on spheres across medium grid points.  Runs the FULL production plumbing
(per-vertex poly fit -> feature normalization -> light-space rotation ->
decoder -> projection, ssub/event.py), so a regression anywhere in that
chain fails this test.

Round-5 recalibration (32k-walker runs, results/vae_validation_r5.json,
after the GT walk gained internal FRESNEL RE-ENTRY — volpath3d.py): the
g=0 grid points (any eta) agree to 0.003-0.012 absolute absorption and
0.89-1.07x exit mean, so the bounds tightened ~6x from the r4
regression-guards (0.12 / [0.6,1.6]) into genuine parity bounds; the
eta=1.3 point is now checkable (absorb 0.587 vs GT 0.589).  g=0.5 keeps
a documented looser absorption band — the model's absorption head
under-predicts by ~0.14 at strong anisotropy (a model limitation, its
exit distribution still matches to 10%).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from liverrenderer.ssub import vae  # noqa: E402


@pytest.mark.skipif(not vae.model_available(),
                    reason="reference VAE weights not present")
@pytest.mark.parametrize("sigma_t,albedo,eta", [(50.0, 0.95, 1.0),
                                                (50.0, 0.90, 1.0),
                                                (100.0, 0.95, 1.3)])
def test_vae_matches_ground_truth_walk(sigma_t, albedo, eta):
    from vae_validate import run_point

    # CPU n=2048 keeps the suite fast; the 32k-walker runs that calibrated
    # these bounds sit in results/vae_validation_r5.json.  Monte-Carlo
    # s.e. of the absorb rate at n=2048 is ~0.011, so the bound is
    # 0.03 (parity) + 3 s.e.
    row = run_point(sigma_t, albedo, g=0.0, eta=eta, n=2048)
    v, g = row["vae"], row["gt"]

    # absorption head vs conditioned walk absorption rate
    assert abs(v["absorb_p"] - g["absorb_rate"]) < 0.065, row
    # exit-distance distribution: mean + median within calibrated bands
    # (the median over ~1.1k exits is noisier than the mean — its band
    # carries ~2x the MC allowance)
    assert 0.8 < v["exit_mean"] / g["exit_mean"] < 1.25, row
    assert 0.7 < v["exit_q"][1] / g["exit_q"][1] < 1.5, row
    # enough lanes actually completed the VAE path (projection succeeded):
    # the expected survivor count is n * (1 - absorb_p)
    assert v["n_exits"] > 0.8 * 2048 * (1.0 - v["absorb_p"]), row


@pytest.mark.skipif(not vae.model_available(),
                    reason="reference VAE weights not present")
def test_vae_anisotropic_point_documented_band():
    """g=0.5: the exit distribution matches to ~10% but the absorption
    head under-predicts by ~0.14 (32k-walker calibration) — a model
    limitation bounded here so a further regression still fails."""
    from vae_validate import run_point

    row = run_point(50.0, 0.95, g=0.5, eta=1.0, n=2048)
    v, g = row["vae"], row["gt"]
    assert abs(v["absorb_p"] - g["absorb_rate"]) < 0.2, row
    assert 0.8 < v["exit_mean"] / g["exit_mean"] < 1.3, row


@pytest.mark.skipif(not vae.model_available(),
                    reason="reference VAE weights not present")
def test_vae_exits_project_onto_surface():
    """Every VAE exit must land on the geometry (|p| = 1 on the unit
    sphere) — the projectPointsToSurface contract."""
    import jax.numpy as jnp

    import liverrenderer as lr
    from liverrenderer.accel.intersect import ray_intersect
    from liverrenderer.core.rng import make_sampler
    from liverrenderer.core.types import Ray
    from liverrenderer.ssub.event import subsurface_event
    from vae_validate import uv_sphere

    n = 1024
    verts, faces = uv_sphere()
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": 4},
         "sensor": {"type": "perspective", "fov": 30.0,
                    "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0],
                                                       [0, 1, 0]),
                    "film": {"type": "hdrfilm", "width": 8, "height": 8,
                             "rfilter": {"type": "box"}}},
         "blob": {"type": "mesh", "vertices": verts, "faces": faces,
                  "subsurface": {"type": "vaescatter",
                                 "sigmaT": {"type": "rgb",
                                            "value": [50.0] * 3},
                                 "albedo": {"type": "rgb",
                                            "value": [0.95] * 3},
                                 "g": 0.0, "eta": 1.0}},
         "lamp": {"type": "point", "position": [3, 3, 3],
                  "intensity": {"type": "rgb", "value": [10.0] * 3}}}
    scene = lr.load_dict(d)
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 4.0]]), (n, 1))
    dd = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    si = ray_intersect(scene, Ray(o=o, d=dd, maxt=jnp.full((n,), jnp.inf)))
    sampler = make_sampler(jnp.arange(n, dtype=jnp.uint32),
                           jnp.zeros((n,), jnp.uint32), jnp.uint32(3),
                           kind=scene.sampler_kind, spp=1)
    ev, _ = subsurface_event(scene, si, dd, sampler, jnp.ones((n,), bool))
    exits = np.asarray(ev.alive & ~ev.passthrough)
    r = np.linalg.norm(np.asarray(ev.out_p), axis=-1)[exits]
    absorb = float(np.asarray(ev.absorb_p)[0])
    assert exits.sum() > 0.7 * n * (1.0 - absorb)
    # triangulated unit sphere: radius within the facet sagitta (~0.01)
    np.testing.assert_array_less(np.abs(r - 1.0), 0.02)


@pytest.mark.skipif(not vae.model_available(),
                    reason="reference VAE weights not present")
def test_vae_uses_training_feature_stats():
    """The shipped model was trained with light-space poly stats
    (training-metadata.json shape_features_name=mlsPolyLS3); loading must
    honor that (round-4 fix: world-space stats under the LS rotation made
    the model mispredict absorption 6x)."""
    w = vae.load_model()
    import json
    stats = json.load(open(vae.DEFAULT_STATS))
    np.testing.assert_allclose(np.asarray(w.feat_mean),
                               np.asarray(stats["mlsPolyLS3_mean"],
                                          np.float32))


@pytest.mark.skipif(not vae.model_available(),
                    reason="reference VAE weights not present")
def test_sss_object_radiance_bracket():
    """Object-level SSS radiance cross-check (no external golden needed):
    the SAME translucent sphere rendered with (a) brute-force volumetric
    path tracing (dielectric boundary + real interior medium — the
    transport the VAE imitates), (b) the learned vaescatter BSSRDF, and
    (c) the classical dipole.  The vaescatter render must sit near the
    brute-force estimate and strictly closer than the dipole
    (calibration at 64^2/64spp: vae/volpath = 1.22, dipole/volpath = 3.2,
    results/sss_bracket.json)."""
    import jax.numpy as jnp

    import liverrenderer as lr
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from sss_bracket import scene_dict
    from vae_validate import uv_sphere

    verts, faces = uv_sphere()
    res = 24
    means = {}
    for mode, spp in (("volpath", 32), ("vaescatter", 8), ("dipole", 8)):
        sc = lr.load_dict(scene_dict(mode, res, verts, faces))
        img = np.asarray(lr.render(sc, spp=spp, seed=3))
        assert np.isfinite(img).all()
        # central object disc
        yy, xx = np.mgrid[0:res, 0:res]
        c = (res - 1) / 2
        mask = ((xx - c) ** 2 + (yy - c) ** 2) < (0.28 * res) ** 2
        means[mode] = img[mask].mean()
    r_vae = means["vaescatter"] / means["volpath"]
    r_dip = means["dipole"] / means["volpath"]
    assert 0.6 < r_vae < 1.8, means
    assert abs(r_vae - 1.0) < abs(r_dip - 1.0), means
