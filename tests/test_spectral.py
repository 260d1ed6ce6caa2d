"""Spectral transport variant (scene.spectral, core/spectrum.py).

The reference builds *_spectral_* variants from one codebase
(fwd.h:216, CMakeLists.txt:109-128); here the variant is a data-driven
scene flag: hero-wavelength packets per lane, Smits-lifted RGB inputs,
CIE conversion at lane death.  Tests: upsampling round trips, spectral
vs RGB render agreement (they estimate the same scene up to metamerism),
specfilm energy consistency, and gradients through the spectral path.
"""
import jax
import jax.numpy as jnp
import numpy as np

import liverrenderer as lr
from liverrenderer.core import spectrum as S


def _cornell(variant=None, w=16):
    d = lr.cornell_box()
    d["integrator"] = {"type": "path", "max_depth": 4}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": w, "height": w,
                           "rfilter": {"type": "box"}}
    return lr.load_dict(d, variant=variant)


def test_upsample_round_trip():
    """Smits-lift + CIE estimate must reproduce the source RGB: whites
    near-exactly (D65-referenced), saturated colors within the basis's
    documented smoothness error."""
    rng = np.random.default_rng(0)
    lam = S.sample_hero(jnp.asarray(rng.random(100000), jnp.float32))
    for rgb, tol in (([1.0, 1.0, 1.0], 0.05), ([0.3, 0.3, 0.3], 0.05),
                     ([0.8, 0.1, 0.1], 0.08), ([0.1, 0.2, 0.7], 0.08)):
        r = jnp.asarray(rgb, jnp.float32)
        spec = S.smits_upsample_illum(
            jnp.broadcast_to(r, lam.shape[:-1] + (3,)), lam)
        back = np.asarray(S.spec_to_rgb_estimate(spec, lam)).mean(0)
        np.testing.assert_allclose(back, rgb, atol=tol)


def test_spectral_render_matches_rgb():
    rgb = np.asarray(lr.render(_cornell(), spp=32, seed=0))
    sp = np.asarray(lr.render(_cornell("spectral"), spp=32, seed=0))
    assert np.isfinite(sp).all()
    # same scene, same paths; differences = metamerism of the lifted
    # spectra + spectral sampling noise
    assert abs(sp.mean() - rgb.mean()) / rgb.mean() < 0.05
    ch_r, ch_s = rgb.mean((0, 1)), sp.mean((0, 1))
    np.testing.assert_allclose(ch_s, ch_r, rtol=0.15)


def test_specfilm_energy_consistent():
    """The binned spectral film integrated against the CIE Y curve must
    match the spectral RGB render's luminance."""
    scene = _cornell("spectral")
    bins = np.asarray(lr.render_specfilm(scene, n_bins=16, spp=32, seed=0))
    assert bins.shape == (16, 16, 16)
    assert np.isfinite(bins).all() and (bins >= 0).all()
    centers = S.SPEC_MIN + (np.arange(16) + 0.5) * (
        S.SPEC_MAX - S.SPEC_MIN) / 16
    ybar = np.asarray(S.cie1931_xyz_bar(centers))[:, 1]
    Y = (bins * ybar).sum(-1) / S._CIE_Y_INT
    img = np.asarray(lr.render(scene, spp=32, seed=0))
    lum = np.asarray(S.luminance(jnp.asarray(img)))
    np.testing.assert_allclose(Y.mean(), lum.mean(), rtol=0.05)


def test_spectral_gradients():
    """Reverse-mode through the spectral path (scan adjoint; the replay
    adjoint intentionally falls back, prb_replay.replay_applicable)."""
    scene = _cornell("spectral", w=8)
    params = {"emitters.params": scene.emitters.params}

    def loss_fn(img):
        return jnp.mean(img)

    loss, grads, img = lr.render_grad(scene, params, loss_fn, spp=16,
                                      seed=0)
    g = np.asarray(grads["emitters.params"])
    assert np.isfinite(g).all()
    idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 1e-2

    def loss_at(v):
        arr = np.asarray(params["emitters.params"]).copy()
        arr[idx] = v
        sc = lr.apply_params(scene, {"emitters.params": jnp.asarray(arr)})
        return float(loss_fn(lr.render(sc, spp=16, seed=0, mode="ad")))

    v0 = float(np.asarray(params["emitters.params"])[idx])
    fd = (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)
    np.testing.assert_allclose(g[idx], fd, rtol=2e-2, atol=1e-7)


def test_spectral_variant_gating():
    """Configs outside the spectral variant's domain still reject: the
    aux-integrator family (round 5 extended spectral to the volumetric
    family, so volpath now loads)."""
    import pytest
    d = lr.cornell_box()
    d["integrator"] = {"type": "aov"}
    with pytest.raises(AssertionError):
        lr.load_dict(d, variant="spectral")
    d["integrator"] = {"type": "volpath"}
    assert lr.load_dict(d, variant="spectral").spectral


# ---------------------------------------------------------------------------
# Spectral VOLUMETRIC family (round 5): hero packets through the volpath
# wavefront — fog and bio media (fwd.h:216 spectral volpath variants).
# ---------------------------------------------------------------------------

def _fog_cornell(variant=None, w=16, sigma=1.2):
    d = lr.cornell_box()
    d["integrator"] = {"type": "volpath", "max_depth": 6}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": w, "height": w,
                           "rfilter": {"type": "box"}}
    d["fog"] = {"type": "cube",
                "to_world": lr.Transform().scale(0.99),
                "bsdf": {"type": "null"},
                "interior": {"type": "homogeneous",
                             "sigma_t": {"type": "rgb",
                                         "value": [sigma, sigma * 0.8,
                                                   sigma * 0.6]},
                             "albedo": {"type": "rgb",
                                        "value": [0.8, 0.7, 0.9]},
                             "phase": {"type": "hg", "g": 0.3}}}
    return lr.load_dict(d, variant=variant)


def _bio_sphere(variant=None, w=12):
    d = {
        "type": "scene",
        "integrator": {"type": "biovolpath", "max_depth": 6},
        "sensor": {"type": "perspective", "fov": 40.0,
                   "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0],
                                                      [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": w, "height": w,
                            "rfilter": {"type": "box"}}},
        "blob": {"type": "sphere",
                 "bsdf": {"type": "dielectric", "int_ior": 1.36},
                 "interior": {
                     "type": "glissonCapsule",
                     "layer1Limit": 0.001, "layer2Limit": 0.002,
                     "layer3Limit": 0.003, "layer4Limit": 10.0,
                     "sigma_collagen1_R": 8.0, "sigma_collagen1_G": 10.0,
                     "sigma_collagen1_B": 12.0,
                     "sigma_elastin1_R": 2.0, "sigma_elastin1_G": 2.5,
                     "sigma_elastin1_B": 3.0,
                 }},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }
    return lr.load_dict(d, variant=variant)


def test_spectral_volpath_fog_matches_rgb():
    """Spectral and RGB volpath estimate the same fog scene.  The colored
    fog compounds Smits metamerism per scatter (sigma ratios x albedo x
    wall reflectance), measured ~10% overall; a GRAY fog (flat spectra,
    exact under the Smits basis) agrees to ~3% — the bias check below —
    so the colored bound is metamerism, not estimator bias."""
    rgb = np.asarray(lr.render(_fog_cornell(), spp=48, seed=0))
    sp = np.asarray(lr.render(_fog_cornell("spectral"), spp=48, seed=0))
    assert np.isfinite(sp).all()
    assert abs(sp.mean() - rgb.mean()) / rgb.mean() < 0.15
    ch_r, ch_s = rgb.mean((0, 1)), sp.mean((0, 1))
    np.testing.assert_allclose(ch_s, ch_r, rtol=0.25)


def test_spectral_volpath_gray_fog_unbiased():
    """Flat (gray) spectra are EXACT under the Smits basis, so a gray fog
    isolates estimator bias from metamerism: spectral must match RGB to
    the wavelength-sampling noise floor."""
    def gray(variant=None, w=16):
        d = lr.cornell_box()
        d["integrator"] = {"type": "volpath", "max_depth": 6}
        d["sensor"]["film"] = {"type": "hdrfilm", "width": w, "height": w,
                               "rfilter": {"type": "box"}}
        d["fog"] = {"type": "cube", "to_world": lr.Transform().scale(0.99),
                    "bsdf": {"type": "null"},
                    "interior": {"type": "homogeneous",
                                 "sigma_t": {"type": "rgb",
                                             "value": [1.0] * 3},
                                 "albedo": {"type": "rgb",
                                            "value": [0.8] * 3},
                                 "phase": {"type": "hg", "g": 0.3}}}
        return lr.load_dict(d, variant=variant)

    rgb = np.asarray(lr.render(gray(), spp=64, seed=0))
    sp = np.asarray(lr.render(gray("spectral"), spp=64, seed=0))
    assert abs(sp.mean() - rgb.mean()) / rgb.mean() < 0.06


def test_spectral_biovolpath_runs_and_matches():
    """The bio family's one-hot channel scheme generalizes to packet
    entries: the spectral render must agree with RGB in overall energy
    (per-channel comparison is inherently metameric for the one-hot
    estimator, so compare luminance)."""
    rgb = np.asarray(lr.render(_bio_sphere(), spp=64, seed=1))
    sp = np.asarray(lr.render(_bio_sphere("spectral"), spp=64, seed=1))
    assert np.isfinite(sp).all()
    lum_r = float(np.asarray(S.luminance(jnp.asarray(rgb))).mean())
    lum_s = float(np.asarray(S.luminance(jnp.asarray(sp))).mean())
    assert abs(lum_s - lum_r) / lum_r < 0.15, (lum_r, lum_s)


def test_spectral_volpath_fd_gradient():
    """FD check of d(mean image)/d(sigma_t scale) through the SPECTRAL
    volpath scan adjoint (the fog's sigma_t sits in media.params)."""
    scene = _fog_cornell("spectral", w=8)
    params = {"media.params": scene.media.params}

    def loss_fn(img):
        return jnp.mean(img)

    loss, grads, img = lr.render_grad(scene, params, loss_fn, spp=32,
                                      seed=0)
    g = np.asarray(grads["media.params"])
    assert np.isfinite(g).all()
    # FD on the scalar scale entry (col 6) of the fog medium's row
    mid = int(np.argmax(np.asarray(scene.media.params)[:, 0] > 0))
    eps = 0.05
    base = np.asarray(scene.media.params)

    def loss_at(d):
        p = base.copy()
        p[mid, 6] += d
        sc = lr.apply_params(scene, {"media.params": jnp.asarray(p)})
        return float(jnp.mean(lr.render(sc, spp=256, seed=7)))

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    ad = float(g[mid, 6])
    assert abs(fd) > 1e-4
    np.testing.assert_allclose(ad, fd, rtol=0.4)


def test_spectral_replay_matches_scan_adjoint():
    """Round 5: the replay adjoint covers SPECTRAL scenes (packet-width
    path pool + CIE cotangent conversion).  Its gradients must agree
    with the scan adjoint on the same spectral fog scene."""
    from liverrenderer.integrators import prb_replay
    from liverrenderer.integrators.prb import _render_grad_scan

    scene = _fog_cornell("spectral", w=8)
    params = {"media.params": scene.media.params}
    assert prb_replay.replay_applicable(scene, params, 16)

    def loss_fn(img):
        return jnp.mean(img)

    lr_, gr, _ = prb_replay.render_grad_replay(scene, params, loss_fn,
                                               spp=16, seed=0)
    ls, gs, _ = _render_grad_scan(scene, params, loss_fn, 16, 0, None)
    g1 = np.asarray(gr["media.params"])
    g2 = np.asarray(gs["media.params"])
    assert np.isfinite(g1).all()
    assert abs(float(lr_) - float(ls)) < 1e-5 * abs(float(ls)) + 1e-9
    n1, n2 = np.linalg.norm(g1), np.linalg.norm(g2)
    assert n1 > 0 and n2 > 0
    corr = float((g1 * g2).sum() / (n1 * n2))
    assert corr > 0.98, (corr, n1, n2)
    assert 0.8 < n1 / n2 < 1.25, (n1, n2)
