"""End-to-end render tests: furnace (analytic), Cornell box statistics.

These replace the reference's golden-image z-tests (src/render/tests/
test_renders.py:159-181) with analytic ground truth where possible — a
white-furnace scene has a closed-form answer, making it a stronger test than
stored goldens for a from-scratch implementation.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer as lr


def _furnace_scene(albedo, max_depth, radiance=1.0):
    """Diffuse sphere in a constant environment: L = sum_k a^k -> closed form.

    With max_depth bounces the camera sees L = r * sum_{k=0..D-2} a^k... the
    exact series for a furnace: every path escapes to the env with throughput
    a^(#bounces).
    """
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "sensor": {
            "type": "perspective",
            "fov": 40.0,
            "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 32, "height": 32,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": 256},
        },
        "sph": {"type": "sphere", "radius": 1.0,
                "bsdf": {"type": "diffuse",
                         "reflectance": {"type": "rgb",
                                         "value": [albedo] * 3}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [radiance] * 3}},
    }


def test_furnace_white():
    """albedo=1 furnace: image must equal env radiance everywhere (energy
    conservation of the whole transport loop, NEE+MIS included).
    MC std per pixel at this spp is ~0.01, so check the image mean tightly
    and individual pixels loosely (5 sigma)."""
    d = _furnace_scene(1.0, max_depth=16)
    d["sensor"]["film"]["width"] = 16
    d["sensor"]["film"]["height"] = 16
    scene = lr.load_dict(d)
    img = np.asarray(lr.render(scene, spp=1024))
    np.testing.assert_allclose(img.mean(), 1.0, atol=0.004)
    np.testing.assert_allclose(img, 1.0, atol=0.05)


def test_furnace_partial_absorption():
    """albedo a, infinite depth: center pixel sees sum a^k with escape at
    each bounce -> L = 1 (env) outside; on the sphere L = a/(1-a(hemisphere
    integral...)). Use a MC-stable weaker check: mean over the sphere region
    matches a high-spp self-consistent run within noise, and L < 1."""
    a = 0.5
    scene = lr.load_dict(_furnace_scene(a, max_depth=48))
    img = np.asarray(lr.render(scene, spp=256))
    h, w, _ = img.shape
    center = img[h // 2 - 2:h // 2 + 2, w // 2 - 2:w // 2 + 2].mean()
    # Analytic: for a furnace, each interaction multiplies throughput by a;
    # radiance seen = sum_{k>=1} a^k * P(escape after k) with P=1 per bounce
    # under uniform env: L = a + a^2 + ... = a/(1-a) ... capped at 1 series:
    # actually every bounce terminates at env: L = a * 1 (direct env via one
    # bounce) summed over paths = a/(1-a) only without normalization. The
    # correct closed form for Lambertian furnace: L = a/(1-a) * (1-a) = a?
    # Standard result: under unit uniform illumination a Lambertian surface
    # reflects L_out = a * 1, and multiple interreflection on a convex body
    # adds nothing (sphere sees only env). => center = a.
    np.testing.assert_allclose(center, a, atol=0.02)
    corner = img[2, 2]
    np.testing.assert_allclose(corner, 1.0, atol=0.02)


def test_cornell_box_renders():
    d = lr.cornell_box()
    d["sensor"]["film"]["width"] = 64
    d["sensor"]["film"]["height"] = 64
    scene = lr.load_dict(d)
    img = np.asarray(lr.render(scene, spp=64))
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    assert img.max() > 1.0          # light source visible
    assert 0.05 < img.mean() < 1.0  # plausible exposure
    # left wall is red-dominant, right wall green-dominant
    left = img[32, 4]
    right = img[32, 59]
    assert left[0] > left[1] * 1.5
    assert right[1] > right[0] * 1.5


def test_point_light_inverse_square():
    """Direct illumination by a point light: L = I * cos / r^2 * albedo/pi."""
    scene_d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {
            "type": "perspective", "fov": 30.0,
            "to_world": lr.Transform().look_at([0, 0, 2], [0, 0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 16, "height": 16,
                     "rfilter": {"type": "box"}},
        },
        "plane": {"type": "rectangle",
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": [0.8] * 3}}},
        "lamp": {"type": "point", "position": [0, 0, 3],
                 "intensity": {"type": "rgb", "value": [10.0] * 3}},
    }
    scene = lr.load_dict(scene_d)
    img = np.asarray(lr.render(scene, spp=16))
    expect = 10.0 * 1.0 / 9.0 * 0.8 / np.pi
    np.testing.assert_allclose(img[8, 8], expect, rtol=0.02)


def test_area_light_vs_quadrature():
    """Direct lighting from a square area light on a diffuse plane point,
    validated against 2D quadrature of the form-factor integral."""
    # light: unit rectangle at z=1 facing down; receiver at origin facing up
    scene_d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {
            "type": "perspective", "fov": 5.0,
            "to_world": lr.Transform().look_at([0, 0, 1e-1], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 8, "height": 8,
                     "rfilter": {"type": "box"}},
        },
        "plane": {"type": "rectangle", "to_world": lr.Transform().scale(5.0),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": [1.0] * 3}}},
        "lamp": {"type": "rectangle",
                 "to_world": lr.Transform().translate([0, 0, 1.0])
                             .rotate([1, 0, 0], 180).scale(0.5),
                 "emitter": {"type": "area",
                             "radiance": {"type": "rgb", "value": [1.0] * 3}}},
    }
    scene = lr.load_dict(scene_d)
    img = np.asarray(lr.render(scene, spp=512))
    # quadrature: L = (rho/pi) * int_light cos1 cos2 / r^2 dA
    xs = np.linspace(-0.5, 0.5, 201)
    X, Y = np.meshgrid(xs, xs)
    r2 = X ** 2 + Y ** 2 + 1.0
    cos1 = 1.0 / np.sqrt(r2)
    integrand = cos1 * cos1 / r2
    dA = (xs[1] - xs[0]) ** 2
    expect = integrand.sum() * dA / np.pi
    np.testing.assert_allclose(img[4, 4, 0], expect, rtol=0.05)
