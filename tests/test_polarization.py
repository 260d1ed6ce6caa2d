"""Polarized transport: Mueller calculus + stokes integrator + polarizer/
retarder/circular elements (reference src/integrators/stokes.cpp,
src/bsdfs/{polarizer,retarder,circular}.cpp, mueller.h)."""
import numpy as np
import pytest

import liverrenderer as lr


def _stack_scene(elements, radiance=1.0, max_depth=8):
    """Camera at z=+3 looking down -z through transmissive elements
    (rectangles at decreasing z), then out to a constant env."""
    d = {
        "type": "scene",
        "integrator": {"type": "stokes", "max_depth": max_depth},
        "sensor": {
            "type": "perspective", "fov": 10.0,
            "to_world": lr.Transform().look_at([0, 0, 3], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 4, "height": 4,
                     "rfilter": {"type": "box"}},
        },
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [radiance] * 3}},
    }
    for i, el in enumerate(elements):
        d[f"el{i}"] = {
            "type": "rectangle",
            "to_world": lr.Transform().translate([0, 0, 2.0 - 0.5 * i]),
            "bsdf": el,
        }
    return lr.load_dict(d)


def _center_stokes(scene, spp=16):
    img = lr.render_stokes(scene, spp=spp, seed=0)   # (h, w, 4, 3)
    return img[1:3, 1:3].mean((0, 1, 3))             # (4,) averaged rgb


def test_single_polarizer_halves_unpolarized():
    s = _center_stokes(_stack_scene([{"type": "polarizer"}]))
    assert abs(s[0] - 0.5) < 1e-3, s
    # fully linearly polarized output: DOP = 1
    dop = np.sqrt(s[1] ** 2 + s[2] ** 2 + s[3] ** 2) / s[0]
    assert abs(dop - 1.0) < 1e-3, s


@pytest.mark.parametrize("theta2", [0.0, 30.0, 45.0, 60.0, 90.0])
def test_malus_law(theta2):
    """Two linear polarizers: S0 = 0.5 cos^2(dtheta) (Malus)."""
    s = _center_stokes(_stack_scene([
        {"type": "polarizer", "theta": theta2},   # nearer the camera
        {"type": "polarizer", "theta": 0.0},
    ]))
    expect = 0.5 * np.cos(np.deg2rad(theta2)) ** 2
    assert abs(s[0] - expect) < 2e-3, (theta2, s[0], expect)


def test_crossed_polarizers_with_wave_plates():
    """Classic optics ladder: crossed polarizers block; a middle polarizer
    at 45deg re-opens 1/8; a quarter-wave plate at 45deg opens 1/4
    (circular); a half-wave plate at 45deg opens fully (1/2)."""
    blocked = _center_stokes(_stack_scene([
        {"type": "polarizer", "theta": 90.0},
        {"type": "polarizer", "theta": 0.0},
    ]))
    assert blocked[0] < 1e-4, blocked
    mid = _center_stokes(_stack_scene([
        {"type": "polarizer", "theta": 90.0},
        {"type": "polarizer", "theta": 45.0},
        {"type": "polarizer", "theta": 0.0},
    ]))
    assert abs(mid[0] - 0.125) < 2e-3, mid
    qwp = _center_stokes(_stack_scene([
        {"type": "polarizer", "theta": 90.0},
        {"type": "retarder", "theta": 45.0, "delta": 90.0},
        {"type": "polarizer", "theta": 0.0},
    ]))
    assert abs(qwp[0] - 0.25) < 2e-3, qwp
    hwp = _center_stokes(_stack_scene([
        {"type": "polarizer", "theta": 90.0},
        {"type": "retarder", "theta": 45.0, "delta": 180.0},
        {"type": "polarizer", "theta": 0.0},
    ]))
    assert abs(hwp[0] - 0.5) < 2e-3, hwp


def test_circular_polarizer_s3():
    """Circular polarizer produces pure S3 of magnitude S0."""
    s = _center_stokes(_stack_scene([{"type": "circular"}]))
    assert abs(s[0] - 0.5) < 1e-3, s
    assert abs(abs(s[3]) - s[0]) < 1e-3, s
    assert abs(s[1]) < 1e-3 and abs(s[2]) < 1e-3, s


def test_fresnel_reflection_partially_polarizes():
    """Oblique specular reflection off a conductor: DOP in (0, 1), and the
    S0 image matches the scalar render (normalized Mueller design)."""
    d = {
        "type": "scene",
        "integrator": {"type": "stokes", "max_depth": 3},
        "sensor": {
            "type": "perspective", "fov": 30.0,
            # look at the mirror floor at ~55deg incidence
            "to_world": lr.Transform().look_at([0, 2.0, 2.8], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 8, "height": 8,
                     "rfilter": {"type": "box"}},
        },
        "floor": {"type": "rectangle",
                  "to_world": lr.Transform().rotate([1, 0, 0], -90)
                  .scale(4.0),
                  "bsdf": {"type": "conductor", "material": "au"}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }
    # note: rectangle normal +z; rotate so it faces +y (floor)
    d["floor"]["to_world"] = lr.Transform().rotate([1, 0, 0], -90) \
        .scale(4.0)
    scene = lr.load_dict(d)
    img = lr.render_stokes(scene, spp=32, seed=0)
    s = img[5, 4].mean(-1)          # a floor-reflection pixel, rgb-avg
    dop = np.sqrt(s[1] ** 2 + s[2] ** 2 + s[3] ** 2) / max(s[0], 1e-9)
    assert 0.05 < dop < 1.0, (s, dop)

    d2 = dict(d)
    d2["integrator"] = {"type": "path", "max_depth": 3}
    scalar = np.asarray(lr.render(lr.load_dict(d2), spp=32, seed=0))
    s0 = img[..., 0, :]
    assert np.abs(s0 - scalar).max() < 5e-2, np.abs(s0 - scalar).max()


def test_stokes_s0_matches_path_with_area_light():
    """NEE consistency: on a small-area-light diffuse scene (where BSDF
    sampling alone converges slowly) the stokes integrator's S0 must match
    the path tracer, which shares the same NEE+MIS estimator."""
    import numpy as np

    d = {
        "type": "scene",
        "integrator": {"type": "stokes", "max_depth": 3},
        "sensor": {
            "type": "perspective", "fov": 45,
            "to_world": lr.Transform().look_at(
                origin=[0, 0, 4], target=[0, 0, 0], up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 12, "height": 12,
                     "rfilter": {"type": "box"}},
        },
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse"}},
        "lamp": {
            "type": "rectangle",
            "to_world": lr.Transform().translate([0, 0, 3.0]).scale(0.15),
            "emitter": {"type": "area",
                        "radiance": {"type": "rgb", "value": [40.0] * 3}},
        },
    }
    sc_st = lr.load_dict(d)
    from liverrenderer.integrators.stokes import render_stokes
    S = render_stokes(sc_st, spp=196, seed=0)          # (h, w, 4, 3)
    d["integrator"] = {"type": "path", "max_depth": 3}
    sc_pt = lr.load_dict(d)
    img = np.asarray(lr.render(sc_pt, spp=196, seed=1))
    s0 = S[..., 0, :]
    rel = abs(float(s0.mean()) - float(img.mean())) / max(img.mean(), 1e-6)
    assert rel < 0.05, (s0.mean(), img.mean())


# ---------------------------------------------------------------------------
# Spectral x polarized variant (round 5): the Stokes loop carries an
# (N, N_SPEC, 4) wavelength-packet state (reference *_spectral_polarized
# builds, fwd.h:216) and CIE-converts each component at the end.
# ---------------------------------------------------------------------------

def _stack_scene_spectral(elements, radiance=1.0, max_depth=8):
    d = {
        "type": "scene",
        "integrator": {"type": "stokes", "max_depth": max_depth},
        "sensor": {
            "type": "perspective", "fov": 10.0,
            "to_world": lr.Transform().look_at([0, 0, 3], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 4, "height": 4,
                     "rfilter": {"type": "box"}},
        },
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [radiance] * 3}},
    }
    for i, el in enumerate(elements):
        d[f"el{i}"] = {
            "type": "rectangle",
            "to_world": lr.Transform().translate([0, 0, 2.0 - 0.5 * i]),
            "bsdf": el,
        }
    return lr.load_dict(d, variant="spectral")


@pytest.mark.parametrize("theta2", [0.0, 30.0, 60.0, 90.0])
def test_spectral_malus_law(theta2):
    """Malus's law holds per wavelength, and the flat (white) env makes
    the CIE conversion exact — the spectral x polarized S0 must match
    0.5 cos^2(dtheta) like the RGB variant."""
    s = _center_stokes(_stack_scene_spectral([
        {"type": "polarizer", "theta": theta2},
        {"type": "polarizer", "theta": 0.0},
    ]), spp=64)
    expect = 0.5 * np.cos(np.deg2rad(theta2)) ** 2
    assert abs(s[0] - expect) < 0.02, (theta2, s[0], expect)


def test_spectral_stokes_matches_rgb_fresnel():
    """45-degree conductor reflection: the spectral x polarized render's
    degree/angle of polarization must match the RGB stokes render
    (metamerism only scales the channels, not the polarization state)."""
    def scene(variant=None):
        d = {
            "type": "scene",
            "integrator": {"type": "stokes", "max_depth": 4},
            "sensor": {
                "type": "perspective", "fov": 20.0,
                "to_world": lr.Transform().look_at([3, 0, 3], [0, 0, 0],
                                                   [0, 1, 0]),
                "film": {"type": "hdrfilm", "width": 8, "height": 8,
                         "rfilter": {"type": "box"}},
            },
            "mirror": {"type": "rectangle",
                       "to_world": lr.Transform().scale(2.0),
                       "bsdf": {"type": "conductor", "material": "Au"}},
            "env": {"type": "constant",
                    "radiance": {"type": "rgb", "value": [1.0] * 3}},
        }
        return lr.load_dict(d, variant=variant)

    rgb = lr.render_stokes(scene(), spp=32, seed=0)
    sp = lr.render_stokes(scene("spectral"), spp=64, seed=0)
    assert np.isfinite(sp).all()
    # images are (h, w, 4, 3): average the center block per component
    s_r = rgb[2:6, 2:6].mean((0, 1))      # (4, 3)
    s_s = sp[2:6, 2:6].mean((0, 1))
    # degree of linear polarization per channel-mean
    def dop(s):
        return np.sqrt(s[1].mean() ** 2 + s[2].mean() ** 2) \
            / max(s[0].mean(), 1e-9)
    assert abs(dop(s_s) - dop(s_r)) < 0.08, (dop(s_r), dop(s_s))
    # S0 energy within metamerism bounds
    assert abs(s_s[0].mean() - s_r[0].mean()) / s_r[0].mean() < 0.15
