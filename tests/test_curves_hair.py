"""Curve tube shapes + hair fiber BSDF end-to-end (reference
src/shapes/{linearcurve,bsplinecurve}.cpp + src/bsdfs/hair.cpp)."""
import numpy as np
import pytest

import liverrenderer as lr


def _curve_scene(shape, spp_film=24):
    return lr.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": lr.Transform().look_at([0, 0, 3], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": spp_film, "height": spp_film,
                     "rfilter": {"type": "box"}},
        },
        "curve": shape,
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    })


def test_linearcurve_tube_renders():
    scene = _curve_scene({
        "type": "linearcurve",
        "points": [[0, -1, 0], [0, 1, 0]], "radius": 0.3,
        "bsdf": {"type": "diffuse",
                 "reflectance": {"type": "rgb", "value": [0.9, 0.1, 0.1]}}})
    img = np.asarray(lr.render(scene, spp=32, seed=0))
    assert np.isfinite(img).all()
    mid = img[12, 12]
    # red tube fills the view center; reflectance dominates red channel
    assert mid[0] > 3 * mid[1], mid
    # off-curve column sees the white env
    assert abs(img[12, 1].mean() - 1.0) < 0.1


def test_bsplinecurve_from_file(tmp_path):
    pts = np.stack([np.linspace(-1, 1, 8), np.zeros(8),
                    0.3 * np.sin(np.linspace(0, np.pi, 8))], -1)
    f = tmp_path / "c.txt"
    f.write_text("\n".join(f"{p[0]} {p[1]} {p[2]} 0.1" for p in pts) + "\n")
    scene = _curve_scene({
        "type": "bsplinecurve", "filename": str(f),
        "bsdf": {"type": "diffuse"}})
    img = np.asarray(lr.render(scene, spp=16, seed=0))
    assert np.isfinite(img).all()
    # the horizontal strand crosses the middle rows
    assert img[11:14, 8:16].mean() < 0.95


def test_hair_on_curve_absorption():
    def render(sig):
        scene = _curve_scene({
            "type": "linearcurve",
            "points": [[0, -1, 0], [0, 1, 0]], "radius": 0.35,
            "bsdf": {"type": "hair",
                     "sigma_a": {"type": "rgb", "value": [sig] * 3}}},
            spp_film=16)
        return np.asarray(lr.render(scene, spp=48, seed=0))

    light = render(0.05)
    dark = render(3.0)
    assert np.isfinite(light).all() and np.isfinite(dark).all()
    # stronger absorption darkens the fiber (TT/TRT lobes attenuate)
    assert dark[6:10, 6:10].mean() < light[6:10, 6:10].mean()


def test_tangent_frames_on_tube():
    """Shading frame s-axis equals the fiber direction on a curve hit."""
    import jax.numpy as jnp
    from liverrenderer.accel.intersect import ray_intersect
    from liverrenderer.core.types import Ray

    scene = _curve_scene({
        "type": "linearcurve",
        "points": [[0, -1, 0], [0, 1, 0]], "radius": 0.3,
        "bsdf": {"type": "hair"}})
    ray = Ray(o=jnp.array([[0.0, 0.2, 3.0]]),
              d=jnp.array([[0.0, 0.0, -1.0]]),
              maxt=jnp.array([jnp.inf]))
    si = ray_intersect(scene, ray)
    assert bool(si.valid[0])
    s = np.asarray(si.sh_frame.s[0])
    assert abs(abs(s[1]) - 1.0) < 1e-3, s          # fiber runs along y
    n = np.asarray(si.sh_frame.n[0])
    assert n[2] > 0.7, n                           # radial normal toward cam
