"""Measurement & batch sensors (reference src/sensors/{distant,
radiancemeter,irradiancemeter,batch}.cpp)."""
import numpy as np

import liverrenderer as lr


def _env_only(sensor, radiance=1.0, extra=None):
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": sensor,
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [radiance] * 3}},
    }
    if extra:
        d.update(extra)
    return d


def _film(w=4, h=4):
    return {"type": "hdrfilm", "width": w, "height": h,
            "rfilter": {"type": "box"}}


def test_radiancemeter_reads_env():
    scene = lr.load_dict(_env_only({
        "type": "radiancemeter",
        "to_world": lr.Transform().look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]),
        "film": _film(1, 1)}, radiance=2.5))
    img = np.asarray(lr.render(scene, spp=16, seed=0))
    assert np.allclose(img, 2.5, rtol=1e-3), img


def test_distant_sees_floor():
    # unit-albedo floor under a constant env: the distant sensor looking
    # straight down reads the floor's outgoing radiance where it hits
    scene = lr.load_dict(_env_only({
        "type": "distant", "direction": [0, 0, -1],
        "film": _film(8, 8)}, extra={
            "floor": {"type": "rectangle",
                      "to_world": lr.Transform().scale(0.25),
                      "bsdf": {"type": "diffuse",
                               "reflectance": {"type": "rgb",
                                               "value": [0.8] * 3}}}}))
    img = np.asarray(lr.render(scene, spp=64, seed=0))
    assert np.isfinite(img).all()
    # center pixels hit the small floor; a diffuse surface under a uniform
    # env reflects rho * L
    assert abs(img[4, 4].mean() - 0.8) < 0.15, img[4, 4]
    # the disk covers the whole bsphere: mid-edge rays overshoot the
    # square floor's half-width and see the env
    assert abs(img[4, 0].mean() - 1.0) < 0.05, img[4, 0]


def test_distant_target_point():
    scene = lr.load_dict(_env_only({
        "type": "distant", "direction": [0, 0, -1], "target": [0, 0, 0],
        "film": _film(2, 2)}, extra={
            "floor": {"type": "rectangle",
                      "to_world": lr.Transform().scale(0.25),
                      "bsdf": {"type": "diffuse",
                               "reflectance": {"type": "rgb",
                                               "value": [0.5] * 3}}}}))
    img = np.asarray(lr.render(scene, spp=32, seed=0))
    # all rays aim at the target -> all pixels see the floor
    assert np.all(np.abs(img.mean(-1) - 0.5) < 0.12), img


def test_irradiancemeter_uniform_env():
    # E of a uniform environment L=1 on any surface point is pi
    scene = lr.load_dict(_env_only({"type": "dummy"}, extra={
        "probe": {"type": "sphere", "radius": 0.1,
                  "bsdf": {"type": "null"},
                  "sensor": {"type": "irradiancemeter",
                             "film": _film(2, 2)}}}))
    img = np.asarray(lr.render(scene, spp=128, seed=0))
    assert np.allclose(img, np.pi, rtol=0.05), img.mean()


def test_batch_two_views():
    def persp(ox):
        return {"type": "perspective", "fov": 45.0,
                "to_world": lr.Transform().look_at([ox, 0, -2], [ox, 0, 0],
                                                   [0, 1, 0])}
    floor = {"floor": {"type": "rectangle",
                       "bsdf": {"type": "diffuse",
                                "reflectance": {"type": "rgb",
                                                "value": [0.6, 0.2, 0.1]}}}}
    batch = lr.load_dict(_env_only({
        "type": "batch", "a": persp(-0.4), "b": persp(0.4),
        "film": _film(16, 8)}, extra=floor))
    img_b = np.asarray(lr.render(batch, spp=32, seed=0))

    for i, ox in enumerate([-0.4, 0.4]):
        single = lr.load_dict(_env_only({**persp(ox), "film": _film(8, 8)},
                                        extra=floor))
        img_s = np.asarray(lr.render(single, spp=32, seed=0))
        half = img_b[:, i * 8:(i + 1) * 8]
        assert np.abs(half - img_s).mean() < 0.02, (i, np.abs(
            half - img_s).mean())
