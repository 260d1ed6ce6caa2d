"""Non-flattened instancing (reference src/shapes/{shapegroup,instance}.cpp).

The default shapegroup/instance path stores each group's triangle stream
ONCE in group-local space and composes per-instance transforms inside the
intersector (accel/intersect._instances); `flatten_instances=True` forces
the old geometry-replication path.  Both must agree: the instanced pass
transforms the shared triangles with the same vertex-then-subtract float
ops the flattening baker performs (the baker works in fp64 and rounds
once, the kernel works in fp32, so agreement is to fp32 rounding, not
bit-for-bit).
"""
import numpy as np
import jax.numpy as jnp
import pytest

import liverrenderer as lr
from liverrenderer.core.types import Ray
from liverrenderer.accel.intersect import ray_intersect


def _scene_dict(n_inst=3, light="point"):
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {
            "type": "perspective",
            "fov": 45,
            "to_world": lr.Transform().look_at(
                origin=[0, -6, 2], target=[0, 0, 0.3], up=[0, 0, 1]),
            "film": {"type": "hdrfilm", "width": 48, "height": 36,
                     "rfilter": {"type": "box"}},
        },
        "grp": {
            "type": "shapegroup", "id": "grp",
            "box": {"type": "cube",
                    "to_world": lr.Transform().scale(0.25),
                    "bsdf": {"type": "diffuse",
                             "reflectance": {"type": "rgb",
                                             "value": [0.7, 0.3, 0.2]}}},
            "cap": {"type": "rectangle",
                    "to_world": lr.Transform().translate([0, 0, 0.3])
                    .scale(0.2),
                    "bsdf": {"type": "diffuse",
                             "reflectance": {"type": "rgb",
                                             "value": [0.2, 0.6, 0.3]}}},
        },
        "floor": {"type": "rectangle",
                  "to_world": lr.Transform().translate([0, 0, -0.3])
                  .scale(8.0),
                  "bsdf": {"type": "diffuse"}},
    }
    if light == "point":
        d["light"] = {"type": "point", "position": [2, -3, 4],
                      "intensity": {"type": "rgb", "value": [60.0] * 3}}
    else:
        d["light"] = {"type": "constant",
                      "radiance": {"type": "rgb", "value": [0.8] * 3}}
    for i in range(n_inst):
        ang = 360.0 * i / max(n_inst, 1)
        d[f"inst{i}"] = {
            "type": "instance",
            "grp_ref": {"type": "ref", "id": "grp"},
            "to_world": lr.Transform()
            .translate([(i % 5) - 2.0, (i // 5) - 1.0, 0.0])
            .rotate([0, 0, 1], ang),
        }
    return d


def test_instanced_scene_builds():
    sc = lr.load_dict(_scene_dict(3))
    assert sc.n_instances == 3
    assert sc.inst_max_chunks >= 1
    # the group stream holds cube(12) + rectangle(2) = 14 tris (padded)
    assert sc.n_inst_tris >= 14
    # only the floor is in the global stream
    assert sc.n_tris == 2
    sf = lr.load_dict(_scene_dict(3), flatten_instances=True)
    assert sf.n_instances == 0
    assert sf.n_tris == 2 + 3 * 14


def test_geometry_memory_is_o1_in_instances():
    s10 = lr.load_dict(_scene_dict(10))
    s40 = lr.load_dict(_scene_dict(40))
    # shared group stream: identical size no matter the instance count
    assert s10.inst_tris.shape == s40.inst_tris.shape
    assert s10.inst_si.shape == s40.inst_si.shape
    assert s10.vertices.shape == s40.vertices.shape
    # per-instance cost: one 21-float transform row
    assert s40.inst_xf.shape == (40, 21)
    # the flattened path replicates geometry instead
    f10 = lr.load_dict(_scene_dict(10), flatten_instances=True)
    f40 = lr.load_dict(_scene_dict(40), flatten_instances=True)
    assert f40.n_tris - f10.n_tris == 30 * 14


def _primary_rays(scene, n=24):
    """Grid of rays from the sensor origin through the scene."""
    ys, xs = np.meshgrid(np.linspace(0.1, 0.9, n),
                         np.linspace(0.1, 0.9, n), indexing="ij")
    pos = np.stack([xs.ravel() * scene.film_w,
                    ys.ravel() * scene.film_h], -1).astype(np.float32)
    from liverrenderer.sensor.perspective import sample_ray
    return sample_ray(scene, jnp.asarray(pos))


def test_instanced_matches_flattened_intersection():
    si_ = lr.load_dict(_scene_dict(5))
    sf = lr.load_dict(_scene_dict(5), flatten_instances=True)
    ray = _primary_rays(si_)
    a = ray_intersect(si_, ray)
    b = ray_intersect(sf, ray)
    ha = np.asarray(np.isfinite(a.t))
    hb = np.asarray(np.isfinite(b.t))
    # hit masks equal except possible fp32-vs-fp64 grazing flips
    assert (ha != hb).mean() < 2e-3
    both = ha & hb
    ta, tb = np.asarray(a.t)[both], np.asarray(b.t)[both]
    assert np.allclose(ta, tb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.sh_frame.n)[both],
                               np.asarray(b.sh_frame.n)[both], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(a.shape)[both] >= 0,
                                  np.asarray(b.shape)[both] >= 0)
    # both shapes resolve to the same BSDF binding
    ba = np.asarray(si_.shape_bsdf)[np.asarray(a.shape)[both]]
    bb = np.asarray(sf.shape_bsdf)[np.asarray(b.shape)[both]]
    # bsdf indices may differ; compare the bound reflectance instead
    ra = np.asarray(si_.textures.data)[np.asarray(si_.bsdfs.tex0)[ba], :3]
    rb = np.asarray(sf.textures.data)[np.asarray(sf.bsdfs.tex0)[bb], :3]
    np.testing.assert_allclose(ra, rb, atol=1e-6)


@pytest.mark.parametrize("light", ["point", "constant"])
def test_instanced_matches_flattened_render(light):
    si_ = lr.load_dict(_scene_dict(4, light=light))
    sf = lr.load_dict(_scene_dict(4, light=light), flatten_instances=True)
    a = np.asarray(lr.render(si_, spp=32, seed=0))
    b = np.asarray(lr.render(sf, spp=32, seed=0))
    assert np.isfinite(a).all()
    # identical RNG per (pixel, sample): the only differences are fp32-
    # vs-fp64 geometry rounding (possible single-sample silhouette flips)
    assert np.abs(a - b).mean() < 2e-3
    assert np.abs(a - b).max() < 0.2


def test_many_instances_render():
    sc = lr.load_dict(_scene_dict(100, light="constant"))
    assert sc.n_instances == 100
    img = np.asarray(lr.render(sc, spp=4, seed=0))
    assert np.isfinite(img).all()
    assert img.mean() > 0.01
