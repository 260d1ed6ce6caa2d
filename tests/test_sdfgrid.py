"""SDF grid shape: sphere-traced signed-distance grids (reference
src/shapes/sdfgrid.cpp)."""
import numpy as np

import liverrenderer as lr


def _sphere_sdf(res=32, r=0.3):
    ax = (np.arange(res) + 0.5) / res
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
            - r).astype(np.float32)


def _scene(grid, to_world=None):
    return lr.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {
            "type": "perspective", "fov": 35.0,
            "to_world": lr.Transform().look_at([0.5, 0.5, 2.5],
                                               [0.5, 0.5, 0.5], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 16, "height": 16,
                     "rfilter": {"type": "box"}},
        },
        "sdf": {"type": "sdfgrid", "grid": grid,
                **({"to_world": to_world} if to_world else {}),
                "bsdf": {"type": "diffuse",
                         "reflectance": {"type": "rgb",
                                         "value": [0.1, 0.7, 0.1]}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    })


def test_sdf_sphere_silhouette():
    img = np.asarray(lr.render(_scene(_sphere_sdf()), spp=24, seed=0))
    assert np.isfinite(img).all()
    mid = img[8, 8]
    assert mid[1] > 2.0 * mid[0], mid        # green SDF sphere in the middle
    assert abs(img[1, 1].mean() - 1.0) < 0.1  # corners see the env


def test_sdf_normals_via_intersect():
    import jax.numpy as jnp
    from liverrenderer.accel.intersect import ray_intersect
    from liverrenderer.core.types import Ray

    scene = _scene(_sphere_sdf(48))
    ray = Ray(o=jnp.array([[0.5, 0.5, 2.5]]),
              d=jnp.array([[0.0, 0.0, -1.0]]),
              maxt=jnp.array([jnp.inf]))
    si = ray_intersect(scene, ray)
    assert bool(si.valid[0])
    # front of the sphere: z = 0.5 + 0.3, normal +z
    assert abs(float(si.t[0]) - (2.5 - 0.8)) < 0.02, si.t
    n = np.asarray(si.sh_frame.n[0])
    assert n[2] > 0.95, n


def test_sdf_casts_shadow():
    """ray_test sees SDF occluders (shadow rays in NEE)."""
    import jax.numpy as jnp
    from liverrenderer.accel.intersect import ray_test
    from liverrenderer.core.types import Ray

    scene = _scene(_sphere_sdf())
    hit = ray_test(scene, Ray(o=jnp.array([[0.5, 0.5, 2.5]]),
                              d=jnp.array([[0.0, 0.0, -1.0]]),
                              maxt=jnp.array([5.0])))
    miss = ray_test(scene, Ray(o=jnp.array([[0.5, 0.5, 2.5]]),
                               d=jnp.array([[0.0, 0.0, 1.0]]),
                               maxt=jnp.array([5.0])))
    assert bool(hit[0]) and not bool(miss[0])


def test_ellipsoids_instancing():
    """ellipsoids/ellipsoidsmesh shapes: (center, scale, quat) rows become
    instanced icospheres (src/shapes/ellipsoids*.cpp capability)."""
    rows = np.array([
        # center      scale            quat xyzw (identity)
        [0.0, 0, 0,   0.1, 0.1, 0.1,   0, 0, 0, 1],
        [0.5, 0, 0,   0.05, 0.2, 0.05, 0, 0, 0, 1],
    ], np.float32)
    scene = lr.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": lr.Transform().look_at([0.25, 0, 2.0],
                                               [0.25, 0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 16, "height": 16,
                     "rfilter": {"type": "box"}},
        },
        "blobs": {"type": "ellipsoidsmesh", "data": rows, "extent": 1.0,
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb",
                                           "value": [0.7, 0.1, 0.1]}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    })
    img = np.asarray(lr.render(scene, spp=24, seed=0))
    assert np.isfinite(img).all()
    # two red blobs left/right of center, gap between them sees the env
    left = img[8, 5]
    right = img[8, 10]
    assert left[0] > 2 * left[1], left
    assert right[0] > 2 * right[1], right
    assert abs(img[2, 8].mean() - 1.0) < 0.1
    assert abs(img[8, 0].mean() - 1.0) < 0.1
