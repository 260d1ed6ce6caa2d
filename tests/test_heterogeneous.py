"""Heterogeneous (grid) medium: null-scattering transport + grid gradients
(reference src/media/heterogeneous.cpp:163-194 + prbvolpath differentiable
delta tracking for grid densities)."""
import jax
import jax.numpy as jnp
import numpy as np

import liverrenderer as lr


def _grid_scene(density_scale=1.0, res=8):
    # linear density ramp along x inside a unit cube
    g = np.linspace(0.2, 1.0, res, dtype=np.float32)
    grid = np.broadcast_to(g[None, None, :], (res, res, res)).copy()
    return lr.load_dict({
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 4},
        "sensor": {
            "type": "perspective", "fov": 35.0,
            "to_world": lr.Transform().look_at([0.5, 0.5, 3.0],
                                               [0.5, 0.5, 0.5], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 8, "height": 8,
                     "rfilter": {"type": "box"}},
        },
        "box": {"type": "cube",
                "to_world": lr.Transform().translate([0.5, 0.5, 0.5])
                            .scale(0.5),
                "bsdf": {"type": "null"},
                "interior": {"type": "heterogeneous",
                             "sigma_t": {"type": "gridvolume", "data": grid,
                                         "to_world": lr.Transform()
                                         .translate([0, 0, 0])},
                             "scale": density_scale,
                             "albedo": {"type": "rgb", "value": [0.3] * 3}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    })


def test_grid_medium_attenuates():
    thin = np.asarray(lr.render(_grid_scene(0.5), spp=32, seed=0))
    thick = np.asarray(lr.render(_grid_scene(4.0), spp=32, seed=0))
    assert np.isfinite(thin).all() and np.isfinite(thick).all()
    # denser medium with low albedo darkens the view through the cube
    assert thick[3:5, 3:5].mean() < thin[3:5, 3:5].mean()


def test_grid_density_gradient():
    """d(image)/d(grid voxels) exists and is non-zero (prbvolpath's
    differentiable delta tracking capability for grid media)."""
    scene = _grid_scene(2.0)
    params = {"media.grids": scene.media.grids}

    def loss_fn(img):
        return jnp.mean(img)

    loss, grads, img = lr.render_grad(scene, params, loss_fn, spp=16,
                                      seed=2)
    g = np.asarray(grads["media.grids"])
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0
    # denser voxels (low albedo) darken the mean image: gradients are
    # predominantly negative where rays pass
    assert g.sum() < 0


def test_extended_phases_render():
    """blendphase / tabphase / sggx attach to media and render
    (src/phase/{blendphase,tabphase,sggx}.cpp)."""
    for phase in (
        {"type": "blendphase", "weight": 0.4,
         "a": {"type": "hg", "g": 0.5}, "b": {"type": "isotropic"}},
        {"type": "tabphase", "values": [0.2, 0.5, 1.0, 2.0, 1.0, 0.5]},
        {"type": "sggx", "S": [1.0, 0.3, 0.6, 0.0, 0.0, 0.0]},
    ):
        scene = lr.load_dict({
            "type": "scene",
            "integrator": {"type": "volpath", "max_depth": 6},
            "sensor": {
                "type": "perspective", "fov": 35.0,
                "to_world": lr.Transform().look_at([0, 0, 3], [0, 0, 0],
                                                   [0, 1, 0]),
                "film": {"type": "hdrfilm", "width": 8, "height": 8,
                         "rfilter": {"type": "box"}},
            },
            "box": {"type": "cube", "bsdf": {"type": "null"},
                    "to_world": lr.Transform().scale(0.6),
                    "interior": {"type": "homogeneous",
                                 "sigma_t": {"type": "rgb",
                                             "value": [1.5] * 3},
                                 "albedo": {"type": "rgb",
                                            "value": [0.8] * 3},
                                 "phase": phase}},
            "env": {"type": "constant",
                    "radiance": {"type": "rgb", "value": [1.0] * 3}},
        })
        img = np.asarray(lr.render(scene, spp=16, seed=0))
        assert np.isfinite(img).all(), phase["type"]
        assert 0.2 < img.mean() < 1.5, (phase["type"], img.mean())
