"""volprim_rf_basic — radiance-field ellipsoid (3DGS) integrator tests.

Mirrors the reference's volprim_rf_basic semantics
(ad/integrators/volprim_rf_basic.py): Gaussian-splat transmittance at the
ray-space peak, SH directional emission, front-to-back compositing,
sRGB->linear option, and PRB-style gradients.
"""
import jax.numpy as jnp
import numpy as np

import liverrenderer as lr

C0 = 0.28209479177387814       # Y_0^0


def splat_scene(rows, sh, opac, res=9, fov=10.0, cam_z=4.0, srgb=False,
                max_depth=16):
    return lr.load_dict({
        "type": "scene",
        "integrator": {"type": "volprim_rf_basic", "max_depth": max_depth,
                       "srgb_primitives": srgb},
        "sensor": {
            "type": "perspective", "fov": fov,
            "to_world": lr.Transform().look_at([0, 0, cam_z], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
        },
        "splats": {"type": "ellipsoids", "data": rows,
                   "opacities": opac, "sh_coeffs": sh},
    })


def _rows(centers, sigma):
    n = len(centers)
    rows = np.zeros((n, 10), np.float32)
    rows[:, 0:3] = centers
    rows[:, 3:6] = sigma
    rows[:, 9] = 1.0             # identity quaternion (x,y,z,w)
    return rows


def test_single_gaussian_head_on():
    """Ray through the splat center: peak density 1 => alpha = opacity;
    deg-0 SH with c0 = 0.5/Y00 gives emission exactly 1."""
    c0 = 0.5 / C0
    scene = splat_scene(_rows([[0, 0, 0]], 0.5),
                        sh=np.full((1, 1, 3), c0, np.float32),
                        opac=[0.7])
    img = np.asarray(lr.render(scene, spp=16, seed=0))
    center = img[4, 4]
    np.testing.assert_allclose(center, 0.7, rtol=0.02)
    assert np.isfinite(img).all()


def test_front_to_back_compositing():
    """Two splats along the axis: L = a1 e1 + (1 - a1) a2 e2."""
    c0 = 0.5 / C0
    scene = splat_scene(_rows([[0, 0, 1.0], [0, 0, -1.0]], 0.4),
                        sh=np.full((2, 1, 3), c0, np.float32),
                        opac=[0.7, 0.5])
    img = np.asarray(lr.render(scene, spp=16, seed=0))
    expect = 0.7 * 1.0 + (1 - 0.7) * 0.5 * 1.0
    np.testing.assert_allclose(img[4, 4], expect, rtol=0.02)


def test_sh_directional_emission():
    """A degree-1 z-band coefficient makes emission view-dependent:
    viewing from +z vs -z differ by 2 * Y10 * c (the splat itself is
    symmetric)."""
    c0 = 0.5 / C0
    sh = np.zeros((1, 4, 3), np.float32)
    sh[:, 0] = c0
    sh[:, 2] = 0.4               # z band: Y10 = 0.4886 z
    rows = _rows([[0, 0, 0]], 0.5)
    sc_front = splat_scene(rows, sh, [0.9], cam_z=4.0)
    sc_back = splat_scene(rows, sh, [0.9], cam_z=-4.0)
    a = float(np.asarray(lr.render(sc_front, spp=16, seed=0))[4, 4, 0])
    b = float(np.asarray(lr.render(sc_back, spp=16, seed=0))[4, 4, 0])
    # front camera looks along -z: Y10 d_z = -0.4886; back along +z
    exp_a = 0.9 * (0.5 - 0.4886025 * 0.4 + 0.5)
    exp_b = 0.9 * (0.5 + 0.4886025 * 0.4 + 0.5)
    np.testing.assert_allclose(a, exp_a, rtol=0.03)
    np.testing.assert_allclose(b, exp_b, rtol=0.03)


def test_srgb_primitives_conversion():
    """srgb_primitives=True converts composited radiance to linear."""
    from liverrenderer.core.spectrum import srgb_to_linear
    c0 = 0.5 / C0
    rows = _rows([[0, 0, 0]], 0.5)
    sh = np.full((1, 1, 3), c0, np.float32)
    lin = np.asarray(lr.render(splat_scene(rows, sh, [0.7], srgb=False),
                               spp=8, seed=0))[4, 4]
    srgb = np.asarray(lr.render(splat_scene(rows, sh, [0.7], srgb=True),
                                spp=8, seed=0))[4, 4]
    np.testing.assert_allclose(srgb, np.asarray(srgb_to_linear(lin)),
                               rtol=1e-3)


def test_opacity_gradient_vs_fd():
    """d(mean image)/d(opacity) through the bounded-scan adjoint matches
    finite differences (volprim_rf_basic.py PRB logic :146-166)."""
    c0 = 0.5 / C0
    rows = _rows([[0, 0, 1.0], [0, 0, -1.0]], 0.4)
    sh = np.full((2, 1, 3), c0, np.float32)
    scene = splat_scene(rows, sh, [0.6, 0.5])
    params = {"volprims.opacity": scene.volprims.opacity}
    loss_fn = lambda img: jnp.mean(img)
    loss, grads, img = lr.render_grad(scene, params, loss_fn, spp=8, seed=3)
    g = np.asarray(grads["volprims.opacity"])
    assert np.isfinite(g).all()

    eps = 1e-2
    for i in range(2):
        d = np.zeros(2, np.float32)
        d[i] = eps
        def at(dv):
            sc = lr.apply_params(
                scene, {"volprims.opacity":
                        scene.volprims.opacity + jnp.asarray(dv)})
            return float(jnp.mean(lr.render(sc, spp=8, seed=3)))
        fd = (at(d) - at(-d)) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=0.05, atol=1e-5)
