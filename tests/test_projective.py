"""Projective (visibility/discontinuity) gradient tests.

Mirrors the reference's shape-translation AD configs
(src/integrators/tests/test_ad_integrators.py:142-467): an occluder in
front of an emissive plane; d(loss)/d(occluder translation) is dominated
by the visibility boundary term, which interior (reparam-free) gradients
miss entirely.  AD is checked against correlated finite differences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer as lr
from liverrenderer.integrators.projective import (
    boundary_gradient, edge_table, indirect_boundary_gradient,
    project_to_film)
from liverrenderer.scene.builder import load_dict


def _occluder_scene(res=24):
    """Bright emissive background plane + dark occluder quad in front."""
    return load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": lr.Transform().look_at([0, 0, 2.0], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
        },
        "bg": {"type": "rectangle",
               "to_world": lr.Transform().translate([0, 0, -1.0]).scale(3.0),
               "emitter": {"type": "area",
                           "radiance": {"type": "rgb", "value": [4.0] * 3}}},
        "occ": {"type": "rectangle",
                "to_world": lr.Transform().scale(0.4),
                "bsdf": {"type": "diffuse",
                         "reflectance": {"type": "rgb",
                                         "value": [0.02] * 3}}},
    })


def test_edge_table():
    """Unique edges + adjacency for a 2-triangle quad: 5 edges, the
    diagonal shared, the 4 rim edges boundary."""
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    ev, ef = edge_table(F, 2)
    ev, ef = np.asarray(ev), np.asarray(ef)
    assert ev.shape == (5, 2)
    shared = (ef[:, 1] >= 0)
    assert shared.sum() == 1
    d = ev[shared][0]
    assert sorted(d.tolist()) == [0, 2]
    assert (ef[~shared, 1] == -1).all()


def test_project_to_film_roundtrip():
    """project_to_film inverts the sensor's film->ray map: a ray traced
    from film position q projects back to q at any t>0."""
    scene = _occluder_scene(res=16)
    from liverrenderer.sensor.perspective import sample_ray
    q = jnp.array([[3.25, 7.5], [0.5, 0.5], [15.0, 12.0]])
    ray = sample_ray(scene, q)
    p = ray.o + 1.7 * ray.d
    q2 = project_to_film(scene, p)
    np.testing.assert_allclose(np.asarray(q2), np.asarray(q), atol=1e-3)


def test_occluder_translation_gradient_vs_fd():
    """Moving the occluder's right edge outward covers more of the bright
    background: the mean-image derivative is negative and must match FD.
    This gradient is ~purely the boundary term (the occluder is nearly
    black, so interior shading terms are negligible)."""
    scene = _occluder_scene()
    V = np.asarray(scene.vertices)
    sel = (np.abs(V[:, 0] - 0.4) < 1e-4) & (np.abs(V[:, 2]) < 1e-4)
    assert sel.sum() == 2
    mask = np.zeros_like(V)
    mask[sel, 0] = 1.0
    mask = jnp.asarray(mask)

    loss_fn = lambda img: jnp.mean(img)
    params = {"vertices": scene.vertices}
    loss, grads, img = lr.render_grad(scene, params, loss_fn, spp=128,
                                      seed=5)
    g = grads["vertices"]
    assert bool(jnp.all(jnp.isfinite(g)))
    g_x = float(jnp.sum(g * mask))

    eps = 0.05
    def loss_at(d):
        sc = lr.apply_params(scene,
                             {"vertices": scene.vertices + d * mask})
        return float(jnp.mean(lr.render(sc, spp=512, seed=11)))
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert fd < -0.5          # growing the dark occluder darkens the image
    np.testing.assert_allclose(g_x, fd, rtol=0.2)


def _mirror_scene(res=24, alpha=0.1):
    """Occluder visible ONLY via a rough-mirror reflection: camera looks
    at a roughconductor plate; a dark quad floats BEHIND the camera,
    blocking part of the bright constant environment in the reflection.
    The reference's indirect-projective configuration
    (prb_projective.py:8, ad/projective.py:614-833)."""
    return load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": lr.Transform().look_at([0, 0, 2.0], [0, 0, -1.0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
        },
        "mirror": {"type": "rectangle",
                   "to_world": lr.Transform().translate([0, 0, -1.0])
                   .scale(3.0),
                   "bsdf": {"type": "roughconductor", "material": "Al",
                            "alpha": alpha}},
        "occ": {"type": "rectangle",
                "to_world": lr.Transform().translate([0, 0, 2.5])
                .scale(0.5),
                "bsdf": {"type": "diffuse",
                         "reflectance": {"type": "rgb",
                                         "value": [0.02] * 3}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [2.0] * 3}},
    })


def test_indirect_occluder_translation_gradient_vs_fd():
    """Growing the behind-the-camera occluder's right edge covers more of
    the bright environment in the rough-mirror reflection; interior terms
    are negligible (the occluder is nearly black and never directly
    visible), so the mean-image derivative is ~purely the INDIRECT
    boundary term.  AD (render_grad's indirect_boundary_gradient) must
    match correlated FD.  (A rigid translation is a useless probe here:
    it slides the reflected silhouette without changing its area, so the
    mean image is invariant.)"""
    scene = _mirror_scene()
    V = np.asarray(scene.vertices)
    # the occluder quad's x = +0.5 edge (2 vertices) moves outward
    occ = (np.abs(V[:, 2] - 2.5) < 1e-4) & (V[:, 0] > 0.4)
    assert occ.sum() == 2
    mask = np.zeros_like(V)
    mask[occ, 0] = 1.0
    mask = jnp.asarray(mask)

    loss_fn = lambda img: jnp.mean(img)
    params = {"vertices": scene.vertices}
    loss, grads, img = lr.render_grad(scene, params, loss_fn, spp=64,
                                      seed=5)
    g = grads["vertices"]
    assert bool(jnp.all(jnp.isfinite(g)))
    g_x = float(jnp.sum(g * mask))

    eps = 0.08
    def loss_at(d):
        sc = lr.apply_params(scene,
                             {"vertices": scene.vertices + d * mask})
        return float(jnp.mean(lr.render(sc, spp=512, seed=11)))
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert abs(fd) > 1e-3            # the silhouette does move the loss
    np.testing.assert_allclose(g_x, fd, rtol=0.35)


def test_indirect_boundary_zero_when_directly_visible_only():
    """In the primary-occluder scene (no specular chain), the indirect
    term must be near zero — the boundary is fully accounted for by the
    primary film-space term, and double counting would break the
    FD match of test_occluder_translation_gradient_vs_fd."""
    from liverrenderer.integrators.projective import \
        indirect_boundary_gradient
    scene = _occluder_scene(res=16)
    delta = jnp.ones((16, 16, 3)) / (16 * 16 * 3)
    g = indirect_boundary_gradient(scene, {"vertices": scene.vertices},
                                   delta, seed=3, n_samples=1 << 12)
    assert bool(jnp.all(jnp.isfinite(g)))
    # scale: compare against the PRIMARY term's magnitude in this scene
    gp = boundary_gradient(scene, {"vertices": scene.vertices}, delta,
                           seed=3, n_samples=1 << 12)
    assert float(jnp.linalg.norm(g)) < 0.05 * float(jnp.linalg.norm(gp))


def test_boundary_gradient_zero_without_silhouette_in_view():
    """A scene whose only mesh fills the whole view has no visible
    silhouette: the boundary term must be (near) zero, not noise."""
    scene = load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": lr.Transform().look_at([0, 0, 2.0], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 16, "height": 16,
                     "rfilter": {"type": "box"}},
        },
        "wall": {"type": "rectangle",
                 "to_world": lr.Transform().scale(8.0),
                 "bsdf": {"type": "diffuse",
                          "reflectance": {"type": "rgb",
                                          "value": [0.5] * 3}}},
        "lamp": {"type": "point",
                 "position": [0, 0, 1.5],
                 "intensity": {"type": "rgb", "value": [5.0] * 3}},
    })
    delta = jnp.ones((16, 16, 3)) / (16 * 16 * 3)
    g = boundary_gradient(scene, {"vertices": scene.vertices}, delta,
                          seed=3, n_samples=1 << 12)
    assert bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.linalg.norm(g)) < 1e-4


def test_grid_distr_importance_sampling():
    """GridDistr (ad/guiding.py GridDistr analog): importance-sampling a
    separable function with a mass-matched grid reproduces its integral,
    and empirical cell frequencies track the mass."""
    import jax.numpy as jnp
    from liverrenderer.core.rng import make_sampler
    from liverrenderer.integrators.guiding import (grid_cell_of,
                                                       grid_from_mass,
                                                       grid_sample)
    res = (4, 4, 4)
    # mass ~ f(x) = x0 (cell-averaged), integral of f over U^3 = 0.5
    centers = (np.arange(4) + 0.5) / 4
    mass = np.broadcast_to(centers[:, None, None], res)
    distr = grid_from_mass(jnp.asarray(mass), res)
    n = 1 << 14
    smp = make_sampler(jnp.arange(n, dtype=jnp.uint32), 0, 7,
                       kind="independent")
    u1, smp = smp.next_2d()
    u2, smp = smp.next_2d()
    u = jnp.concatenate([u1, u2], -1)
    p, rcp = grid_sample(distr, u)
    est = float(jnp.mean(p[:, 0] * rcp))
    assert abs(est - 0.5) < 0.01, est
    # frequency of the densest x-slab ~ mass fraction 3.5/8
    cells = np.asarray(grid_cell_of(distr, p))
    frac = (cells >= 3 * 16).mean()
    assert abs(frac - 3.5 / 8) < 0.02, frac


def test_edge_guided_weights_defensive_mixture():
    """Pilot mass concentrates the distribution but every silhouette edge
    keeps nonzero probability (unbiasedness)."""
    import jax.numpy as jnp
    from liverrenderer.integrators.guiding import edge_guided_weights
    base = jnp.array([1.0, 1.0, 1.0, 0.0])      # edge 3 not a silhouette
    mass = jnp.array([5.0, 5.0])
    e_idx = jnp.array([1, 1])
    w = np.asarray(edge_guided_weights(mass, e_idx, base, uniform_frac=0.25))
    assert w[3] == 0.0
    assert w[1] > w[0] > 0.0 and w[2] > 0.0
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-5)
    # all pilot mass on edge 1 -> its weight = 0.75 + 0.25/3
    np.testing.assert_allclose(w[1], 0.75 + 0.25 / 3, rtol=1e-5)


def test_octree_guiding_distribution():
    """OcSpaceDistr (ad/guiding.py:141-568 analog): unbiased importance
    sampling of U^3 with adaptive refinement around pilot mass."""
    import jax.numpy as jnp
    from liverrenderer.integrators.guiding import octree_from_samples

    rng = np.random.default_rng(3)
    center = np.array([0.2, 0.3, 0.7])
    pts = np.clip(rng.normal(center, 0.05, (20000, 3)), 0, 1)
    oc = octree_from_samples(pts, np.ones(len(pts)))
    assert oc.pmf.shape[0] > 64           # actually refined
    np.testing.assert_allclose(float(oc.cdf[-1]), 1.0, atol=1e-5)

    u = rng.random((100000, 4)).astype(np.float32)
    p, dens = oc.sample(jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1:4]))
    p, dens = np.asarray(p), np.asarray(dens)
    assert (dens > 0).all()
    # unbiased: E[f/dens] = integral of f
    f = np.exp(-np.sum((p - center) ** 2, -1) / (2 * 0.05 ** 2))
    est = (f / dens).mean()
    exact = (2 * np.pi * 0.05 ** 2) ** 1.5
    np.testing.assert_allclose(est, exact, rtol=0.05)
    # concentration: >half the samples land in the pilot blob's 3-sigma
    # box (2.7% of the domain volume)
    assert (np.abs(p - center) < 0.15).all(-1).mean() > 0.5


def test_octree_guided_indirect_matches_uniform():
    """Octree-guided indirect boundary gradients estimate the same
    integral as the uniform sampler (different variance, same mean)."""
    import jax.numpy as jnp
    from liverrenderer.integrators.projective import (
        indirect_boundary_gradient)

    scene = _mirror_scene()
    params = {"vertices": scene.vertices}
    delta = jnp.ones((scene.film_h, scene.film_w, 3)) / (
        scene.film_h * scene.film_w * 3)
    g_u = np.asarray(indirect_boundary_gradient(
        scene, params, delta, seed=5, n_samples=1 << 14, guiding="none"))
    g_o = np.asarray(indirect_boundary_gradient(
        scene, params, delta, seed=5, n_samples=1 << 14,
        guiding="octree"))
    assert np.isfinite(g_o).all()
    # same estimand: the dominant components agree in sign and scale
    nu, no = np.linalg.norm(g_u), np.linalg.norm(g_o)
    if nu > 1e-7:
        assert 0.3 < no / nu < 3.0, (nu, no)
        corr = float((g_u * g_o).sum() / (nu * no))
        assert corr > 0.5, corr


def _two_mirror_scene(res=24, alpha=0.08):
    """Occluder silhouette visible ONLY after TWO bounces: camera ->
    45-degree rough mirror A -> rough mirror B -> dark quad floating over
    B against the bright environment.  The reference PSIntegrator samples
    boundary segments at arbitrary path depth (prb_projective.py:8,
    ad/projective.py:28-190); depth_max=1 cannot see this silhouette."""
    return load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 5},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": lr.Transform().look_at([0, 0, 2.0], [0, 0, -1.0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
        },
        "mirrorA": {"type": "rectangle",
                    "to_world": lr.Transform().translate([0, 0, -1.0])
                    .rotate([0, 1, 0], 45).scale(2.5),
                    "bsdf": {"type": "roughconductor", "material": "Al",
                             "alpha": alpha}},
        "mirrorB": {"type": "rectangle",
                    "to_world": lr.Transform().translate([3.0, 0, -1.0])
                    .rotate([0, 1, 0], -45).scale(2.0),
                    "bsdf": {"type": "roughconductor", "material": "Al",
                             "alpha": alpha}},
        "occ": {"type": "rectangle",
                "to_world": lr.Transform().translate([3.0, 0, 2.5])
                .scale(0.4),
                "bsdf": {"type": "diffuse",
                         "reflectance": {"type": "rgb",
                                         "value": [0.02] * 3}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [2.0] * 3}},
    })


def test_deep_indirect_occluder_gradient_vs_fd():
    """Arbitrary-depth projective gradients (VERDICT r4 #7): growing the
    occluder's right edge covers more bright environment in the DOUBLE
    reflection.  depth_max=2 must match correlated FD; depth_max=1 sees
    only a small leakage fraction (the silhouette needs two bounces)."""
    scene = _two_mirror_scene()
    V = np.asarray(scene.vertices)
    sel = (np.abs(V[:, 2] - 2.5) < 1e-4) & (V[:, 0] > 3.2)
    assert sel.sum() == 2
    mask = np.zeros_like(V)
    mask[sel, 0] = 1.0
    mask = jnp.asarray(mask)

    h, w = scene.film_h, scene.film_w
    delta = jnp.ones((h, w, 3)) / (h * w * 3)     # d(mean image)/dI
    params = {"vertices": scene.vertices}
    g2 = indirect_boundary_gradient(scene, params, delta, seed=3,
                                    n_samples=1 << 15, guiding="none",
                                    depth_max=2)
    g2_x = float(jnp.sum(g2 * mask))
    g1 = indirect_boundary_gradient(scene, params, delta, seed=3,
                                    n_samples=1 << 15, guiding="none",
                                    depth_max=1)
    g1_x = float(jnp.sum(g1 * mask))

    eps = 0.15
    def loss_at(d):
        sc = lr.apply_params(scene,
                             {"vertices": scene.vertices + d * mask})
        return float(jnp.mean(lr.render(sc, spp=256, seed=11)))
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert fd < -0.01                  # the deep silhouette moves the loss
    np.testing.assert_allclose(g2_x, fd, rtol=0.35)
    # the one-bounce estimator misses most of it
    assert abs(g1_x) < 0.45 * abs(fd)
