"""PRB replay adjoint (integrators/prb_replay.py) correctness.

Strategy mirrors the reference's AD-integrator tests
(src/integrators/tests/test_ad_integrators.py): analytic/FD checks plus
estimator agreement between the two adjoints (scan vs replay) with the
same counter RNG — identical seeds walk identical paths, so the
gradients must agree to fp tolerance, not just in distribution.
"""
import jax.numpy as jnp
import numpy as np

import liverrenderer as lr
from liverrenderer.scene.builder import load_dict


def _slab_scene(sigma_t=0.6, albedo=0.0, rfilter="box", res=4):
    return load_dict({
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 8},
        "sensor": {
            "type": "perspective", "fov": 3.0,
            "to_world": lr.Transform().look_at([0, 0, 5], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": rfilter}},
        },
        "ball": {"type": "sphere", "radius": 1.0, "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous",
                              "sigma_t": {"type": "rgb",
                                          "value": [sigma_t] * 3},
                              "albedo": {"type": "rgb",
                                         "value": [albedo] * 3}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    })


def _loss(img):
    return jnp.mean(img)


def test_replay_applicable_detection():
    from liverrenderer.integrators.prb_replay import replay_applicable
    scene = _slab_scene()
    assert replay_applicable(scene, {"media.params": scene.media.params}, 32)
    # sensor params fall back to the scan adjoint
    assert not replay_applicable(scene, {"sensor.to_world": 0}, 32)


def test_replay_sigma_gradient_analytic():
    """Absorbing slab: L = exp(-2 sigma) so dL/dsigma = -2 L (the
    reference's differentiable-delta-tracking sanity check)."""
    scene = _slab_scene()
    params = {"media.params": scene.media.params}
    loss, grads, img = lr.render_grad(scene, params, _loss, spp=512, seed=5,
                                      replay=True)
    g = np.asarray(grads["media.params"])[0, 0:3].sum()
    L = float(np.asarray(img).mean())
    np.testing.assert_allclose(g, -2.0 * L, rtol=0.1)


def test_replay_matches_scan_adjoint_scattering():
    """Scattering medium (suffix-radiance path exercised): same seed =>
    same paths => the two adjoints agree to fp tolerance."""
    scene = _slab_scene(sigma_t=1.2, albedo=0.7)
    params = {"media.params": scene.media.params}
    _, g_r, img_r = lr.render_grad(scene, params, _loss, spp=64, seed=3,
                                   replay=True)
    _, g_s, img_s = lr.render_grad(scene, params, _loss, spp=64, seed=3,
                                   replay=False)
    a = np.asarray(g_r["media.params"])
    b = np.asarray(g_s["media.params"])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    cos = (a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
    assert cos > 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(a), np.linalg.norm(b),
                               rtol=0.02)
    # the primal image is the stock regen estimate either way
    np.testing.assert_allclose(np.asarray(img_r), np.asarray(img_s),
                               rtol=1e-4, atol=1e-5)


def test_replay_applicable_tent_and_large_films():
    """Round-3 coverage: the reference's RBIntegrator works at any film
    size/filter (common.py:625-783) — tent filters and 1080p-class films
    must route to the replay adjoint (tiled schedule), not the 6x scan."""
    from liverrenderer.integrators.prb_replay import replay_applicable
    scene = _slab_scene(rfilter="tent")
    assert replay_applicable(scene, {"media.params": scene.media.params}, 32)
    big = scene.replace(film_w=1920, film_h=1080)
    assert replay_applicable(big, {"media.params": big.media.params}, 256)


def test_replay_tent_filter_matches_scan():
    """Tent-filter delta (the 2x2 splat adjoint) against the scan adjoint,
    which differentiates the film.splat tent weights directly."""
    scene = _slab_scene(sigma_t=1.0, albedo=0.6, rfilter="tent", res=6)
    params = {"media.params": scene.media.params}
    _, g_r, _ = lr.render_grad(scene, params, _loss, spp=64, seed=11,
                               replay=True)
    _, g_s, _ = lr.render_grad(scene, params, _loss, spp=64, seed=11,
                               replay=False)
    a = np.asarray(g_r["media.params"])
    b = np.asarray(g_s["media.params"])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    cos = (a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
    assert cos > 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(a), np.linalg.norm(b),
                               rtol=0.02)


def test_replay_tiled_schedule_matches_single_walk(monkeypatch):
    """Forcing the tiled (tile x spp-chunk) schedule on a tiny scene must
    reproduce the single-walk gradients — the counter RNG walks identical
    paths under any partition of the sample budget."""
    from liverrenderer.integrators import prb_replay, regen
    scene = _slab_scene(sigma_t=1.2, albedo=0.7, res=8)
    params = {"media.params": scene.media.params}
    _, g_one, img_one = lr.render_grad(scene, params, _loss, spp=16, seed=3,
                                       replay=True)

    # 64 pixels -> 4 tiles of 16; pool cap 128 paths -> spp chunks of 8
    monkeypatch.setattr(regen, "TILE_PIX", 16)
    monkeypatch.setattr(prb_replay, "MAX_STORE_PATHS", 16 * 8)
    _, g_t, img_t = lr.render_grad(scene, params, _loss, spp=16, seed=3,
                                   replay=True)
    np.testing.assert_allclose(np.asarray(img_t), np.asarray(img_one),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_t["media.params"]),
                               np.asarray(g_one["media.params"]),
                               rtol=2e-3, atol=1e-7)

    # low-memory schedule (primal + re-forward per partition) agrees too
    monkeypatch.setattr(prb_replay, "POOL_BYTES_CAP", 0)
    _, g_lm, img_lm = lr.render_grad(scene, params, _loss, spp=16, seed=3,
                                     replay=True)
    np.testing.assert_allclose(np.asarray(img_lm), np.asarray(img_one),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_lm["media.params"]),
                               np.asarray(g_one["media.params"]),
                               rtol=2e-3, atol=1e-7)


def test_replay_env_radiance_gradient():
    """Env radiance is linear in the image: d mean(I) / d radiance through
    the env_weight cotangent path must match FD exactly."""
    scene = _slab_scene(sigma_t=0.3, albedo=0.5)
    params = {"emitters.params": scene.emitters.params}
    _, grads, img = lr.render_grad(scene, params, _loss, spp=128, seed=9,
                                   replay=True)
    g = np.asarray(grads["emitters.params"])[:, 0:3].sum()

    eps = 1e-2
    def loss_at(d):
        ep = scene.emitters.params.at[:, 0:3].add(d)
        sc = lr.apply_params(scene, {"emitters.params": ep})
        return float(jnp.mean(lr.render(sc, spp=128, seed=9)))
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=0.05)
    assert g > 0


def test_replay_path_family_fd():
    """Round 4: the replay adjoint covers the surface `path` family
    (path.cpp:194-345 + RBIntegrator semantics).  FD check on emitter
    radiance and texture albedo with the SAME seed (correlated FD — the
    counter RNG walks identical paths, so agreement is fp-tight)."""
    from liverrenderer.integrators.prb_replay import replay_applicable

    d = lr.cornell_box()
    d["integrator"] = {"type": "path", "max_depth": 4}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": 12, "height": 12,
                           "rfilter": {"type": "box"}}
    scene = lr.load_dict(d)
    params = {"textures.data": scene.textures.data,
              "emitters.params": scene.emitters.params}
    assert replay_applicable(scene, params, 8)

    spp = 16
    loss, grads, img = lr.render_grad(scene, params, _loss, spp=spp, seed=0,
                                      replay=True)
    assert np.isfinite(np.asarray(img)).all()

    for key in params:
        g = np.asarray(grads[key])
        assert np.isfinite(g).all()
        idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
        eps = 1e-2

        def loss_at(v):
            arr = np.asarray(params[key]).copy()
            arr[idx] = v
            sc = lr.apply_params(scene, {key: jnp.asarray(arr)})
            return float(_loss(lr.render(sc, spp=spp, seed=0)))

        v0 = float(np.asarray(params[key])[idx])
        fd = (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)
        np.testing.assert_allclose(g[idx], fd, rtol=5e-3, atol=1e-8)
