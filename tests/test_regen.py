"""Wavefront regeneration (integrators/regen.py): the regenerating renderer
must complete the exact sample budget and agree with the fixed wavefront."""
import numpy as np

import liverrenderer as lr
from liverrenderer import film as fm
from liverrenderer.integrators import regen
from liverrenderer.integrators.common import _render_jit


def _fog_scene(w=24):
    d = lr.cornell_box()
    d["integrator"]["type"] = "volpath"
    d["sensor"]["film"]["width"] = w
    d["sensor"]["film"]["height"] = w
    d["sensor"]["film"]["rfilter"] = {"type": "box"}
    # low albedo keeps every path well under the fixed loop's iteration cap
    # so the two renderers see identical per-sample paths
    d["fog"] = {"type": "cube", "to_world": lr.Transform().scale(0.99),
                "bsdf": {"type": "null"},
                "interior": {"type": "homogeneous",
                             "sigma_t": {"type": "rgb", "value": [0.5] * 3},
                             "albedo": {"type": "rgb", "value": [0.4] * 3}}}
    return lr.load_dict(d)


def test_regen_completes_budget_and_matches(monkeypatch):
    monkeypatch.setattr(regen, "REGEN_WAVEFRONT", 2048)  # force refills
    scene = _fog_scene()
    spp = 16
    acc = np.asarray(regen.render_regen(scene, 0, spp))
    # every sample accounted for, exactly spp per pixel (box filter)
    np.testing.assert_allclose(acc[..., 3], spp)
    img_r = np.asarray(fm.develop(acc))
    img_f = np.asarray(_render_jit(scene, 0, spp, spp, "primal"))
    # same counter-based RNG per (pixel, sample); the two paths differ only
    # in straggler-path iteration caps, so the images agree statistically
    assert abs(img_r.mean() - img_f.mean()) / img_f.mean() < 0.01
    diff = np.abs(img_r - img_f)
    assert np.quantile(diff, 0.99) < 0.02, np.quantile(diff, 0.99)


def test_regen_auto_selected():
    scene = _fog_scene()
    assert regen.regen_applicable(scene, "primal")
    assert not regen.regen_applicable(scene, "ad")
    # round 4: the surface family is regen-able too (path.cpp:194-345)
    assert regen.regen_applicable(
        scene.replace(integrator="path"), "primal")
    assert not regen.regen_applicable(
        scene.replace(integrator="aov"), "primal")


def test_regen_path_family_matches_fixed():
    """Surface `path` through the regenerating wavefront is bit-identical
    to the fixed wavefront (same counter RNG per (pixel, sample); surface
    lanes die by the depth gate so no iteration-cap divergence)."""
    d = lr.cornell_box()
    d["integrator"] = {"type": "path", "max_depth": 4}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": 16, "height": 16,
                           "rfilter": {"type": "box"}}
    scene = lr.load_dict(d)
    assert regen.regen_applicable(scene, "primal")
    spp = 8
    acc = np.asarray(regen.render_regen(scene, 0, spp))
    np.testing.assert_allclose(acc[..., 3], spp)
    img_r = np.asarray(fm.develop(acc))
    img_f = np.asarray(_render_jit(scene, 0, spp, spp, "primal"))
    np.testing.assert_allclose(img_r, img_f, rtol=1e-4, atol=1e-6)


def test_tiled_film_matches_untiled(monkeypatch):
    """Pixel-tiled regen (large-film mode) covers the same (pixel, sample)
    set with the same counter-seeded streams, so the image is identical to
    the single-tile render."""
    import numpy as np

    import liverrenderer as lr
    from liverrenderer.integrators import regen

    d = lr.cornell_box()
    d["integrator"] = {"type": "volpath", "max_depth": 3}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": 16, "height": 16,
                           "rfilter": {"type": "box"}}
    scene = lr.load_dict(d)

    img_whole = np.asarray(regen.render_regen(scene, 0, 4))
    monkeypatch.setattr(regen, "TILE_PIX", 64)   # 16x16 -> 4 tiles
    regen.render_regen._clear_cache()
    img_tiled = np.asarray(regen.render_regen(scene, 0, 4))
    monkeypatch.undo()
    regen.render_regen._clear_cache()
    np.testing.assert_allclose(img_tiled, img_whole, rtol=1e-5, atol=1e-6)


def test_tent_filter_regen_matches_fixed():
    """Tent-filter regen splats the same 2x2 filter taps as the fixed
    wavefront (GlissonCapsule/Parenchyma rfilter config)."""
    import numpy as np

    import liverrenderer as lr
    from liverrenderer.integrators import regen
    from liverrenderer.integrators.common import _render_jit
    from liverrenderer import film as film_mod

    d = lr.cornell_box()
    d["integrator"] = {"type": "volpath", "max_depth": 3}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": 16, "height": 16,
                           "rfilter": {"type": "tent"}}
    scene = lr.load_dict(d)
    assert regen.regen_applicable(scene, "primal")

    acc_r = np.asarray(regen.render_regen(scene, 0, 4))
    img_r = np.asarray(film_mod.develop(acc_r))
    img_f = np.asarray(_render_jit(scene, 0, 4, 4, "primal"))  # developed
    np.testing.assert_allclose(img_r, img_f, rtol=2e-4, atol=2e-5)


def test_host_schedule_matches_device(monkeypatch):
    """The host-driven (tile, spp-chunk) scheduler (bounded-execution path for
    big films / budgets) reproduces the one-shot device render exactly —
    same counter RNG per sample id regardless of partitioning."""
    import numpy as np

    import liverrenderer as lr
    from liverrenderer.integrators import regen

    d = lr.cornell_box()
    d["integrator"] = {"type": "volpath", "max_depth": 3}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": 16, "height": 16,
                           "rfilter": {"type": "box"}}
    scene = lr.load_dict(d)

    ref = np.asarray(regen.render_regen(scene, 0, 8))
    # force 4 pixel tiles x 2 spp chunks
    monkeypatch.setattr(regen, "TILE_PIX", 64)
    monkeypatch.setattr(regen, "EXEC_PATH_BUDGET", 64 * 4)
    got = np.asarray(regen.render_regen_host(scene, 0, 8))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    # single-partition short-circuit returns the device render unchanged
    monkeypatch.undo()
    got1 = np.asarray(regen.render_regen_host(scene, 0, 8))
    np.testing.assert_allclose(got1, ref, rtol=1e-6, atol=0)

    # tent filter: the host partition drops the same out-of-tile taps as
    # the device tiling, so equality holds there too
    d2 = lr.cornell_box()
    d2["integrator"] = {"type": "volpath", "max_depth": 3}
    d2["sensor"]["film"] = {"type": "hdrfilm", "width": 16, "height": 16,
                            "rfilter": {"type": "tent"}}
    sc2 = lr.load_dict(d2)
    monkeypatch.setattr(regen, "TILE_PIX", 64)
    regen.render_regen._clear_cache()
    ref2 = np.asarray(regen.render_regen(sc2, 0, 8))
    monkeypatch.setattr(regen, "EXEC_PATH_BUDGET", 64 * 4)
    got2 = np.asarray(regen.render_regen_host(sc2, 0, 8))
    np.testing.assert_allclose(got2, ref2, rtol=1e-5, atol=1e-6)
    monkeypatch.undo()
    regen.render_regen._clear_cache()


def test_rate_cached_schedule_matches_probed():
    """render_regen_host caches the probe-measured path rate per scene
    (round 5): the SECOND render of a scene runs full-size chunks from
    its first execution.  Any chunk partition walks bit-identical
    per-sample estimates (counter RNG), so probed and cached schedules
    agree up to float summation order."""
    import numpy as np

    import liverrenderer as lr
    from liverrenderer.integrators import regen

    d = lr.cornell_box()
    d["integrator"] = {"type": "path", "max_depth": 4}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": 32, "height": 32,
                           "rfilter": {"type": "box"}}
    sc = lr.load_dict(d)
    old = regen.SINGLE_EXEC_PATHS, regen.PROBE_PATHS
    try:
        regen.SINGLE_EXEC_PATHS = 1          # force the chunked path
        regen.PROBE_PATHS = 32 * 32 * 4
        regen._RATE_CACHE.clear()
        a = np.asarray(regen.render_regen_host(sc, 3, 16))
        assert regen._RATE_CACHE, "probe did not cache a rate"
        b = np.asarray(regen.render_regen_host(sc, 3, 16))
        ref = np.asarray(regen.render_regen(sc, 3, 16))
    finally:
        regen.SINGLE_EXEC_PATHS, regen.PROBE_PATHS = old
        regen._RATE_CACHE.clear()
    assert np.abs(a - b).max() < 1e-4
    assert np.abs(b - ref).max() < 1e-4
