"""RenderControl (integrators/regen.py): cooperative cancel, wall-clock
timeout, progress callbacks, and partial-film develop — the reference's
Integrator::cancel/should_stop/m_timeout semantics (integrator.h:290-302)
honored between the host scheduler's device executions."""
import numpy as np

import liverrenderer as lr
from liverrenderer.integrators import regen


def _scene():
    d = lr.cornell_box()
    d["integrator"] = {"type": "volpath", "max_depth": 3}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": 16, "height": 16,
                           "rfilter": {"type": "box"}}
    return lr.load_dict(d)


def test_cancel_mid_render_yields_partial_film(monkeypatch):
    scene = _scene()
    monkeypatch.setattr(regen, "TILE_PIX", 64)       # 4 tiles
    monkeypatch.setattr(regen, "EXEC_PATH_BUDGET", 64 * 2)
    monkeypatch.setattr(regen, "PROBE_PATHS", 64 * 2)
    calls = []
    ctl = lr.RenderControl()

    def on_progress(f):
        calls.append(f)
        if f >= 0.5:
            ctl.cancel()

    ctl.on_progress = on_progress
    img = np.asarray(lr.render(scene, spp=8, seed=0, control=ctl))
    assert ctl.stopped
    assert len(calls) > 0 and calls == sorted(calls)
    # rendered head, zero-weight (black) tail — a consistent partial film
    assert img[0].sum() > 0 and img[-1].sum() == 0.0
    pf = ctl.frame()
    assert pf is not None and pf.shape == (16, 16, 3)
    assert np.isfinite(pf).all()


def test_timeout_stops_before_first_execution(monkeypatch):
    scene = _scene()
    monkeypatch.setattr(regen, "TILE_PIX", 64)
    monkeypatch.setattr(regen, "EXEC_PATH_BUDGET", 64 * 2)
    monkeypatch.setattr(regen, "PROBE_PATHS", 64 * 2)
    ctl = lr.RenderControl(timeout=1e-9)
    img = np.asarray(lr.render(scene, spp=8, seed=0, control=ctl))
    assert ctl.stopped and img.sum() == 0.0


def test_uncancelled_control_matches_plain_render(monkeypatch):
    """A control that never fires must not change the image (the host
    partitioning it forces covers the same (pixel, sample) set)."""
    scene = _scene()
    ref = np.asarray(lr.render(scene, spp=8, seed=0))
    monkeypatch.setattr(regen, "TILE_PIX", 64)
    monkeypatch.setattr(regen, "PROBE_PATHS", 64 * 2)
    got = np.asarray(lr.render(scene, spp=8, seed=0,
                               control=lr.RenderControl()))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
