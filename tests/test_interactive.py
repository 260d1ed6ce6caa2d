"""Interactive viewer loop (interactive.py): scripted-key camera drive,
accumulation restart on movement, and the ANSI framebuffer blit."""
import numpy as np

import liverrenderer as lr
from liverrenderer.interactive import FlyCamera, blit_ansi, \
    run_interactive


def _scene(w=12):
    d = lr.cornell_box()
    d["integrator"] = {"type": "path", "max_depth": 3}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": w, "height": w,
                           "rfilter": {"type": "box"}}
    return lr.load_dict(d)


def test_fly_camera_roundtrip():
    scene = _scene()
    m0 = np.asarray(scene.sensor.to_world)
    cam = FlyCamera(m0, speed=0.5)
    # reconstructing to_world from (pos, yaw, pitch) preserves the view
    # direction and position (roll is not represented, cornell has none)
    m1 = cam.to_world()
    np.testing.assert_allclose(m1[:3, 3], m0[:3, 3], atol=1e-5)
    d0 = m0[:3, 2] / np.linalg.norm(m0[:3, 2])
    np.testing.assert_allclose(m1[:3, 2], d0, atol=1e-5)

    # movement keys translate along the current basis
    p0 = cam.pos.copy()
    assert cam.apply_key("w")
    assert np.linalg.norm(cam.pos - p0) > 0.4
    assert cam.apply_key("LEFT")      # look keys change yaw
    assert not cam.apply_key("x")     # unknown key -> no change


def test_interactive_loop_scripted():
    scene = _scene()
    frames = []

    def cb(frame, acc, cam):
        frames.append((frame, np.asarray(acc).copy(), cam.pos.copy()))

    # 2 static frames (accumulate), move, 1 more frame, quit on budget
    acc, n = run_interactive(scene, spp=2, max_frames=4,
                             keys=[None, None, "w", None],
                             display=False, frame_callback=cb)
    assert n == 4 and len(frames) == 4
    assert np.isfinite(acc).all()
    # frames 0-1 share a camera; frame 2 moved (accumulation restarted)
    assert np.allclose(frames[0][2], frames[1][2])
    assert not np.allclose(frames[1][2], frames[2][2])
    # a 'q' key ends the loop early
    _, n_q = run_interactive(scene, spp=1, max_frames=10,
                             keys=[None, "q"], display=False)
    assert n_q == 1


def test_blit_ansi():
    img = np.zeros((6, 4, 3), np.float32)
    img[:, :, 0] = 1.0                       # pure red
    s = blit_ansi(img)
    rows = s.split("\n")
    assert len(rows) == 3                    # two pixels per cell row
    assert "\x1b[38;2;" in s and "▀" in s and s.endswith("\x1b[0m")
