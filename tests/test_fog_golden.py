"""Fog-in-Cornell-box — the BASELINE.json
`cornell_box_1080x1080_fog_st_albedo` config (reference MitsubaRunner.py:
homogeneous fog, isotropic phase, attached as the *sensor* medium so the
camera starts inside the fog).

The shipped golden PNG provably mismatches the runner's fog parameters:
a (scale x albedo) forensic sweep (round 3, scale 0..2.5, albedo
0.75..0.95 at 192 spp) brackets the golden's brightness at scale ~1.0-1.25
— NOT the runner's 2.5 — and no gray-fog parameterization reproduces its
channel balance (golden R:G:B = 2.3:1.7:1 vs 3.0:1.9:1 for every sweep
point; structural correlation plateaus at ~0.92).  Decisive provenance
evidence (round 5): the SHIPPED MitsubaRunner.py does not even render
its fog dict — `scene = mi.load_dict(scene_components)` is immediately
OVERWRITTEN by `scene = mi.load_file("D:...medium_homogeneous_sss.xml")`
(MitsubaRunner.py:133-134, output_filename "bunny"), i.e. the script had
already been repurposed for an SSS experiment when the snapshot was
taken.  The golden therefore predates the shipped fog parameters twice
over and its true config is unrecoverable (no git history ships).  The
quantitative check is analytic — Beer-Lambert direct transmission of the
lamp through a purely absorbing fog — and the golden comparison is
structural (correlation of downsampled block means).
"""
import os

import numpy as np
import pytest

import liverrenderer as lr

GOLDEN = "/root/reference/cornell_box_1080x1080_fog_st_albedo.png"


def fog_scene(res=108, sigma=0.2, albedo=0.75, scale=2.5, max_depth=16):
    d = lr.cornell_box()
    d["integrator"] = {"type": "volpath", "max_depth": max_depth}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": "box"}}
    d["sensor"]["medium"] = {
        "type": "homogeneous",
        "sigma_t": {"type": "rgb", "value": [sigma] * 3},
        "albedo": {"type": "rgb", "value": [albedo] * 3},
        "scale": scale,
        "phase": {"type": "isotropic"},
    }
    return lr.load_dict(d)


def test_fog_direct_transmission_beer_lambert():
    """Lamp seen through a purely absorbing fog: pixel = L_e exp(-sigma d).
    Compares the fogged and fog-free renders of the same lamp pixels."""
    clear = lr.load_dict({**lr.cornell_box(),
                          "integrator": {"type": "volpath", "max_depth": 2}})
    clear = clear.replace(film_w=64, film_h=64)
    sigma_eff = 0.3 * 1.0
    foggy = fog_scene(64, sigma=sigma_eff, albedo=0.0, scale=1.0,
                      max_depth=2)

    img_c = np.asarray(lr.render(clear, spp=16, seed=0))
    img_f = np.asarray(lr.render(foggy, spp=16, seed=0))
    # lamp pixels (top center), distance camera->lamp plane
    lamp_c = img_c[8:11, 28:36].mean(axis=(0, 1))
    lamp_f = img_f[8:11, 28:36].mean(axis=(0, 1))
    ratio = (lamp_f / lamp_c).mean()
    # camera z=3.9, lamp at y=0.99 near z in [-0.23, 0.16]: path length
    # varies slightly over the lamp; accept the geometric spread
    d_lo, d_hi = 3.7, 4.3
    assert np.exp(-sigma_eff * d_hi) * 0.9 < ratio \
        < np.exp(-sigma_eff * d_lo) * 1.1, ratio


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden missing")
def test_fog_structure_matches_reference_golden():
    scene = fog_scene(res=108)           # 1080/10: box-downsample match
    img = np.asarray(lr.render(scene, spp=32, seed=0))
    assert np.isfinite(img).all()
    golden = lr.read_image(GOLDEN)
    g = golden.reshape(108, 10, 108, 10, 3).mean((1, 3))
    a = np.clip(img, 0, 1).reshape(12, 9, 12, 9, 3).mean((1, 3)).ravel()
    b = np.clip(g, 0, 1).reshape(12, 9, 12, 9, 3).mean((1, 3)).ravel()
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.95, corr
