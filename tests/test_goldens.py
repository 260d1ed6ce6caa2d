"""Golden-image regression with a variance-aware z-test.

Analog of reference src/render/tests/test_renders.py:159-181: render the
scene, estimate per-pixel variance (moment accumulation), and
significance-test against the reference EXR golden instead of pixel-exact
comparison.  The golden is the reference renderer's own output
(/root/reference/cornell_box.exr, 256x256).
"""
import os

import numpy as np
import pytest

import liverrenderer as lr

GOLDEN = "/root/reference/cornell_box.exr"


def z_test(img, ref, var, spp, significance=0.01):
    """Per-pixel z-test (test_renders.py z_test): fraction of pixels whose
    deviation exceeds the significance threshold must be small."""
    from math import erf, sqrt
    sigma = np.sqrt(np.maximum(var, 1e-6) / spp) + 1e-4 * np.abs(ref)
    z = np.abs(img - ref) / np.maximum(sigma, 1e-9)
    # two-sided p-value per pixel
    p = np.asarray([2.0 * (1.0 - 0.5 * (1.0 + erf(v / sqrt(2.0))))
                    for v in np.nditer(z.mean(-1))]).reshape(z.shape[:2])
    alpha = significance / p.size   # Sidak-style correction
    return (p < alpha).mean(), z


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden missing")
def test_cornell_golden_ztest():
    ref = lr.read_image(GOLDEN)
    d = lr.cornell_box()
    d["sensor"]["film"]["width"] = ref.shape[1]
    d["sensor"]["film"]["height"] = ref.shape[0]
    scene = lr.load_dict(d)           # gaussian rfilter, like the golden
    spp = 64
    mean, m2 = lr.render_moments(scene, spp=spp)
    img = np.asarray(mean)
    var = np.asarray(m2) - img ** 2

    frac_fail, z = z_test(img, ref, var, spp)
    # exclude directly-seen emitter pixels: their value is filter-kernel
    # dependent (the golden's exact reconstruction differs at the lamp edge)
    emitter = ref.mean(-1) > 1.0
    fails = (z.mean(-1) > 5.0) & ~emitter
    assert fails.mean() < 0.005, fails.mean()
    # and global error is small
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert rel < 0.01, rel
