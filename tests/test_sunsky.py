"""Sunsky fidelity validation (VERDICT round-1 weak #6).

The reference's sunsky.cpp evaluates the Hosek-Wilkie dataset, which is
downloaded at build time and does not ship in the checkout — a pointwise
comparison is impossible offline.  Instead the Preetham bake is validated
against INDEPENDENT published sky models/quantities:

  * relative luminance distribution vs the CIE Standard Clear Sky
    (ISO 15469:2004 / CIE S 011, sky type 12: a=-1, b=-0.32, c=10,
    d=-3, e=0.45) — a different analytic model fit to the same skies;
  * absolute zenith luminance scale vs the magnitude of real clear-sky
    zenith luminances (a few kcd/m^2) — catches unit errors;
  * documented qualitative behavior: circumsolar brightening and the
    turbidity -> contrast trend.
"""
import numpy as np

from liverrenderer.emitter.sunsky import preetham_envmap, sun_direction

LUM = np.array([0.212671, 0.715160, 0.072169])


def _sky_lum(img, res):
    """Luminance map + direction grid of the upper hemisphere."""
    h, w = img.shape[:2]
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = u * 2 * np.pi - np.pi
    TH, PH = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.sin(TH) * np.sin(PH), np.cos(TH),
                     -np.sin(TH) * np.cos(PH)], -1)
    Y = img @ LUM
    return Y, dirs, TH


def _cie_clear_sky(theta, gamma, theta_s):
    """CIE Standard Clear Sky (type 12) relative luminance L/Lz."""
    a, b, c, d, e = -1.0, -0.32, 10.0, -3.0, 0.45

    def phi_f(t):
        return 1.0 + a * np.exp(b / np.maximum(np.cos(t), 1e-2))

    def f(g):
        return 1.0 + c * (np.exp(d * g) - np.exp(d * np.pi / 2)) \
            + e * np.cos(g) ** 2

    return (phi_f(theta) * f(gamma)) / (phi_f(0.0) * f(theta_s))


def test_preetham_matches_cie_clear_sky_shape():
    """Log-luminance over the sun-free upper dome must correlate strongly
    with the CIE clear-sky standard, and the ratio must stay bounded."""
    sun = sun_direction(hour=10.0)          # mid-morning, ~40deg altitude
    img = preetham_envmap(turbidity=2.5, sun_dir=sun, res=64,
                          sun_scale=0.0)    # sky only
    Y, dirs, TH = _sky_lum(img, 64)
    theta_s = np.arccos(np.clip(sun[1], -1, 1))

    cos_g = np.clip(dirs @ sun, -1, 1)
    gamma = np.arccos(cos_g)
    up = (dirs[..., 1] > 0.1) & (gamma > np.deg2rad(10.0))  # no circumsolar
    cie = _cie_clear_sky(TH, gamma, theta_s)

    # normalize both to their zenith value
    zen = np.unravel_index(np.argmax(dirs[..., 1]), TH.shape)
    ours_rel = Y[up] / Y[zen]
    cie_rel = cie[up]

    r = np.corrcoef(np.log(np.maximum(ours_rel, 1e-4)),
                    np.log(np.maximum(cie_rel, 1e-4)))[0, 1]
    assert r > 0.9, r
    ratio = ours_rel / np.maximum(cie_rel, 1e-4)
    frac_ok = np.mean((ratio > 0.5) & (ratio < 2.0))
    assert frac_ok > 0.85, frac_ok


def test_zenith_luminance_physical_scale():
    """Preetham zenith luminance at T=2.5, sun ~40deg altitude should be a
    few kcd/m^2 (real clear skies: ~2-9 kcd/m^2).  Map units are
    kcd/m^2-normalized, so the luminance channel should land in [1, 15]."""
    sun = sun_direction(hour=10.0)
    img = preetham_envmap(turbidity=2.5, sun_dir=sun, res=32, sun_scale=0.0)
    Y, dirs, _ = _sky_lum(img, 32)
    zen = np.unravel_index(np.argmax(dirs[..., 1]), Y.shape)
    assert 1.0 < Y[zen] < 15.0, Y[zen]


def test_circumsolar_brightening_and_turbidity_trend():
    sun = sun_direction(hour=10.0)
    lo = preetham_envmap(turbidity=2.0, sun_dir=sun, res=48, sun_scale=0.0)
    hi = preetham_envmap(turbidity=6.0, sun_dir=sun, res=48, sun_scale=0.0)
    for img in (lo, hi):
        Y, dirs, _ = _sky_lum(img, 48)
        cos_g = dirs @ sun
        near = (cos_g > np.cos(np.deg2rad(15))) & (dirs[..., 1] > 0)
        far = (np.abs(cos_g) < 0.2) & (dirs[..., 1] > 0.2)
        assert Y[near].mean() > 1.5 * Y[far].mean()

    # hazier atmospheres scatter more sunlight into the diffuse dome:
    # cosine-weighted horizontal sky illuminance must increase with T
    def diffuse_illum(img):
        Y, dirs, TH = _sky_lum(img, 48)
        up = dirs[..., 1] > 0
        w = (dirs[..., 1] * np.sin(TH))[up]          # cosine x solid angle
        return float((Y[up] * w).sum() / w.sum())
    assert diffuse_illum(hi) > 1.5 * diffuse_illum(lo)


def test_sun_disc_energy_resolution_invariant():
    """The baked sun must (a) exist at typical bake resolutions — the
    0.27deg disc is far smaller than a texel, a naive cos-threshold bakes
    NO sun — and (b) deposit the same irradiance regardless of map
    resolution (solid-angle-conserving splat)."""
    sun = sun_direction(hour=12.0)

    def sun_irradiance(res):
        sky = preetham_envmap(turbidity=3.0, sun_dir=sun, res=res,
                              sun_scale=0.0)
        full = preetham_envmap(turbidity=3.0, sun_dir=sun, res=res)
        dY = (full - sky) @ LUM
        h, w = dY.shape
        v = (np.arange(h) + 0.5) / h
        theta = v * np.pi
        d_omega = (np.pi / h) * (2 * np.pi / w) * np.sin(theta)[:, None]
        return float((dY * d_omega).sum())

    e64, e128, e256 = (sun_irradiance(r) for r in (64, 128, 256))
    assert e64 > 0.01, e64                      # the sun exists at all
    np.testing.assert_allclose(e64, e128, rtol=0.05)
    np.testing.assert_allclose(e128, e256, rtol=0.05)

    # and the disc texel dominates the surrounding sky radiance
    img = preetham_envmap(turbidity=3.0, sun_dir=sun, res=64)
    Y, dirs, _ = _sky_lum(img, 64)
    cos_g = dirs @ sun
    sky = (cos_g < np.cos(np.deg2rad(10))) & (dirs[..., 1] > 0.1)
    assert Y.max() > 30 * Y[sky].mean()


def test_direct_to_diffuse_ratio_physical():
    """Clear-sky direct-normal illuminance is several times the diffuse
    horizontal illuminance (measured clear skies: direct ~60-100 klux,
    diffuse ~10-25 klux -> ratio ~2.5-10)."""
    sun = sun_direction(hour=11.0)
    res = 96
    sky = preetham_envmap(turbidity=2.5, sun_dir=sun, res=res, sun_scale=0.0)
    full = preetham_envmap(turbidity=2.5, sun_dir=sun, res=res)
    h, w = res, 2 * res
    v = (np.arange(h) + 0.5) / h
    theta = v * np.pi
    d_omega = (np.pi / h) * (2 * np.pi / w) * np.sin(theta)[:, None]

    direct = (((full - sky) @ LUM) * d_omega).sum()
    Y, dirs, _ = _sky_lum(sky, res)
    up = dirs[..., 1] > 0
    diffuse = (Y * dirs[..., 1] * d_omega)[up].sum()
    ratio = direct / diffuse
    assert 1.5 < ratio < 20.0, (direct, diffuse, ratio)
