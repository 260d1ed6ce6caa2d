"""RGB spectrum helpers: sRGB transfer curves and luminance.

The framework renders in linear RGB (the reference's `*_rgb` variants,
README.md:79-93); spectral upsampling (rgb2spec) is out of scope for the
liver scenes which are all RGB.  Mirrors reference src/core/spectrum.cpp +
bitmap.cpp srgb conversion semantics.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def srgb_to_linear(c):
    c = jnp.asarray(c)
    return jnp.where(c <= 0.04045, c / 12.92,
                     ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = jnp.asarray(c)
    return jnp.where(c <= 0.0031308, c * 12.92,
                     1.055 * jnp.maximum(c, 1e-8) ** (1.0 / 2.4) - 0.055)


def linear_to_srgb_np(c):
    c = np.asarray(c)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.maximum(c, 1e-8) ** (1.0 / 2.4) - 0.055)


def luminance(c):
    return (0.212671 * c[..., 0] + 0.715160 * c[..., 1]
            + 0.072169 * c[..., 2])


# ---------------------------------------------------------------------------
# Spectral -> RGB conversion for scene loading (host side, numpy).
# Replaces reference src/core/spectrum.cpp CIE integration for the
# `regular` / `irregular` / `blackbody` / `d65` spectrum plugins; RGB
# rendering then proceeds with the converted linear-sRGB values.
# ---------------------------------------------------------------------------

def cie1931_xyz_bar(lam):
    """CIE 1931 color matching functions via the multi-lobe Gaussian fit of
    Wyman, Sloan & Shirley 2013 (max error < 1%). lam in nm."""
    lam = np.asarray(lam, np.float64)

    def g(x, alpha, mu, s1, s2):
        t = (x - mu) * np.where(x < mu, 1.0 / s1, 1.0 / s2)
        return alpha * np.exp(-0.5 * t * t)

    x = (g(lam, 1.056, 599.8, 37.9, 31.0)
         + g(lam, 0.362, 442.0, 16.0, 26.7)
         + g(lam, -0.065, 501.1, 20.4, 26.2))
    y = (g(lam, 0.821, 568.8, 46.9, 40.5)
         + g(lam, 0.286, 530.9, 16.3, 31.1))
    z = (g(lam, 1.217, 437.0, 11.8, 36.0)
         + g(lam, 0.681, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], -1)


_XYZ_TO_SRGB = np.array([[3.240479, -1.537150, -0.498535],
                         [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])


def d65_spd(lam):
    """Approximate D65 illuminant SPD (blackbody 6504 K with the CIE
    normalization at 560 nm) — adequate for RGB rendering."""
    return planck(lam, 6504.0) / planck(np.asarray(560.0), 6504.0)


def planck(lam_nm, t_kelvin):
    """Planck blackbody spectral radiance (unnormalized), lam in nm."""
    lam = np.asarray(lam_nm, np.float64) * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    return (2 * h * c * c) / (lam ** 5) / \
        (np.exp(h * c / (lam * kb * t_kelvin)) - 1.0)


def spd_to_rgb(lam, vals, illuminant_normalized=False):
    """Integrate an SPD against CIE curves -> linear sRGB (numpy).

    Reflectance-style spectra are normalized by the D65 white point so a
    flat spectrum maps to (1,1,1) (reference spectrum.cpp semantics for
    reflectance vs radiance handled by the caller's scaling)."""
    lam = np.asarray(lam, np.float64)
    vals = np.asarray(vals, np.float64)
    grid = np.linspace(lam.min(), lam.max(), 256)
    v = np.interp(grid, lam, vals)
    xyzbar = cie1931_xyz_bar(grid)
    xyz = np.trapezoid(v[:, None] * xyzbar, grid, axis=0)
    norm = np.trapezoid(cie1931_xyz_bar(grid)[:, 1], grid)
    xyz = xyz / max(norm, 1e-12)
    rgb = _XYZ_TO_SRGB @ xyz
    return np.maximum(rgb, 0.0).astype(np.float32)


def blackbody_rgb(temperature, scale=1.0):
    """`blackbody` spectrum plugin -> linear RGB radiance (normalized so
    luminance matches the Planck curve's relative scale)."""
    grid = np.linspace(360.0, 830.0, 256)
    spd = planck(grid, float(temperature))
    return (spd_to_rgb(grid, spd) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Spectral-variant transport (jax, per-lane hero-wavelength packets).
#
# wavefront analog of the reference's *_spectral_* variants
# (include/mitsuba/core/fwd.h:216 Spectrum = 4-entry packet;
# CMakeLists.txt:109-128 variant generation; src/core/spectrum.cpp
# sample_shifted hero-wavelength strata).  RGB scene inputs are lifted to
# smooth reflectance spectra with the Smits (1999) 7-basis upsampling —
# the Jakob–Hanika rgb2spec coefficient table the reference uses is
# GENERATED at its build time (ext/rgb2spec) and does not ship in the
# checkout, so the classic linear basis is the honest substitution
# (flat-white exact, smooth saturated primaries).
# ---------------------------------------------------------------------------

SPEC_MIN = 360.0
SPEC_MAX = 830.0
N_SPEC = 4            # packet entries per lane (hero + 3 strata)

# Smits (1999) base spectra, 10 bins over 380..720 nm ("An RGB to
# Spectrum Conversion for Reflectances", tables 2-3; public data).
_SMITS_LAM = np.linspace(380.0, 720.0, 10)
_SMITS = {
    "white":   [1.0000, 1.0000, 0.9999, 0.9993, 0.9992, 0.9998, 1.0000,
                1.0000, 1.0000, 1.0000],
    "cyan":    [0.9710, 0.9426, 1.0007, 1.0007, 1.0007, 1.0007, 0.1564,
                0.0000, 0.0000, 0.0000],
    "magenta": [1.0000, 1.0000, 0.9685, 0.2229, 0.0000, 0.0458, 0.8369,
                1.0000, 1.0000, 0.9959],
    "yellow":  [0.0001, 0.0000, 0.1088, 0.6651, 1.0000, 1.0000, 0.9996,
                0.9586, 0.9685, 0.9840],
    "red":     [0.1012, 0.0515, 0.0000, 0.0000, 0.0000, 0.0000, 0.8325,
                1.0149, 1.0149, 1.0149],
    "green":   [0.0000, 0.0000, 0.0273, 0.7937, 1.0000, 0.9418, 0.1719,
                0.0000, 0.0000, 0.0025],
    "blue":    [1.0000, 1.0000, 0.8916, 0.3323, 0.0000, 0.0000, 0.0003,
                0.0369, 0.0483, 0.0496],
}


def _smits_eval_np():
    """(7, 10) base table in fixed row order w,c,m,y,r,g,b."""
    return np.asarray([_SMITS[k] for k in
                       ("white", "cyan", "magenta", "yellow",
                        "red", "green", "blue")], np.float32)


def smits_upsample(rgb, lam):
    """Lift linear-sRGB reflectance/radiance (..., 3) to spectral samples
    at wavelengths lam (..., K) -> (..., K).

    Branchless Smits decomposition: for each lane order the channels and
    combine white + one secondary (cyan/magenta/yellow) + one primary
    base (smits99 section 3), evaluated by linear interpolation of the
    10-bin bases (flat extension beyond 380/720 nm)."""
    import jax.numpy as jnp

    table = jnp.asarray(_smits_eval_np())          # (7, 10)
    lam_t = jnp.asarray(_SMITS_LAM, jnp.float32)
    # interpolate each base at lam: (..., K, 7)
    x = jnp.clip((lam - lam_t[0]) / (lam_t[-1] - lam_t[0]), 0.0, 1.0) * 9.0
    i0 = jnp.clip(x.astype(jnp.int32), 0, 8)
    f = (x - i0)[..., None]
    base = table.T                                  # (10, 7)
    b = base[i0] * (1 - f) + base[i0 + 1] * f       # (..., K, 7)
    w, c, m, y, r, g, bl = (b[..., 0], b[..., 1], b[..., 2], b[..., 3],
                            b[..., 4], b[..., 5], b[..., 6])

    R, G, B = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    # case R <= G <= B and permutations (smits99 pseudocode), branchless
    def comb(lo, mid, hi, sec, prim):
        return lo * w + (mid - lo) * sec + (hi - mid) * prim

    c1 = comb(R, G, B, c, bl)      # R<=G<=B
    c2 = comb(R, B, G, c, g)       # R<=B<=G
    c3 = comb(G, R, B, m, bl)      # G<=R<=B
    c4 = comb(G, B, R, m, r)       # G<=B<=R
    c5 = comb(B, R, G, y, g)       # B<=R<=G
    c6 = comb(B, G, R, y, r)       # B<=G<=R
    out = jnp.where((R <= G) & (G <= B), c1,
          jnp.where((R <= B) & (B <= G), c2,
          jnp.where((G <= R) & (R <= B), c3,
          jnp.where((G <= B) & (B <= R), c4,
          jnp.where((B <= R) & (R <= G), c5, c6)))))
    return jnp.maximum(out, 0.0)


_D65_GRID = np.linspace(SPEC_MIN, SPEC_MAX, 236)
_D65_TABLE = d65_spd(_D65_GRID).astype(np.float32)
# normalize so an rgb=(1,1,1) radiance lifts to EXACTLY the D65 SPD whose
# XYZ->sRGB is (1,1,1) by the sRGB white-point definition
_D65_TABLE /= float(np.trapezoid(
    _D65_TABLE * cie1931_xyz_bar(_D65_GRID)[:, 1], _D65_GRID)
    / np.trapezoid(cie1931_xyz_bar(_D65_GRID)[:, 1], _D65_GRID))


def d65_jax(lam):
    import jax.numpy as jnp

    tbl = jnp.asarray(_D65_TABLE)
    x = jnp.clip((lam - SPEC_MIN) / (SPEC_MAX - SPEC_MIN), 0.0, 1.0) \
        * (tbl.shape[0] - 1)
    i0 = jnp.clip(x.astype(jnp.int32), 0, tbl.shape[0] - 2)
    f = x - i0
    return tbl[i0] * (1 - f) + tbl[i0 + 1] * f


def smits_upsample_illum(rgb, lam):
    """Lift an RGB RADIANCE to a spectrum: reflectance upsample x the D65
    illuminant (the reference's srgb_d65 emitter model, render/srgb.cpp)
    — whites stay neutral because sRGB is D65-referenced."""
    return smits_upsample(rgb, lam) * d65_jax(lam)


def sample_hero(u):
    """Hero-wavelength packet from one uniform: lam (..., N_SPEC) with
    equally-shifted strata over [SPEC_MIN, SPEC_MAX) (reference
    spectrum.h sample_shifted), uniform pdf = 1/range each."""
    import jax.numpy as jnp

    span = SPEC_MAX - SPEC_MIN
    lam0 = SPEC_MIN + u * span
    shifts = jnp.arange(N_SPEC, dtype=jnp.float32) * (span / N_SPEC)
    lam = lam0[..., None] + shifts
    lam = jnp.where(lam >= SPEC_MAX, lam - span, lam)
    return lam


_CIE_GRID = np.linspace(SPEC_MIN, SPEC_MAX, 236)
_CIE_TABLE = cie1931_xyz_bar(_CIE_GRID).astype(np.float32)   # (236, 3)
_CIE_Y_INT = float(np.trapezoid(_CIE_TABLE[:, 1], _CIE_GRID))


def xyz_bar_jax(lam):
    """CIE color-matching functions at lam (...,) -> (..., 3), jax."""
    import jax.numpy as jnp

    tbl = jnp.asarray(_CIE_TABLE)
    x = jnp.clip((lam - SPEC_MIN) / (SPEC_MAX - SPEC_MIN), 0.0, 1.0) \
        * (tbl.shape[0] - 1)
    i0 = jnp.clip(x.astype(jnp.int32), 0, tbl.shape[0] - 2)
    f = (x - i0)[..., None]
    return tbl[i0] * (1 - f) + tbl[i0 + 1] * f


def rgb_estimate_weights(lam):
    """d(rgb_j)/d(L_k) of `spec_to_rgb_estimate` at wavelengths lam
    (..., K) -> (..., K, 3): W[..., k, j].  The estimate is linear in L,
    so these weights convert an RGB loss cotangent into the wavelength-
    packet cotangent the spectral replay adjoint walks with:
    delta_packet_k = sum_j delta_rgb_j * W[..., k, j]."""
    import jax.numpy as jnp

    span = SPEC_MAX - SPEC_MIN
    xyzb = xyz_bar_jax(lam)                              # (..., K, 3)
    M = jnp.asarray(_XYZ_TO_SRGB, jnp.float32)
    K = lam.shape[-1]
    return (xyzb @ M.T) * (span / (K * _CIE_Y_INT))


def spec_to_rgb_estimate(L, lam):
    """Monte-Carlo spectral-to-RGB: L (..., K) radiance samples at lam
    (..., K) drawn with the uniform hero pdf -> (..., 3) linear sRGB.

    Normalized so that a spectrally-flat radiance 1 (an 'equal-energy
    white' E illuminant) maps to RGB luminance 1 — the analog of the
    reference's film-side CIE integration (hdrfilm develop)."""
    import jax.numpy as jnp

    span = SPEC_MAX - SPEC_MIN
    xyzb = xyz_bar_jax(lam)                        # (..., K, 3)
    xyz = jnp.mean(L[..., None] * xyzb, axis=-2) * span / _CIE_Y_INT
    return xyz @ jnp.asarray(_XYZ_TO_SRGB, jnp.float32).T
