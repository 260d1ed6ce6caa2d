"""Hair fiber BSDF — the Chiang et al. 2016 rough-dielectric fiber model
(reference src/bsdfs/hair.cpp capability; structure follows the published
pbrt-v3 formulation).

Local-frame convention here: +x is the fiber tangent (curve tessellation in
scene/curves.py builds shading frames with s = fiber direction), +z the
outward radial normal.  The azimuthal chord offset h of a ray hitting a
circular fiber is recovered from the view direction itself:
sin(gamma_o) = wi_y / |wi_yz| — no extra interaction payload needed, which
keeps the wavefront state SoA-small.

All lobes (R, TT, TRT + residual) are evaluated branchlessly; the model is
pure element-wise math and fuses into the bounce megakernel.

Row params: p[0]=eta, p[1]=beta_m, p[2]=beta_n, p[3]=alpha (radians).
sigma_a comes from tex0 (rgb absorption per unit fiber diameter).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import fresnel as fr
from ..scene.ir import F_GLOSSY_REFL, F_GLOSSY_TRANS

P_MAX = 3
_SQRT_PI_OVER_8 = 0.626657069


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def _i0(x):
    """Modified Bessel I0, 10-term series (accurate for the v>=0.1 branch)."""
    out = jnp.ones_like(x)
    term = jnp.ones_like(x)
    x2 = x * x
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        out = out + term
    return out


def _log_i0(x):
    big = x > 12.0
    x_s = jnp.minimum(x, 12.0)
    small = jnp.log(_i0(x_s))
    xb = jnp.maximum(x, 12.0)
    large = xb + 0.5 * (-jnp.log(2.0 * jnp.pi) - jnp.log(xb) + 1.0 / (8.0 * xb))
    return jnp.where(big, large, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering lobe."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small_v = v <= 0.1
    mp_small = jnp.exp(_log_i0(a) - b - 1.0 / v + 0.6931
                       + jnp.log(1.0 / (2.0 * v)))
    v_big = jnp.maximum(v, 0.1)
    mp_big = jnp.exp(-b) * _i0(a) / (jnp.sinh(1.0 / v_big) * 2.0 * v_big)
    return jnp.where(small_v, mp_small, mp_big)


def _logistic(x, s):
    x = jnp.abs(x)
    e = jnp.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * jnp.log(1.0 / jnp.clip(u * k + _logistic_cdf(a, s),
                                    1e-9, 1.0 - 1e-9) - 1.0)
    return jnp.clip(x, a, b)


def _phi_fn(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * jnp.pi


def _wrap_pi(x):
    """Wrap angle to [-pi, pi]."""
    return jnp.mod(x + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def _derived(p_row):
    """Per-lane derived constants from (eta, beta_m, beta_n, alpha)."""
    eta = p_row[..., 0]
    beta_m = p_row[..., 1]
    beta_n = p_row[..., 2]
    alpha = p_row[..., 3]
    v0 = (0.726 * beta_m + 0.812 * beta_m ** 2 + 3.7 * beta_m ** 20) ** 2
    v = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
    s = _SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n ** 2
                           + 5.372 * beta_n ** 22)
    sin2k = [jnp.sin(alpha)]
    cos2k = [_safe_sqrt(1.0 - sin2k[0] ** 2)]
    for i in range(1, 3):
        sin2k.append(2.0 * cos2k[i - 1] * sin2k[i - 1])
        cos2k.append(cos2k[i - 1] ** 2 - sin2k[i - 1] ** 2)
    return eta, v, s, sin2k, cos2k


def _angles(w):
    """(sin_theta, cos_theta, phi) of a local direction; theta measured from
    the normal plane toward the +x fiber tangent."""
    sin_t = jnp.clip(w[..., 0], -1.0, 1.0)
    cos_t = _safe_sqrt(1.0 - sin_t * sin_t)
    phi = jnp.arctan2(w[..., 2], w[..., 1])
    return sin_t, cos_t, phi


def _geometry(wi, p_row, sigma_a):
    """Everything that depends only on the camera-side direction wi."""
    eta, v, s, sin2k, cos2k = _derived(p_row)
    sin_to, cos_to, phi_o = _angles(wi)
    # chord offset from the tube-hit geometry (see module docstring)
    az = _safe_sqrt(wi[..., 1] ** 2 + wi[..., 2] ** 2)
    h = jnp.where(az > 1e-7, wi[..., 1] / jnp.maximum(az, 1e-7), 0.0)
    h = jnp.clip(h, -1.0, 1.0)
    gamma_o = jnp.arcsin(h)

    # refracted cone
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - sin_tt ** 2)
    etap = _safe_sqrt(eta ** 2 - sin_to ** 2) / jnp.maximum(cos_to, 1e-7)
    sin_gt = jnp.clip(h / jnp.maximum(etap, 1e-7), -1.0, 1.0)
    cos_gt = _safe_sqrt(1.0 - sin_gt ** 2)
    gamma_t = jnp.arcsin(sin_gt)

    # single-pass transmittance through the fiber interior
    tr = jnp.exp(-sigma_a * (2.0 * cos_gt
                             / jnp.maximum(cos_tt, 1e-7))[..., None])

    # lobe attenuations ap[0..P_MAX]
    cos_go = _safe_sqrt(1.0 - h * h)
    f, _, _, _ = fr.fresnel_dielectric(cos_to * cos_go, eta)
    f3 = f[..., None]
    ap = [jnp.broadcast_to(f3, tr.shape),
          (1.0 - f3) ** 2 * tr]
    for _ in range(2, P_MAX):
        ap.append(ap[-1] * tr * f3)
    ap.append(ap[P_MAX - 1] * f3 * tr / jnp.maximum(1.0 - tr * f3, 1e-6))

    return dict(eta=eta, v=v, s=s, sin2k=sin2k, cos2k=cos2k,
                sin_to=sin_to, cos_to=cos_to, phi_o=phi_o,
                gamma_o=gamma_o, gamma_t=gamma_t, ap=ap)


def _tilted(g, p):
    """Scale-tilt-adjusted (sin, cos) of theta_o for lobe p."""
    sin_to, cos_to = g["sin_to"], g["cos_to"]
    s2k, c2k = g["sin2k"], g["cos2k"]
    if p == 0:
        st = sin_to * c2k[1] - cos_to * s2k[1]
        ct = cos_to * c2k[1] + sin_to * s2k[1]
    elif p == 1:
        st = sin_to * c2k[0] + cos_to * s2k[0]
        ct = cos_to * c2k[0] - sin_to * s2k[0]
    elif p == 2:
        st = sin_to * c2k[2] + cos_to * s2k[2]
        ct = cos_to * c2k[2] - sin_to * s2k[2]
    else:
        st, ct = sin_to, cos_to
    return st, jnp.abs(ct)


def _ap_pdf(g):
    lum = [0.212671 * a[..., 0] + 0.715160 * a[..., 1]
           + 0.072169 * a[..., 2] for a in g["ap"]]
    tot = sum(lum)
    return [x / jnp.maximum(tot, 1e-9) for x in lum]


def hair_eval_pdf(wi, wo, p_row, sigma_a):
    """Returns (f * |cos|-convention value, solid-angle pdf).  The Chiang
    model is defined in the curve measure where the cosine is folded in, so
    the value is used directly."""
    g = _geometry(wi, p_row, sigma_a)
    sin_ti, cos_ti, phi_i = _angles(wo)
    phi = phi_i - g["phi_o"]
    ap_pdf = _ap_pdf(g)

    val = jnp.zeros(wi.shape[:-1] + (3,))
    pdf = jnp.zeros(wi.shape[:-1])
    for p in range(P_MAX):
        st, ct = _tilted(g, p)
        mp = _mp(cos_ti, ct, sin_ti, st, g["v"][p])
        np_ = _trimmed_logistic(
            _wrap_pi(phi - _phi_fn(p, g["gamma_o"], g["gamma_t"])),
            g["s"], -jnp.pi, jnp.pi)
        val = val + mp[..., None] * g["ap"][p] * np_[..., None]
        pdf = pdf + mp * ap_pdf[p] * np_
    mp = _mp(cos_ti, g["cos_to"], sin_ti, g["sin_to"], g["v"][P_MAX])
    inv2pi = 1.0 / (2.0 * jnp.pi)
    val = val + mp[..., None] * g["ap"][P_MAX] * inv2pi
    pdf = pdf + mp * ap_pdf[P_MAX] * inv2pi
    ok = jnp.isfinite(pdf) & jnp.all(jnp.isfinite(val), -1)
    return jnp.where(ok[..., None], val, 0.0), jnp.where(ok, pdf, 0.0)


def hair_sample(wi, u1, u2, p_row, sigma_a):
    """Importance-sample the fiber model.  u1 selects the lobe (remainder
    reused for the longitudinal sample), u2 drives (cos_theta, phi)."""
    g = _geometry(wi, p_row, sigma_a)
    ap_pdf = _ap_pdf(g)

    # lobe selection by attenuation luminance + remainder remap
    cdf0 = ap_pdf[0]
    cdf1 = cdf0 + ap_pdf[1]
    cdf2 = cdf1 + ap_pdf[2]
    p_sel = (u1 >= cdf0).astype(jnp.int32) + (u1 >= cdf1) + (u1 >= cdf2)
    lo = jnp.where(p_sel == 0, 0.0,
                   jnp.where(p_sel == 1, cdf0,
                             jnp.where(p_sel == 2, cdf1, cdf2)))
    width = jnp.where(p_sel == 0, ap_pdf[0],
                      jnp.where(p_sel == 1, ap_pdf[1],
                                jnp.where(p_sel == 2, ap_pdf[2], ap_pdf[3])))
    u_rem = jnp.clip((u1 - lo) / jnp.maximum(width, 1e-9), 1e-5, 1.0)

    # longitudinal sample for the selected lobe's tilted cone
    sts, cts, vs = [], [], []
    for p in range(P_MAX + 1):
        st, ct = _tilted(g, p)
        sts.append(st)
        cts.append(ct)
        vs.append(g["v"][p])
    st_p = jnp.select([p_sel == i for i in range(4)], sts)
    ct_p = jnp.select([p_sel == i for i in range(4)], cts)
    v_p = jnp.select([p_sel == i for i in range(4)], vs)

    cos_theta = 1.0 + v_p * jnp.log(
        jnp.maximum(u_rem + (1.0 - u_rem) * jnp.exp(-2.0 / v_p), 1e-20))
    sin_theta = _safe_sqrt(1.0 - cos_theta ** 2)
    cos_phi_l = jnp.cos(2.0 * jnp.pi * u2[..., 0])
    sin_ti = -cos_theta * st_p + sin_theta * cos_phi_l * ct_p
    cos_ti = _safe_sqrt(1.0 - sin_ti ** 2)

    # azimuthal sample
    dphi_lob = _phi_fn(p_sel.astype(jnp.float32), g["gamma_o"], g["gamma_t"]) \
        + _sample_trimmed_logistic(u2[..., 1], g["s"], -jnp.pi, jnp.pi)
    dphi_res = 2.0 * jnp.pi * u2[..., 1]
    dphi = jnp.where(p_sel == P_MAX, dphi_res, dphi_lob)
    phi_i = g["phi_o"] + dphi

    wo = jnp.stack([sin_ti, cos_ti * jnp.cos(phi_i),
                    cos_ti * jnp.sin(phi_i)], -1)
    val, pdf = hair_eval_pdf(wi, wo, p_row, sigma_a)
    weight = jnp.where((pdf > 1e-12)[..., None],
                       val / jnp.maximum(pdf, 1e-12)[..., None], 0.0)
    flags = jnp.full(pdf.shape, F_GLOSSY_REFL | F_GLOSSY_TRANS,
                     jnp.uint32)
    return wo, pdf, weight, jnp.ones(pdf.shape), flags
