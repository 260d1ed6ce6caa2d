"""Data-driven measured BSDF — the RGL material format (reference
src/bsdfs/measured.cpp + the Dupuy & Jakob 2018 parameterization).

Wavefront redesign of the Marginal2D warp machinery: the reference inverts
bilinear-patch CDFs on the fly (distr_2d.h Marginal2D<k>); here the
per-incidence-slice warps are precomputed host-side into dense cumulative
tables (numpy, at scene build), and the device side does fixed-depth
binary searches over *mixture* CDFs — two bracketing theta_i slices are
linearly blended, which is exact because CDFs are linear in the density.
Sampling is piecewise-constant per texel (an internal importance choice;
values/eval stay bilinear as in the reference), so sample/pdf stay
mutually consistent by construction.

Scope round 1: isotropic materials, RGB spectra ("rgb" field), which is
the shape of the published RGL database in RGB mode.

Tensor file layout (core/tensor.cpp:17-55): magic "tensor_file\\0",
2-byte version, uint32 field count; per field uint16 name_len, name,
uint16 ndim, uint8 dtype, uint64 offset, uint64 dims[ndim].
"""
from __future__ import annotations

import struct as pystruct

import jax
import jax.numpy as jnp
import numpy as np

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
           5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
           9: np.float16, 10: np.float32, 11: np.float64}


def load_tensor_file(path: str) -> dict:
    """Parse an RGL tensor file into {name: ndarray}."""
    with open(path, "rb") as f:
        buf = f.read()
    assert buf[:11] == b"tensor_file", "not a tensor file"
    (n_fields,) = pystruct.unpack_from("<I", buf, 14)
    pos = 18
    out = {}
    for _ in range(n_fields):
        (name_len,) = pystruct.unpack_from("<H", buf, pos)
        pos += 2
        name = buf[pos:pos + name_len].decode()
        pos += name_len
        ndim, dtype = pystruct.unpack_from("<HB", buf, pos)
        pos += 3
        (offset,) = pystruct.unpack_from("<Q", buf, pos)
        pos += 8
        shape = pystruct.unpack_from("<" + "Q" * ndim, buf, pos)
        pos += 8 * ndim
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(buf, _DTYPES[dtype], count, offset)
        out[name] = arr.reshape(shape)
    return out


def write_tensor_file(path: str, fields: dict):
    """Inverse of load_tensor_file (test fixtures, dataset tooling)."""
    inv = {v: k for k, v in _DTYPES.items()}
    header = b"tensor_file\x00" + bytes([1, 0]) \
        + pystruct.pack("<I", len(fields))
    meta, blobs = [], []
    offset = len(header)
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        rec = pystruct.pack("<H", len(name)) + name.encode() \
            + pystruct.pack("<HB", arr.ndim, inv[arr.dtype.type if False
                                                else np.dtype(arr.dtype).type])
        rec += b"\x00" * 0
        meta.append((rec, arr))
        offset += len(rec) + 8 + 8 * arr.ndim
    data_pos = offset
    out = [header]
    for rec, arr in meta:
        out.append(rec)
        out.append(pystruct.pack("<Q", data_pos))
        out.append(pystruct.pack("<" + "Q" * arr.ndim, *arr.shape))
        blobs.append(arr.tobytes())
        data_pos += arr.nbytes
    out += blobs
    with open(path, "wb") as f:
        f.write(b"".join(out))


# ---------------------------------------------------------------------------
# Host-side precompute
# ---------------------------------------------------------------------------

def _build_warp(density: np.ndarray):
    """density (S, H, W) >= 0 -> (row_cdf (S,H+1), cond_cdf (S,H,W+1),
    pdf (S,H,W)).  Cumulative tables are unnormalized-within-row /
    normalized-overall texel masses so that theta_i-slice mixtures blend
    exactly."""
    d = np.maximum(np.asarray(density, np.float64), 0.0)
    S, H, W = d.shape
    mass = d / np.maximum(d.sum((1, 2), keepdims=True), 1e-30)
    cond = np.zeros((S, H, W + 1))
    cond[:, :, 1:] = np.cumsum(mass, 2)
    row = np.zeros((S, H + 1))
    row[:, 1:] = np.cumsum(cond[:, :, -1], 1)
    pdf = (mass * H * W).astype(np.float32)
    return row.astype(np.float32), cond.astype(np.float32), pdf


class MeasuredData:
    """Host-side container for one .bsdf material (stacked to the device
    by the scene builder)."""

    def __init__(self, path: str):
        tf = load_tensor_file(path)
        self.theta_i = np.asarray(tf["theta_i"], np.float32)
        assert tf["phi_i"].shape[0] <= 2, \
            "anisotropic measured materials unsupported (round 1)"
        vndf = np.asarray(tf["vndf"], np.float32)[0]       # (S, H, W)
        lum = np.asarray(tf["luminance"], np.float32)[0]
        self.spectra = np.asarray(tf["rgb"], np.float32)[0]  # (S, 3, H, W)
        self.ndf = np.asarray(tf["ndf"], np.float32)
        self.sigma = np.asarray(tf["sigma"], np.float32)
        self.jacobian = bool(np.asarray(tf["jacobian"]).ravel()[0]) \
            if "jacobian" in tf else False
        self.vndf = vndf
        self.vndf_tables = _build_warp(vndf)
        self.lum_tables = _build_warp(lum)


# ---------------------------------------------------------------------------
# Device-side warp ops (fixed-depth bisection over mixture CDFs)
# ---------------------------------------------------------------------------

def _bisect(cdf_fn, size, target):
    """Find j with cdf(j) <= target < cdf(j+1), cdf over [0, size]."""
    lo = jnp.zeros_like(target, jnp.int32)
    hi = jnp.full_like(lo, size)
    steps = max(1, int(np.ceil(np.log2(size + 1))))
    for _ in range(steps):
        mid = (lo + hi) // 2
        below = cdf_fn(mid) <= target
        lo = jnp.where(below, mid, lo)
        hi = jnp.where(below, hi, mid)
    return jnp.clip(lo, 0, size - 1)


def _slice_of(theta_grid, theta):
    """Bracketing slice index + lerp weight for per-lane theta_i."""
    S = theta_grid.shape[0]
    s0 = jnp.clip(jnp.searchsorted(theta_grid, theta, side="right") - 1,
                  0, S - 2) if S > 1 else jnp.zeros_like(theta, jnp.int32)
    if S == 1:
        return s0, jnp.zeros_like(theta)
    t0 = theta_grid[s0]
    t1 = theta_grid[s0 + 1]
    w = jnp.clip((theta - t0) / jnp.maximum(t1 - t0, 1e-9), 0.0, 1.0)
    return s0, w


def _warp_sample(tables, s0, w, u):
    """Sample the slice-mixture warp.  u (N,2): u[:,1] -> row (phi axis),
    u[:,0] -> column (theta axis).  Returns (x, y, pdf)."""
    row_cdf, cond_cdf, pdf_tex = tables
    S, H, W = pdf_tex.shape

    def rc(j):
        a = row_cdf[s0, j]
        b = row_cdf[jnp.minimum(s0 + 1, S - 1), j]
        return a * (1.0 - w) + b * w

    j = _bisect(rc, H, u[:, 1])
    c0, c1 = rc(j), rc(j + 1)
    mass_row = jnp.maximum(c1 - c0, 1e-12)
    y = (j + (u[:, 1] - c0) / mass_row) / H

    def cc(i):
        a = cond_cdf[s0, j, i]
        b = cond_cdf[jnp.minimum(s0 + 1, S - 1), j, i]
        return a * (1.0 - w) + b * w

    target = u[:, 0] * mass_row
    i = _bisect(cc, W, target)
    d0, d1 = cc(i), cc(i + 1)
    mass_tex = jnp.maximum(d1 - d0, 1e-12)
    x = (i + (target - d0) / mass_tex) / W

    p0 = pdf_tex[s0, j, i]
    p1 = pdf_tex[jnp.minimum(s0 + 1, S - 1), j, i]
    return x, y, p0 * (1.0 - w) + p1 * w


def _warp_invert(tables, s0, w, x, y):
    """Forward CDF of the mixture warp: preimage of (x, y) under sample.
    Returns (u0, u1, pdf)."""
    row_cdf, cond_cdf, pdf_tex = tables
    S, H, W = pdf_tex.shape
    j = jnp.clip((y * H).astype(jnp.int32), 0, H - 1)
    i = jnp.clip((x * W).astype(jnp.int32), 0, W - 1)
    fy = y * H - j
    fx = x * W - i

    def rc(jj):
        a = row_cdf[s0, jj]
        b = row_cdf[jnp.minimum(s0 + 1, S - 1), jj]
        return a * (1.0 - w) + b * w

    def cc(ii):
        a = cond_cdf[s0, j, ii]
        b = cond_cdf[jnp.minimum(s0 + 1, S - 1), j, ii]
        return a * (1.0 - w) + b * w

    c0, c1 = rc(j), rc(j + 1)
    mass_row = jnp.maximum(c1 - c0, 1e-12)
    u1 = c0 + fy * mass_row
    d0, d1 = cc(i), cc(i + 1)
    u0 = (d0 + fx * jnp.maximum(d1 - d0, 0.0)) / mass_row
    p0 = pdf_tex[s0, j, i]
    p1 = pdf_tex[jnp.minimum(s0 + 1, S - 1), j, i]
    return u0, u1, p0 * (1.0 - w) + p1 * w


def _bilinear2d(tab, x, y):
    """tab (H, W) sampled at vertex-based (x, y) in [0,1]."""
    H, W = tab.shape
    fx = jnp.clip(x, 0.0, 1.0) * (W - 1)
    fy = jnp.clip(y, 0.0, 1.0) * (H - 1)
    x0 = jnp.clip(fx.astype(jnp.int32), 0, W - 2)
    y0 = jnp.clip(fy.astype(jnp.int32), 0, H - 2)
    tx = fx - x0
    ty = fy - y0
    v00 = tab[y0, x0]
    v01 = tab[y0, x0 + 1]
    v10 = tab[y0 + 1, x0]
    v11 = tab[y0 + 1, x0 + 1]
    return (v00 * (1 - tx) + v01 * tx) * (1 - ty) \
        + (v10 * (1 - tx) + v11 * tx) * ty


def _spectra_eval(spectra, s0, w, x, y):
    """spectra (S, 3, H, W) -> rgb (N, 3), bilinear in (x, y), linear in
    the theta slice."""
    S = spectra.shape[0]
    out = []
    for c in range(3):
        v0 = _bilinear2d_lanes(spectra[:, c], s0, x, y)
        v1 = _bilinear2d_lanes(spectra[:, c], jnp.minimum(s0 + 1, S - 1),
                               x, y)
        out.append(v0 * (1.0 - w) + v1 * w)
    return jnp.stack(out, -1)


def _bilinear2d_lanes(tab3, s, x, y):
    """tab3 (S, H, W) with per-lane slice s."""
    _, H, W = tab3.shape
    fx = jnp.clip(x, 0.0, 1.0) * (W - 1)
    fy = jnp.clip(y, 0.0, 1.0) * (H - 1)
    x0 = jnp.clip(fx.astype(jnp.int32), 0, W - 2)
    y0 = jnp.clip(fy.astype(jnp.int32), 0, H - 2)
    tx = fx - x0
    ty = fy - y0
    v00 = tab3[s, y0, x0]
    v01 = tab3[s, y0, x0 + 1]
    v10 = tab3[s, y0 + 1, x0]
    v11 = tab3[s, y0 + 1, x0 + 1]
    return (v00 * (1 - tx) + v01 * tx) * (1 - ty) \
        + (v10 * (1 - tx) + v11 * tx) * ty


# ---------------------------------------------------------------------------
# BSDF interface (measured.cpp sample/eval/pdf)
# ---------------------------------------------------------------------------

_HALF_PI = np.pi / 2.0


def _u2theta(u):
    return u * u * _HALF_PI


def _theta2u(t):
    return jnp.sqrt(jnp.maximum(t, 0.0) / _HALF_PI)


def _u2phi(u):
    return (2.0 * u - 1.0) * np.pi


def _phi2u(p):
    return 0.5 * (p / np.pi + 1.0)


def _elevation(d):
    dist = jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2
                    + (d[..., 2] - 1.0) ** 2)
    return 2.0 * jnp.arcsin(jnp.clip(0.5 * dist, -1.0, 1.0))


def measured_sample(md, wi, u1, u2):
    """md: the scene's MeasuredTable (scene/ir.py)."""
    theta_i = _elevation(wi)
    phi_i = jnp.arctan2(wi[..., 1], wi[..., 0])
    s0, w = _slice_of(md.theta_i, theta_i)

    # luminance warp, then the vndf warp (measured.cpp:275-300)
    u_swap = jnp.stack([u2[:, 1], u2[:, 0]], -1)
    lx, ly, lum_pdf = _warp_sample((md.lum_row, md.lum_cond, md.lum_pdf), s0, w, u_swap)
    mx, my, ndf_pdf = _warp_sample((md.vndf_row, md.vndf_cond, md.vndf_pdf),
                                   s0, w, jnp.stack([lx, ly], -1))
    theta_m = _u2theta(mx)
    phi_m = _u2phi(my) + phi_i          # isotropic
    st, ct = jnp.sin(theta_m), jnp.cos(theta_m)
    sp, cp = jnp.sin(phi_m), jnp.cos(phi_m)
    m_vec = jnp.stack([cp * st, sp * st, ct], -1)

    dot = jnp.sum(wi * m_vec, -1)
    wo = 2.0 * dot[..., None] * m_vec - wi
    jac = jnp.maximum(2.0 * np.pi ** 2 * mx * st, 1e-6) * 4.0 * dot
    pdf = ndf_pdf * lum_pdf / jnp.maximum(jac, 1e-12)

    spec = _spectra_eval(md.spectra, s0, w, lx, ly)
    if md.jacobian:
        u_wi0 = _theta2u(theta_i)
        u_wi1 = _phi2u(phi_i)
        nd = _bilinear2d(md.ndf, mx, my)
        sg = _bilinear2d(md.sigma, u_wi0, u_wi1)
        spec = spec * (nd / jnp.maximum(4.0 * sg, 1e-12))[..., None]

    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0) & (pdf > 1e-12) \
        & jnp.all(jnp.isfinite(spec), -1)
    weight = jnp.where(ok[..., None],
                       spec / jnp.maximum(pdf, 1e-12)[..., None], 0.0)
    return wo, jnp.where(ok, pdf, 0.0), weight


def measured_eval_pdf(md, wi, wo):
    """f*cos value (RGL spectra are cosine-weighted) and sampling pdf."""
    theta_i = _elevation(wi)
    phi_i = jnp.arctan2(wi[..., 1], wi[..., 0])
    s0, w = _slice_of(md.theta_i, theta_i)

    m_vec = wi + wo
    ml = jnp.sqrt(jnp.sum(m_vec * m_vec, -1))
    m_vec = m_vec / jnp.maximum(ml, 1e-9)[..., None]
    theta_m = _elevation(m_vec)
    phi_m = jnp.arctan2(m_vec[..., 1], m_vec[..., 0])
    mx = _theta2u(theta_m)
    my = _phi2u(phi_m - phi_i)
    my = my - jnp.floor(my)

    lx, ly, ndf_pdf = _warp_invert((md.vndf_row, md.vndf_cond, md.vndf_pdf), s0, w, mx, my)
    _, _, lum_pdf = _warp_invert((md.lum_row, md.lum_cond, md.lum_pdf), s0, w, lx, ly)

    spec = _spectra_eval(md.spectra, s0, w, lx, ly)
    if md.jacobian:
        nd = _bilinear2d(md.ndf, mx, my)
        sg = _bilinear2d(md.sigma, _theta2u(theta_i), _phi2u(phi_i))
        spec = spec * (nd / jnp.maximum(4.0 * sg, 1e-12))[..., None]

    st = jnp.sin(theta_m)
    dot = jnp.sum(wi * m_vec, -1)
    jac = jnp.maximum(2.0 * np.pi ** 2 * mx * st, 1e-6) * 4.0 \
        * jnp.maximum(dot, 1e-9)
    pdf = ndf_pdf * lum_pdf / jac

    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0) & (ml > 1e-9)
    return jnp.where(ok[..., None], spec, 0.0), \
        jnp.where(ok & jnp.isfinite(pdf), pdf, 0.0)


def as_device_table(mds):
    """Host MeasuredData -> the scene MeasuredTable (single material per
    scene round 1)."""
    from ..scene.ir import MeasuredTable
    assert len(mds) == 1, "one measured material per scene (round 1)"
    md = mds[0]
    vr, vc, vp = md.vndf_tables
    lr_, lc, lp = md.lum_tables
    return MeasuredTable(
        theta_i=jnp.asarray(md.theta_i),
        vndf_row=jnp.asarray(vr), vndf_cond=jnp.asarray(vc),
        vndf_pdf=jnp.asarray(vp),
        lum_row=jnp.asarray(lr_), lum_cond=jnp.asarray(lc),
        lum_pdf=jnp.asarray(lp),
        spectra=jnp.asarray(md.spectra),
        ndf=jnp.asarray(md.ndf), sigma=jnp.asarray(md.sigma),
        jacobian=md.jacobian, enabled=True)
