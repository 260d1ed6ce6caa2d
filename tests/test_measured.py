"""Measured (RGL-format) BSDF: tensor-file IO, warp consistency, render
(reference src/bsdfs/measured.cpp)."""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer as lr
from liverrenderer.bsdf.measured import (MeasuredData, load_tensor_file,
                                             write_tensor_file)
from liverrenderer.testutil import chi2_test_sphere


def _synthetic_bsdf(path, S=6, H=16, W=16):
    """A smooth glossy-ish synthetic material in the RGL layout."""
    theta_i = np.linspace(0.0, np.pi / 2, S).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, H, endpoint=False) + 0.5 / H,
                         np.linspace(0, 1, W, endpoint=False) + 0.5 / W,
                         indexing="ij")
    vndf = np.zeros((1, S, H, W), np.float32)
    lum = np.zeros((1, S, H, W), np.float32)
    for s in range(S):
        c = 0.15 + 0.5 * s / S
        vndf[0, s] = np.exp(-((xx - c) ** 2 + (yy - 0.5) ** 2) / 0.08) + .05
        lum[0, s] = np.exp(-((xx - 0.4) ** 2) / 0.2) + 0.1
    rgb = np.zeros((1, S, 3, H, W), np.float32)
    rgb[0, :, 0] = 0.6
    rgb[0, :, 1] = 0.3 + 0.3 * xx
    rgb[0, :, 2] = 0.1
    fields = {
        "theta_i": theta_i,
        "phi_i": np.zeros(1, np.float32),
        "vndf": vndf,
        "luminance": lum,
        "rgb": rgb,
        "ndf": np.ones((H, W), np.float32),
        "sigma": np.full((H, W), 0.25, np.float32),
        "jacobian": np.zeros(1, np.uint8),
        "description": np.frombuffer(b"synthetic", np.uint8).copy(),
    }
    write_tensor_file(path, fields)
    return fields


def test_tensor_file_roundtrip(tmp_path):
    p = str(tmp_path / "m.bsdf")
    fields = _synthetic_bsdf(p)
    back = load_tensor_file(p)
    for k, v in fields.items():
        assert back[k].shape == v.shape, k
        assert np.allclose(np.asarray(back[k], np.float64),
                           np.asarray(v, np.float64)), k


def test_warp_sample_histogram(tmp_path):
    """The mixture warp's sampled u-space density matches its pdf tables
    (the Marginal2D-equivalent machinery; a sphere-space chi2 is not used
    because the half-vector map's 1/u_theta singularity at the mirror
    direction defeats fixed-grid cell quadrature)."""
    from liverrenderer.bsdf.measured import (_build_warp, _warp_invert,
                                                 _warp_sample)
    rng = np.random.default_rng(0)
    S, H, W = 4, 8, 8
    dens = rng.uniform(0.05, 1.0, (S, H, W)).astype(np.float32)
    tables = tuple(jnp.asarray(t) for t in _build_warp(dens))
    n = 400_000
    u = jnp.asarray(rng.random((n, 2)), jnp.float32)
    s0 = jnp.full((n,), 1, jnp.int32)
    w = jnp.full((n,), 0.3, jnp.float32)
    x, y, pdf = _warp_sample(tables, s0, w, u)
    # roundtrip
    u0, u1, pdf2 = _warp_invert(tables, s0, w, x, y)
    assert float(jnp.abs(u0 - u[:, 0]).max()) < 1e-5
    assert float(jnp.abs(u1 - u[:, 1]).max()) < 1e-5
    assert float(jnp.abs(pdf - pdf2).max()) == 0.0
    # per-texel counts vs mixture masses
    hx = np.clip((np.asarray(x) * W).astype(int), 0, W - 1)
    hy = np.clip((np.asarray(y) * H).astype(int), 0, H - 1)
    counts = np.bincount(hy * W + hx, minlength=H * W).astype(np.float64)
    # slices are normalized independently before the CDF-lerp mixture
    m1 = dens[1] / dens[1].sum()
    m2 = dens[2] / dens[2].sum()
    mix = 0.7 * m1 + 0.3 * m2
    expect = (mix / mix.sum()).ravel() * n
    chi2 = ((counts - expect) ** 2 / np.maximum(expect, 1.0)).sum()
    # dof = H*W - 1; generous 4-sigma bound
    assert chi2 < (H * W - 1) + 4.0 * np.sqrt(2 * (H * W - 1)), chi2


def test_measured_angle_jacobian_fd(tmp_path):
    """The analytic 2*pi^2*u_theta*sin(theta)*4*(wi.m) area factor in the
    pdf matches the finite-difference Jacobian of the u_m -> wo map."""
    import numpy as onp
    wi = onp.array([0.4, 0.15, 0.9])
    wi /= onp.linalg.norm(wi)

    def wo_of(mx, my, phi_i=0.0):
        theta = mx * mx * (onp.pi / 2)
        phi = (2 * my - 1) * onp.pi + phi_i
        m_ = onp.array([onp.cos(phi) * onp.sin(theta),
                        onp.sin(phi) * onp.sin(theta), onp.cos(theta)])
        return 2.0 * onp.dot(wi, m_) * m_ - wi, m_

    rng = onp.random.default_rng(2)
    h = 1e-4
    for _ in range(50):
        mx = rng.uniform(0.2, 0.9)
        my = rng.uniform(0.1, 0.9)
        wo0, m0 = wo_of(mx, my)
        if wo0[2] < 0.05:
            continue
        dx = (wo_of(mx + h, my)[0] - wo_of(mx - h, my)[0]) / (2 * h)
        dy = (wo_of(mx, my + h)[0] - wo_of(mx, my - h)[0]) / (2 * h)
        fd = onp.linalg.norm(onp.cross(dx, dy))       # area scale
        theta = mx * mx * (onp.pi / 2)
        ana = max(2 * onp.pi ** 2 * mx * onp.sin(theta), 1e-6) \
            * 4.0 * onp.dot(wi, m0)
        assert abs(fd - ana) / ana < 1e-3, (mx, my, fd, ana)


def test_measured_sample_weight_consistency(tmp_path):
    from liverrenderer.bsdf.measured import (as_device_table,
                                                 measured_eval_pdf,
                                                 measured_sample)
    p = str(tmp_path / "m.bsdf")
    _synthetic_bsdf(p)
    md = as_device_table([MeasuredData(p)])
    rng = np.random.default_rng(3)
    n = 50_000
    wi = jnp.array([0.3, -0.2, 0.93])
    wi = jnp.broadcast_to(wi / jnp.linalg.norm(wi), (n, 3))
    wo, pdf_s, w = measured_sample(md, wi,
                                   jnp.asarray(rng.random(n), jnp.float32),
                                   jnp.asarray(rng.random((n, 2)),
                                               jnp.float32))
    val, pdf_e = measured_eval_pdf(md, wi, wo)
    ok = np.asarray(pdf_s) > 1e-6
    assert ok.mean() > 0.9
    rel = np.abs(np.asarray(pdf_e) - np.asarray(pdf_s))[ok] \
        / np.asarray(pdf_s)[ok]
    assert np.quantile(rel, 0.99) < 1e-3, np.quantile(rel, 0.99)
    assert np.isfinite(np.asarray(w)).all()


def test_measured_renders(tmp_path):
    p = str(tmp_path / "m.bsdf")
    _synthetic_bsdf(p)
    scene = lr.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": lr.Transform().look_at([0, 0, 3], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 12, "height": 12,
                     "rfilter": {"type": "box"}},
        },
        "ball": {"type": "sphere", "radius": 0.8,
                 "bsdf": {"type": "measured", "filename": p}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    })
    img = np.asarray(lr.render(scene, spp=32, seed=0))
    assert np.isfinite(img).all()
    mid = img[6, 6]
    assert mid[0] > mid[2], mid          # red-dominant synthetic data
    assert mid.max() < 50.0              # sane (synthetic data not energy-
                                         # normalized; just no blowup)
