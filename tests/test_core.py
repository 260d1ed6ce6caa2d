"""Core-layer unit tests: RNG, warps, fresnel, distributions, EXR IO."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from liverrenderer.core import fresnel as fr
from liverrenderer.core import math as lm
from liverrenderer.core import rng, warp
from liverrenderer.core.distr import DiscreteDistribution, Distribution2D


def test_rng_uniform():
    s = rng.make_sampler(jnp.arange(100000), 0, seed=3)
    u, s = s.next_1d()
    u = np.asarray(u)
    assert u.min() >= 0 and u.max() < 1
    assert abs(u.mean() - 0.5) < 5e-3
    assert abs(np.var(u) - 1 / 12) < 5e-3
    # successive dims decorrelated
    v, s = s.next_1d()
    assert abs(np.corrcoef(u, np.asarray(v))[0, 1]) < 0.01


def test_rng_replay_determinism():
    """Counter-based streams replay exactly (required by PRB)."""
    s1 = rng.make_sampler(jnp.arange(64), 5, seed=9)
    s2 = rng.make_sampler(jnp.arange(64), 5, seed=9)
    u1, _ = s1.next_1d()
    u2, _ = s2.next_1d()
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))


@pytest.mark.parametrize("warp_fn,pdf_fn", [
    (warp.square_to_cosine_hemisphere, warp.square_to_cosine_hemisphere_pdf),
    (warp.square_to_uniform_sphere, warp.square_to_uniform_sphere_pdf),
    (warp.square_to_uniform_hemisphere, warp.square_to_uniform_hemisphere_pdf),
])
def test_warp_normalization(warp_fn, pdf_fn):
    """Monte-Carlo check: E[1/pdf over sampled dirs] == domain area."""
    s = rng.make_sampler(jnp.arange(200000), 0, seed=1)
    u, s = s.next_2d()
    d = warp_fn(u)
    n = np.asarray(lm.norm(d))
    np.testing.assert_allclose(n, 1.0, atol=1e-4)
    pdf = np.asarray(pdf_fn(d))
    assert (pdf > 0).all()


def test_hg_pdf_integrates_to_one():
    # integrate HG pdf over the sphere by quadrature
    for g in [0.0, 0.3, 0.8, -0.5]:
        ct = np.linspace(-1, 1, 20001)
        pdf = np.asarray(warp.hg_pdf(jnp.asarray(ct), g))
        integral = 2 * np.pi * np.trapezoid(pdf, ct)
        assert abs(integral - 1.0) < 1e-3, (g, integral)


def test_hg_sampling_matches_pdf():
    g = 0.7
    s = rng.make_sampler(jnp.arange(400000), 0, seed=2)
    u, s = s.next_2d()
    d = warp.square_to_hg(u, g)
    ct = np.asarray(d[..., 2])
    # histogram test against analytic pdf (marginal over cos_theta)
    hist, edges = np.histogram(ct, bins=50, range=(-1, 1), density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    ana = 2 * np.pi * np.asarray(warp.hg_pdf(jnp.asarray(centers), g))
    np.testing.assert_allclose(hist, ana, rtol=0.1, atol=0.02)


def test_fresnel_dielectric_basics():
    # normal incidence on glass: ((n-1)/(n+1))^2
    F, ctt, eta_it, eta_ti = fr.fresnel_dielectric(jnp.asarray([1.0]), 1.5)
    np.testing.assert_allclose(F[0], ((1.5 - 1) / (1.5 + 1)) ** 2, rtol=1e-5)
    # TIR from inside beyond critical angle
    ci = np.cos(np.deg2rad(50.0))  # > critical (41.8 deg) from inside
    F, _, _, _ = fr.fresnel_dielectric(jnp.asarray([-ci]), 1.5)
    np.testing.assert_allclose(F[0], 1.0)


def test_fresnel_energy_monotone():
    ci = jnp.linspace(0.02, 1.0, 64)
    F, _, _, _ = fr.fresnel_dielectric(ci, 1.5)
    assert (np.diff(np.asarray(F)) <= 1e-6).all()


def test_discrete_distribution():
    d = DiscreteDistribution.build(jnp.asarray([1.0, 2.0, 3.0, 0.0, 4.0]))
    s = rng.make_sampler(jnp.arange(100000), 0, seed=7)
    u, _ = s.next_1d()
    idx, pdf = d.sample(u)
    counts = np.bincount(np.asarray(idx), minlength=5) / 100000.0
    np.testing.assert_allclose(counts, [0.1, 0.2, 0.3, 0.0, 0.4], atol=5e-3)
    np.testing.assert_allclose(np.asarray(d.eval_pdf(jnp.asarray([1]))), [0.2])


def test_distribution2d():
    w = jnp.asarray(np.random.default_rng(0).random((16, 32)).astype(np.float32))
    d = Distribution2D.build(w)
    s = rng.make_sampler(jnp.arange(200000), 0, seed=11)
    u, _ = s.next_2d()
    pos, pdf = d.sample(u)
    col = np.clip(np.asarray(pos[..., 0]).astype(int), 0, 31)
    row = np.clip(np.asarray(pos[..., 1]).astype(int), 0, 15)
    hist = np.zeros((16, 32))
    np.add.at(hist, (row, col), 1.0)
    hist /= hist.sum()
    ana = np.asarray(w) / np.asarray(w).sum()
    np.testing.assert_allclose(hist, ana, atol=2e-3)


def test_exr_roundtrip(tmp_path):
    from liverrenderer.io.exr import read_exr, write_exr
    img = np.random.default_rng(1).random((37, 53, 3)).astype(np.float32)
    p = str(tmp_path / "t.exr")
    write_exr(p, img, half=False)
    back = read_exr(p)
    np.testing.assert_allclose(back, img, atol=1e-6)
    write_exr(p, img, half=True)
    back = read_exr(p)
    np.testing.assert_allclose(back, img, atol=2e-3)


def test_png_roundtrip(tmp_path):
    from liverrenderer.io.image import read_image, write_image
    img = np.random.default_rng(2).random((16, 16, 3)).astype(np.float32)
    p = str(tmp_path / "t.png")
    write_image(p, img)
    back = read_image(p)
    np.testing.assert_allclose(back, img, atol=2e-2)
