"""Spline & quadrature math (reference spline.h / quad.h)."""
import jax.numpy as jnp
import numpy as np

from liverrenderer.core.quad import (composite_simpson, gauss_legendre,
                                         integrate)
from liverrenderer.core.spline import eval_1d, integrate_1d, sample_1d


def test_spline_interpolates_nodes():
    vals = jnp.asarray([0.0, 1.0, 0.5, 2.0, 1.0])
    xs = jnp.linspace(0.0, 1.0, 5)
    out = eval_1d(xs, vals)
    np.testing.assert_allclose(np.asarray(out), np.asarray(vals), atol=1e-6)


def test_spline_reproduces_cubic():
    # Catmull-Rom is exact for quadratics
    xs_n = np.linspace(0.0, 1.0, 9)
    vals = jnp.asarray(3 * xs_n ** 2 - 2 * xs_n + 0.5)
    xq = jnp.asarray(np.random.default_rng(0).random(100) * 0.999)
    out = np.asarray(eval_1d(xq, vals))
    ref = 3 * np.asarray(xq) ** 2 - 2 * np.asarray(xq) + 0.5
    np.testing.assert_allclose(out, ref, atol=2e-2)


def test_spline_integral_matches_quadrature():
    xs_n = np.linspace(0.0, 1.0, 17)
    vals = jnp.asarray(np.sin(3 * xs_n) + 1.5)
    cdf = np.asarray(integrate_1d(vals))
    ref = integrate(lambda x: np.sin(3 * x) + 1.5, 0.0, 1.0, 32)
    assert abs(cdf[-1] - ref) < 1e-3


def test_spline_sampling_histogram():
    xs_n = np.linspace(0.0, 1.0, 17)
    vals = jnp.asarray(0.2 + xs_n ** 2)
    u = jnp.asarray(np.random.default_rng(1).random(100_000), jnp.float32)
    x = np.asarray(sample_1d(u, vals))
    hist, edges = np.histogram(x, bins=16, range=(0, 1), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    dens = (0.2 + centers ** 2)
    dens /= dens.mean()
    np.testing.assert_allclose(hist / hist.mean(), dens, rtol=0.08)


def test_gauss_legendre_exact_for_polys():
    # n-point GL integrates degree 2n-1 exactly
    val = integrate(lambda x: x ** 7 - 2 * x ** 3 + x, 0.0, 2.0, 4)
    ref = 2 ** 8 / 8 - 2 * 2 ** 4 / 4 + 2 ** 2 / 2
    assert abs(val - ref) < 1e-9


def test_composite_simpson():
    val = integrate(lambda x: np.exp(x), 0.0, 1.0, 65, composite_simpson)
    assert abs(val - (np.e - 1.0)) < 1e-8
