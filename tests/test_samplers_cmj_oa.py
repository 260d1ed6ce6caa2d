"""Real multijitter / orthogonal samplers (round-2, VERDICT item 8).

Structural tests that DISTINGUISH the patterns from plain stratified
(whose per-dimension cyclic shifts give diagonal-correlated strata, not
2D cell stratification), mirroring the reference's sampler test strategy
(src/samplers/tests/test_multijitter.py, test_orthogonal.py).
"""
import numpy as np
import jax.numpy as jnp

from liverrenderer.core.rng import make_sampler, _kensler_permute


def _pixel_samples_2d(kind, spp, pix=0, seed=0, dim_calls=1):
    """(spp, 2) samples of one pixel at the dim_calls-th next_2d call."""
    lane = jnp.full((spp,), pix, jnp.uint32)
    samp = jnp.arange(spp, dtype=jnp.uint32)
    s = make_sampler(lane, samp, seed, kind=kind, spp=spp)
    for _ in range(dim_calls - 1):
        _, s = s.next_2d()
    u, _ = s.next_2d()
    return np.asarray(u)


def test_kensler_permute_is_permutation():
    for l in (5, 8, 16, 23, 49):
        for key in (1, 77, 123456):
            i = jnp.arange(l, dtype=jnp.uint32)
            p = jnp.full((l,), key, jnp.uint32)
            out = np.asarray(_kensler_permute(i, l, p))
            assert sorted(out.tolist()) == list(range(l)), (l, key, out)


def test_multijitter_cell_and_projection_stratification():
    """CMJ: one sample per 4x4 cell AND one per 1/16 stratum in each 1D
    projection (Kensler 2013) — plain stratified fails the cell property."""
    spp = 16
    for pix in (0, 9, 101):
        u = _pixel_samples_2d("multijitter", spp, pix=pix, seed=3)
        cells = set(zip((u[:, 0] * 4).astype(int), (u[:, 1] * 4).astype(int)))
        assert len(cells) == 16, cells
        assert sorted((u[:, 0] * 16).astype(int)) == list(range(16))
        assert sorted((u[:, 1] * 16).astype(int)) == list(range(16))


def test_multijitter_nonsquare_spp():
    u = _pixel_samples_2d("multijitter", 12, pix=4, seed=1)
    # 3 x 4 grid, one per cell
    cells = set(zip((u[:, 0] * 3).astype(int), (u[:, 1] * 4).astype(int)))
    assert len(cells) == 12
    assert sorted((u[:, 0] * 12).astype(int)) == list(range(12))


def test_orthogonal_pairwise_stratification():
    """Bose OA strength 2 (p=5, spp=25): the two coordinates of every
    next_2d call are one-per-cell on the 5x5 grid."""
    spp = 25
    for dim_calls in (1, 2, 3):
        u = _pixel_samples_2d("orthogonal", spp, pix=11, seed=2,
                              dim_calls=dim_calls)
        cells = set(zip((u[:, 0] * 5).astype(int), (u[:, 1] * 5).astype(int)))
        assert len(cells) == 25, (dim_calls, cells)


def test_orthogonal_cross_dimension_stratification():
    """Strength-2 across DIFFERENT dimensions: x of call 1 vs x of call 2
    are distinct OA columns, hence also jointly one-per-cell — the property
    no per-dimension-stratified sampler has."""
    spp = 25
    u1 = _pixel_samples_2d("orthogonal", spp, pix=11, seed=2, dim_calls=1)
    u2 = _pixel_samples_2d("orthogonal", spp, pix=11, seed=2, dim_calls=2)
    cells = set(zip((u1[:, 0] * 5).astype(int), (u2[:, 0] * 5).astype(int)))
    assert len(cells) == 25


def test_variance_reduction_vs_independent():
    """Integrating a smooth 2D function: CMJ and OA cut variance well below
    independent sampling (the reference's motivation for both plugins)."""
    spp = 16
    n_streams = 300

    def est_var(kind, spp_=spp):
        lane = jnp.repeat(jnp.arange(n_streams, dtype=jnp.uint32), spp_)
        samp = jnp.tile(jnp.arange(spp_, dtype=jnp.uint32), n_streams)
        s = make_sampler(lane, samp, 7, kind=kind, spp=spp_)
        u, _ = s.next_2d()
        u = np.asarray(u).reshape(n_streams, spp_, 2)
        f = np.exp(-8.0 * ((u[..., 0] - 0.3) ** 2 + (u[..., 1] - 0.7) ** 2))
        return f.mean(1).var()

    v_ind = est_var("independent")
    v_cmj = est_var("multijitter")
    v_oa = est_var("orthogonal", 25)
    assert v_cmj < 0.35 * v_ind, (v_cmj, v_ind)
    assert v_oa < 0.35 * v_ind, (v_oa, v_ind)


def test_samples_in_unit_interval():
    for kind in ("multijitter", "orthogonal"):
        for spp in (1, 2, 7, 16, 25, 64):
            u = _pixel_samples_2d(kind, spp, pix=5, seed=9)
            assert (u >= 0).all() and (u < 1).all(), (kind, spp)
            lane = jnp.full((spp,), 5, jnp.uint32)
            s = make_sampler(lane, jnp.arange(spp, dtype=jnp.uint32), 9,
                             kind=kind, spp=spp)
            u1, _ = s.next_1d()
            u1 = np.asarray(u1)
            assert (u1 >= 0).all() and (u1 < 1).all(), (kind, spp)
