"""Pallas intersection kernel (interpret mode) vs the XLA strategies.

The kernel runs compiled only on a GPU (`chip_smoke.py` phase (b) checks it
there at real widths); here the Pallas interpreter runs the same kernel body.
Contract: the same closest triangle as the XLA chunked sweep (`brute`) up to
ties on shared edges, t to float32 tolerance.  The same cases pin the sweep
against the lockstep BVH, and a NumPy Moeller-Trumbore sweep pins both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer as lr
from liverrenderer.accel import intersect as ix
from liverrenderer.accel import pallas_intersect as pk
from liverrenderer.core.types import Ray


def _cornell(offset=None):
    d = lr.cornell_box()
    d["sensor"]["film"]["width"] = 8
    d["sensor"]["film"]["height"] = 8
    scene = lr.load_dict(d)
    if offset is not None:
        from liverrenderer.util import refresh_vertex_geometry
        # the refit must adopt a fresh local frame for the kernel buffer
        scene = refresh_vertex_geometry(scene, scene.vertices + offset[None])
    return scene


def _rays(np_rng, n, offset=0.0, maxt=None):
    o = np_rng.uniform(-0.8, 0.8, (n, 3)) + offset
    d = np_rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.full(n, np.inf) if maxt is None else maxt
    return Ray(o=jnp.asarray(o, jnp.float32), d=jnp.asarray(d, jnp.float32),
               maxt=jnp.asarray(maxt, jnp.float32))


def _kernel(scene, ray, t_best=None):
    n = ray.o.shape[0]
    t_best = jnp.full((n,), jnp.inf) if t_best is None else t_best
    t, prim = pk.intersect_tris(scene.tri_buf, scene.tri_boxes, ray.o,
                                ray.d, ray.maxt, t_best, scene.tri_center,
                                interpret=True)
    return np.asarray(t), np.asarray(prim)


def _xla(strategy, scene, ray):
    n = ray.o.shape[0]
    t, prim, _, _ = strategy(scene, ray, jnp.full((n,), jnp.inf), False)
    return np.asarray(t), np.asarray(prim)


def _numpy_closest(v0, v1, v2, o, d, maxt):
    """Float64 Moeller-Trumbore over every (ray, triangle) pair."""
    e1, e2 = v1 - v0, v2 - v0
    pv = np.cross(d[:, None], e2[None])
    det = np.einsum("tj,rtj->rt", e1, pv)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = o[:, None] - v0[None]
    u = np.einsum("rtj,rtj->rt", tv, pv) * inv
    qv = np.cross(tv, e1[None])
    v = np.einsum("rj,rtj->rt", d, qv) * inv
    t = np.einsum("tj,rtj->rt", e2, qv) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) \
        & (t < maxt[:, None])
    t = np.where(hit, t, np.inf)
    prim = np.where(np.isfinite(t.min(1)), t.argmin(1), -1)
    return t.min(1), prim


def _assert_same_hits(t_a, p_a, t_b, p_b, min_hits=100):
    hit = p_b >= 0
    assert hit.sum() >= min_hits
    np.testing.assert_array_equal(p_a >= 0, hit)
    np.testing.assert_allclose(t_a[hit], t_b[hit], rtol=1e-5, atol=1e-6)
    # a shared edge may go to either triangle at the same t
    assert (p_a == p_b)[hit].mean() > 0.99


@pytest.mark.parametrize("n_rays", [512, 300])
def test_kernel_matches_brute(np_rng, n_rays):
    """300 rays are not a multiple of RAY_BLOCK: the padded lanes must
    neither hit nor shift the real ones."""
    scene = _cornell()
    ray = _rays(np_rng, n_rays)
    _assert_same_hits(*_kernel(scene, ray), *_xla(ix._brute_tris, scene, ray))


def test_kernel_far_from_origin_matches_brute(np_rng):
    """Scene moved ~1e4 units from the world origin: Baldwin-Weber's
    dn - n.o and u = r.p + d terms cancel catastrophically in float32
    without the local-frame re-centering (pack_tris `center`);
    Moeller-Trumbore (the brute path) subtracts o - p0 first."""
    off = np.array([1.0e4, -7.0e3, 5.0e3], np.float32)
    scene = _cornell(off)
    ray = _rays(np_rng, 512, offset=off)
    t_k, p_k = _kernel(scene, ray)
    t_b, p_b = _xla(ix._brute_tris, scene, ray)
    hit = p_b >= 0
    assert hit.sum() > 100
    # the failure mode is silent misses; t within a loose float32 bound
    assert (hit == (p_k >= 0)).mean() > 0.995
    both = hit & (p_k >= 0)
    np.testing.assert_allclose(t_k[both], t_b[both], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("bound", ["maxt", "t_best"])
def test_kernel_respects_bound(np_rng, bound):
    """Hits at or past min(maxt, t_best) are rejected."""
    scene = _cornell()
    ray = _rays(np_rng, 256)
    t_far, _ = _kernel(scene, ray)
    half = jnp.asarray(np.where(np.isfinite(t_far), 0.5 * t_far, 1e-3),
                       jnp.float32)
    if bound == "maxt":
        _, p = _kernel(scene, Ray(o=ray.o, d=ray.d, maxt=half))
    else:
        _, p = _kernel(scene, ray, t_best=half)
    assert (p < 0).all()


def test_kernel_closest_hit_across_chunks(np_rng):
    """Parallel slabs in reverse depth order, one TRI_CHUNK apart in the
    buffer: the nearest slab sits in the LAST chunk, so the running hit
    must be replaced across chunks, and rays pass the farther chunks'
    boxes first."""
    n_slabs = 5 * pk.TRI_CHUNK // 2 + 1          # also pads the last chunk
    z = np.linspace(2.0, 0.5, n_slabs)           # buffer order: far first
    v0 = np.stack([np.full(n_slabs, -1.0), np.full(n_slabs, -1.0), z], 1)
    v1 = np.stack([np.full(n_slabs, 3.0), np.full(n_slabs, -1.0), z], 1)
    v2 = np.stack([np.full(n_slabs, -1.0), np.full(n_slabs, 3.0), z], 1)
    buf, boxes, kperm, center = pk.pack_tris(v0, v1, v2)
    assert buf.shape[1] % pk.TRI_CHUNK == 0 and buf.shape[1] > 2 * pk.TRI_CHUNK
    n = 200
    o = np.concatenate([np_rng.uniform(-0.5, 0.5, (n, 2)), np.zeros((n, 1))],
                       1)
    d = np.tile([0.0, 0.0, 1.0], (n, 1))
    t, prim = pk.intersect_tris(
        jnp.asarray(buf), jnp.asarray(boxes), jnp.asarray(o, jnp.float32),
        jnp.asarray(d, jnp.float32), jnp.full((n,), jnp.inf),
        jnp.full((n,), jnp.inf), jnp.asarray(center), interpret=True)
    np.testing.assert_array_equal(np.asarray(prim), n_slabs - 1)
    np.testing.assert_allclose(np.asarray(t), 0.5, rtol=1e-6)


def _soup(np_rng, T=300, R=256):
    """A random triangle soup (not a multiple of TRI_CHUNK) and rays that
    aim into it."""
    v0 = np_rng.uniform(-1, 1, (T, 3))
    v1 = v0 + np_rng.uniform(-0.3, 0.3, (T, 3))
    v2 = v0 + np_rng.uniform(-0.3, 0.3, (T, 3))
    faces = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    verts = np.stack([v0, v1, v2], 1).reshape(-1, 3).astype(np.float32)
    scene = lr.load_dict({
        "type": "scene",
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 8, "height": 8}},
        "soup": {"type": "mesh", "vertices": verts, "faces": faces}})
    o = np_rng.uniform(-2, 2, (R, 3))
    d = np_rng.uniform(-0.6, 0.6, (R, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = Ray(o=jnp.asarray(o, jnp.float32), d=jnp.asarray(d, jnp.float32),
              maxt=jnp.full((R,), jnp.inf))
    return scene, ray, verts.astype(np.float64).reshape(T, 3, 3)


def test_kernel_and_brute_match_numpy(np_rng):
    """Both against a float64 NumPy sweep."""
    scene, ray, vv = _soup(np_rng)
    t_n, p_n = _numpy_closest(vv[:, 0], vv[:, 1], vv[:, 2],
                              np.asarray(ray.o, np.float64),
                              np.asarray(ray.d, np.float64),
                              np.full(ray.o.shape[0], np.inf))
    _assert_same_hits(*_kernel(scene, ray), t_n, p_n, min_hits=50)
    _assert_same_hits(*_xla(ix._brute_tris, scene, ray), t_n, p_n,
                      min_hits=50)


@pytest.mark.parametrize("kind", ["cornell", "soup"])
def test_bvh_matches_brute(np_rng, kind):
    """The lockstep BVH (large meshes) against the chunked sweep."""
    if kind == "cornell":
        scene, ray = _cornell(), _rays(np_rng, 512)
    else:
        scene, ray, _ = _soup(np_rng)
    _assert_same_hits(*_xla(ix._bvh_tris, scene, ray),
                      *_xla(ix._brute_tris, scene, ray), min_hits=50)


@pytest.mark.parametrize("backend,n_tris,expect", [
    ("gpu", 36, "_pallas_tris"),
    ("gpu", pk.MAX_KERNEL_TRIS, "_pallas_tris"),
    ("gpu", pk.MAX_KERNEL_TRIS + 1, "_bvh_tris"),
    ("gpu", 0, "_brute_tris"),
    ("cpu", 36, "_brute_tris"),
    ("cpu", ix.MAX_BRUTE_TRIS, "_brute_tris"),
    ("cpu", ix.MAX_BRUTE_TRIS + 1, "_bvh_tris"),
])
def test_strategy_by_backend_and_size(backend, n_tris, expect):
    """Automatic choice: the kernel only on the GPU and up to its cap; the
    renderer never selects the interpreter by itself."""
    scene = _cornell().replace(n_tris=n_tris)
    assert ix._tri_strategy(scene, backend).__name__ == expect


def test_strategy_follows_default_device(monkeypatch):
    """A CPU computation inside a GPU process (jax.default_device) never
    takes the GPU kernel."""
    scene = _cornell()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ix._tri_strategy(scene).__name__ == "_pallas_tris"
    with jax.default_device(jax.devices("cpu")[0]):
        assert ix._tri_strategy(scene).__name__ == "_brute_tris"


@pytest.mark.parametrize("forced", ["brute", "bvh", "pallas"])
def test_strategy_forced(forced):
    scene = _cornell().replace(intersector=forced)
    strat = ix._tri_strategy(scene, "cpu")
    assert strat.__name__ == f"_{forced}_tris"


def test_kernel_gradient_is_zero(np_rng):
    """Hit finding is detached: the kernel's custom_vjp returns zero
    cotangents (compute_si re-derives t, u, v differentiably)."""
    scene = _cornell()
    ray = _rays(np_rng, 128)

    def f(o):
        t, _ = pk.intersect_tris(scene.tri_buf, scene.tri_boxes, o, ray.d,
                                 ray.maxt, jnp.full((128,), jnp.inf),
                                 scene.tri_center, interpret=True)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    g = jax.grad(f)(ray.o)
    assert np.all(np.asarray(g) == 0.0)


@pytest.mark.gpu
def test_compiled_kernel_matches_brute_on_gpu(np_rng):
    """The kernel as compiled for the card (no interpreter)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
    scene = _cornell()
    ray = _rays(np_rng, 4096)
    t, prim = pk.intersect_tris(scene.tri_buf, scene.tri_boxes, ray.o,
                                ray.d, ray.maxt, jnp.full((4096,), jnp.inf),
                                scene.tri_center)
    _assert_same_hits(np.asarray(t), np.asarray(prim),
                      *_xla(ix._brute_tris, scene, ray))
