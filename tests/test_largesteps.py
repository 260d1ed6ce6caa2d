"""LargeSteps geometry preconditioner (mi.ad.LargeSteps analog)."""
import jax.numpy as jnp
import numpy as np

import liverrenderer as lr
from liverrenderer.scene import geometry as geo


def _mesh():
    return geo.icosphere(2)    # 320 faces


def test_roundtrip():
    mesh = _mesh()
    ls = lr.LargeSteps(len(mesh.vertices), mesh.faces, lambda_=19.0)
    v = jnp.asarray(mesh.vertices)
    u = ls.to_differential(v)
    v2 = ls.from_differential(u, tol=1e-8, maxiter=500)
    assert float(jnp.abs(v2 - v).max()) < 1e-4


def test_smooth_steps():
    """A single-vertex displacement in the differential domain spreads
    smoothly over the neighborhood after from_differential (the point of
    the reparameterization)."""
    mesh = _mesh()
    ls = lr.LargeSteps(len(mesh.vertices), mesh.faces, lambda_=19.0)
    v = jnp.asarray(mesh.vertices)
    u = ls.to_differential(v)
    spike = jnp.zeros_like(u).at[0, 2].set(1.0)
    v2 = ls.from_differential(u + spike, tol=1e-8, maxiter=500)
    d = np.asarray(jnp.abs(v2 - v)[:, 2])
    # the spiked vertex moves, its neighbors move a nonzero but smaller
    # amount (diffused), and the far side barely moves
    nb = np.asarray(ls.edges)
    neigh = np.unique(nb[(nb[:, 0] == 0) | (nb[:, 1] == 0)].ravel())
    neigh = neigh[neigh != 0]
    assert d[0] > d[neigh].mean() > 1e-6
    far = np.argmax(np.linalg.norm(mesh.vertices - mesh.vertices[0],
                                   axis=1))
    assert d[far] < d[0] * 0.2


def test_optimization_recovers_offsets():
    """Adam in the differential domain pulls a smoothly deformed sphere
    back to the target — large steps favor exactly these low-frequency
    moves (smoke test of the full loop)."""
    import optax
    mesh = _mesh()
    ls = lr.LargeSteps(len(mesh.vertices), mesh.faces)
    target = jnp.asarray(mesh.vertices)
    v0 = target * 1.35 + jnp.asarray([0.2, -0.1, 0.05])
    u = ls.to_differential(v0)
    opt = optax.adam(5e-2)
    state = opt.init(u)

    def loss_fn(u):
        v = ls.from_differential(u, tol=1e-6, maxiter=100)
        return jnp.mean((v - target) ** 2)

    import jax
    lg = jax.jit(jax.value_and_grad(loss_fn))
    l0, _ = lg(u)
    for _ in range(60):
        loss, g = lg(u)
        upd, state = opt.update(g, state)
        u = optax.apply_updates(u, upd)
    assert float(loss) < float(l0) * 0.5, (float(l0), float(loss))
