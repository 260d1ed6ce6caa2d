"""The seeded liver stand-in (scene/synthetic.py) and the GPU smoke
script's device check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer as lr
from liverrenderer.scene.synthetic import liver_mesh, liver_standin


def test_mesh_is_closed_and_seeded():
    v, f, n = liver_mesh(seed=3)
    assert f.shape == (5120, 3)
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), 1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()                   # watertight
    np.testing.assert_array_equal(v, liver_mesh(seed=3)[0])
    assert np.abs(v - liver_mesh(seed=4)[0]).max() > 1e-3
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-5)


def test_standin_renders_and_differentiates_at_16x9():
    sc = lr.load_dict(liver_standin(seed=0, width=16, height=9, spp=4))
    assert sc.integrator == "biovolpath" and sc.max_depth == 12
    assert sc.n_tris == 5122                     # liver + floor
    from liverrenderer.integrators.regen import regen_applicable
    assert regen_applicable(sc, "primal")
    img = np.asarray(lr.render(sc, spp=4, seed=0))
    assert img.shape == (9, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    _, g, _ = lr.render_grad(sc, {"media.params": sc.media.params},
                             lambda im: jnp.mean(im), spp=4, seed=0)
    g = np.asarray(g["media.params"])
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def test_chip_smoke_refuses_cpu():
    import chip_smoke
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])

    class Gpu:
        platform = "gpu"

    chip_smoke.require_gpu([Gpu()])


def test_chip_smoke_splits_cores_for_the_cpu_reference():
    """The CPU reference process gets cores the GPU phases do not use."""
    import os

    import chip_smoke
    own, ref = chip_smoke.split_cores()
    cores = os.sched_getaffinity(0)
    if len(cores) < 4:
        assert own is None and ref is None
    else:
        assert own and ref and not set(own) & set(ref)
        assert set(own) | set(ref) == cores
