"""The in-repo pytree dataclass (core/struct.py) that scene and wavefront
records are built on."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from liverrenderer.core import struct

ROOT = pathlib.Path(__file__).resolve().parents[1]


@struct.dataclass
class _Rec:
    a: jax.Array
    b: jax.Array = struct.field(default_factory=lambda: jnp.zeros(2))
    n: int = struct.field(pytree_node=False, default=3)


def test_flatten_unflatten_roundtrip():
    r = _Rec(a=jnp.ones(4), b=jnp.arange(2.0), n=5)
    leaves, tree = jax.tree_util.tree_flatten(r)
    assert len(leaves) == 2                      # the static field is aux
    r2 = jax.tree_util.tree_unflatten(tree, leaves)
    assert isinstance(r2, _Rec) and r2.n == 5
    np.testing.assert_array_equal(r2.a, r.a)
    doubled = jax.tree_util.tree_map(lambda x: 2 * x, r)
    np.testing.assert_array_equal(doubled.b, [0.0, 2.0])
    assert doubled.n == 5


def test_replace_and_frozen():
    r = _Rec(a=jnp.ones(2))
    r2 = r.replace(a=jnp.zeros(2), n=7)
    assert r2.n == 7 and r.n == 3
    np.testing.assert_array_equal(r.a, [1.0, 1.0])
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.a = jnp.zeros(2)


def test_static_field_keys_jit_cache():
    traces = []

    @jax.jit
    def f(r):
        traces.append(r.n)
        return r.a * r.n

    r = _Rec(a=jnp.ones(2))
    np.testing.assert_array_equal(f(r), [3.0, 3.0])
    f(r.replace(a=jnp.zeros(2)))                 # same static: no retrace
    assert traces == [3]
    np.testing.assert_array_equal(f(r.replace(n=4)), [4.0, 4.0])
    assert traces == [3, 4]                      # new static: retrace
    assert hash(jax.tree_util.tree_structure(r)) is not None


def test_through_scan_and_grad():
    r = _Rec(a=jnp.arange(3.0))

    def body(c, _):
        return c.replace(a=c.a + c.n), None

    out, _ = jax.lax.scan(body, r, None, length=2)
    np.testing.assert_array_equal(out.a, [6.0, 7.0, 8.0])
    g = jax.grad(lambda q: jnp.sum(q.a ** 2))(r)
    assert isinstance(g, _Rec) and g.n == 3
    np.testing.assert_array_equal(g.a, [0.0, 2.0, 4.0])


def test_package_imports_without_flax():
    """The package, and the optional PIL / yaml / orbax, stay off the
    import path."""
    code = (
        "import sys\n"
        "class Hide:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'flax':\n"
        "            raise ImportError('hidden')\n"
        "sys.meta_path.insert(0, Hide())\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import liverrenderer\n"
        "bad = [m for m in ('flax', 'PIL', 'yaml', 'orbax') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]


def test_former_import_name_is_the_same_package():
    """The package's former name (the alias package beside it) imports
    without flax and yields the very same module objects."""
    (old,) = [p.name for p in ROOT.glob("liverrenderer_*")
              if (p / "__init__.py").is_file()]
    code = (
        "import sys\n"
        "class Hide:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'flax':\n"
        "            raise ImportError('hidden')\n"
        "sys.meta_path.insert(0, Hide())\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        f"import {old} as a\n"
        f"import {old}.accel.intersect as ai\n"
        f"from {old}.scene.synthetic import liver_standin\n"
        "import liverrenderer as lr, liverrenderer.accel.intersect as li\n"
        "from liverrenderer.scene import synthetic\n"
        "assert a is lr and ai is li, (a, ai)\n"
        "assert liver_standin is synthetic.liver_standin\n"
        "assert li.__spec__.name == 'liverrenderer.accel.intersect'\n"
        "assert 'flax' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
