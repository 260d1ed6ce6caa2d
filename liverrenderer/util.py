"""Scene parameter traversal for inverse rendering.

Functional analog of mi.traverse / SceneParameters (reference
src/python/python/util.py:10): instead of registering traversal callbacks on
C++ objects, the Scene *is* a pytree, so "traversal" is just selecting
differentiable leaves.  `SceneParameters` provides the reference's
dict-of-parameters UX (keys, getitem, update) on top of a functional
`apply` that returns a new Scene.

Key vocabulary (differentiable leaves):
  bsdfs.params, textures.data, textures.bitmaps, emitters.params,
  media.params, vertices
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp

from .scene.ir import Scene


def refresh_vertex_geometry(scene: Scene, V, recompute_normals: bool = True
                            ) -> Scene:
    """Propagate updated vertex positions into every derived buffer.

    Analog of Mesh::parameters_changed (reference src/render/mesh.cpp):
    moving `vertex_positions` re-packs the intersection buffers and
    recomputes area-weighted vertex normals.  tri_si (the packed
    compute_si row) is rebuilt DIFFERENTIABLY from V so interior
    geometry gradients flow; tri_buf / tri_boxes (the intersection
    kernel's buffers) are detached — hit *finding* is non-differentiable,
    hit *recomputation* in compute_si carries the derivative.

    The kd-tree analog (scene.bvh) is NOT refitted: scenes large enough
    to select the BVH path should be rebuilt after large vertex motion.
    """
    V = jnp.asarray(V, jnp.float32)
    if scene.n_tris == 0:
        return scene.replace(vertices=V)
    F = scene.faces
    v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]

    normals = scene.normals
    if recompute_normals:
        def smooth_normals(verts):
            p0, p1, p2 = verts[F[:, 0]], verts[F[:, 1]], verts[F[:, 2]]
            fn = jnp.cross(p1 - p0, p2 - p0)      # area-weighted
            acc = jnp.zeros_like(verts)
            for k in range(3):
                acc = acc.at[F[:, k]].add(fn)
            ln2 = jnp.sum(acc * acc, -1, keepdims=True)
            # grad-safe at acc=0 (padded verts): clamp the SQUARED norm
            return jnp.where(ln2 > 1e-24,
                             acc / jnp.sqrt(jnp.maximum(ln2, 1e-24)), 0.0)

        # only vertices whose stored normal IS the smooth normal of the
        # ORIGINAL geometry are updated; authored/face normals (hard
        # edges, custom shading) are preserved (the reference only
        # recomputes when the mesh had computed normals, mesh.cpp
        # recompute_vertex_normals gating)
        old_smooth = smooth_normals(jax.lax.stop_gradient(scene.vertices))
        was_smooth = jnp.sum(old_smooth * scene.normals,
                             -1, keepdims=True) > 0.999
        normals = jnp.where(was_smooth, smooth_normals(V), scene.normals)

    tri_si = scene.tri_si
    tri_si = tri_si.at[:, 0:3].set(v0)
    tri_si = tri_si.at[:, 3:6].set(v1 - v0)
    tri_si = tri_si.at[:, 6:9].set(v2 - v0)
    tri_si = tri_si.at[:, 9:12].set(normals[F[:, 0]])
    tri_si = tri_si.at[:, 12:15].set(normals[F[:, 1]])
    tri_si = tri_si.at[:, 15:18].set(normals[F[:, 2]])

    # kernel buffers: detached re-pack in the stored BVH-leaf order
    # (Baldwin-Weber rows, the kernel's layout contract — pallas_intersect)
    Vd = jax.lax.stop_gradient(V)
    kperm = scene.tri_kperm
    valid = kperm >= 0
    fo = F[jnp.maximum(kperm, 0)]
    # re-pack in a FRESH local frame (AABB midpoint of the moved verts):
    # Baldwin-Weber rows lose fp32 precision far from their frame origin
    # (pack_tris centering rationale), and large vertex motion can carry
    # the mesh arbitrarily far from the original scene.tri_center —
    # intersect_tris shifts rays by whatever center is stored
    c = 0.5 * (jnp.min(Vd, 0) + jnp.max(Vd, 0))[None]
    b0, b1, b2 = Vd[fo[:, 0]] - c, Vd[fo[:, 1]] - c, Vd[fo[:, 2]] - c
    from .accel.pallas_intersect import bw_rows, chunk_boxes
    n_r, dn, r1, d1, r2, d2 = bw_rows(b0, b1, b2, xp=jnp)
    cols = jnp.concatenate([
        n_r, dn[:, None], r1, d1[:, None], r2, d2[:, None],
        kperm.astype(jnp.float32)[:, None]], -1)
    tri_buf = jnp.concatenate(
        [jnp.where(valid[:, None], cols, 0.0).T, scene.tri_buf[13:16]], 0)
    tri_boxes = chunk_boxes(jnp.stack([b0, b1, b2], 1), valid, xp=jnp)

    return scene.replace(vertices=V, normals=normals, tri_si=tri_si,
                         tri_buf=tri_buf, tri_boxes=tri_boxes,
                         tri_center=c[0])


# leaf key -> (getter, setter)
_LEAVES: Dict[str, tuple] = {
    "bsdfs.params": (lambda s: s.bsdfs.params,
                     lambda s, v: s.replace(bsdfs=s.bsdfs.replace(params=v))),
    "textures.data": (lambda s: s.textures.data,
                      lambda s, v: s.replace(
                          textures=s.textures.replace(data=v))),
    "textures.bitmaps": (lambda s: s.textures.bitmaps,
                         lambda s, v: s.replace(
                             textures=s.textures.replace(bitmaps=v))),
    "emitters.params": (lambda s: s.emitters.params,
                        lambda s, v: s.replace(
                            emitters=s.emitters.replace(params=v))),
    "media.params": (lambda s: s.media.params,
                     lambda s, v: s.replace(media=s.media.replace(params=v))),
    "media.grids": (lambda s: s.media.grids,
                    lambda s, v: s.replace(media=s.media.replace(grids=v))),
    "vertices": (lambda s: s.vertices, refresh_vertex_geometry),
    "volprims.opacity": (
        lambda s: s.volprims.opacity,
        lambda s, v: s.replace(volprims=s.volprims.replace(opacity=v))),
    "volprims.sh": (
        lambda s: s.volprims.sh,
        lambda s, v: s.replace(volprims=s.volprims.replace(sh=v))),
}


class SceneParameters:
    """Mutable dict-like view over a Scene's differentiable leaves
    (mi.SceneParameters analog).  Call .scene() to materialize."""

    def __init__(self, scene: Scene, keys=None):
        self._scene = scene
        self._data = {k: _LEAVES[k][0](scene)
                      for k in (keys or _LEAVES.keys())}

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __getitem__(self, k):
        return self._data[k]

    def __setitem__(self, k, v):
        self._data[k] = jnp.asarray(v, jnp.float32)

    def __contains__(self, k):
        return k in self._data

    def update(self, other: Dict[str, Any] | None = None):
        """Apply pending values (reference params.update() semantics)."""
        if other:
            for k, v in other.items():
                self[k] = v
        self._scene = apply_params(self._scene, self._data)
        return self._scene

    def scene(self) -> Scene:
        return apply_params(self._scene, self._data)

    def as_dict(self) -> Dict[str, jax.Array]:
        return dict(self._data)


def traverse(scene: Scene, keys=None) -> SceneParameters:
    return SceneParameters(scene, keys)


def apply_params(scene: Scene, params: Dict[str, Any]) -> Scene:
    """Functional parameter substitution: new Scene with leaves replaced."""
    for k, v in params.items():
        scene = _LEAVES[k][1](scene, jnp.asarray(v, jnp.float32))
    return scene
