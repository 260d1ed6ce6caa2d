"""Core record types for the wavefront renderer.

Wavefront design: every record is a frozen SoA pytree (struct-of-arrays over
the wavefront/lane axis).  This replaces the reference's Dr.Jit vectorized
structs (``DRJIT_STRUCT``; cf. reference ``include/mitsuba/render/interaction.h``)
with `core.struct` dataclasses that `jax.jit` / `lax.scan` / `shard_map` can
carry natively.

All lane-shaped leaves have leading dimension N (the wavefront size); scalar
per-scene config lives on the Scene pytree instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
from . import struct

Array = jax.Array

# Epsilon used when spawning rays off surfaces, mirroring the semantics of the
# reference's `math::RayEpsilon` (include/mitsuba/core/math.h).
RAY_EPS = 1e-4
INF = jnp.inf


def static_field(**kw):
    """A non-pytree (static/aux) field on a struct dataclass."""
    return struct.field(pytree_node=False, **kw)


@struct.dataclass
class Ray:
    """A bundle of rays: origins/directions (N,3), scalar extents (N,).

    Functional analog of the reference ``Ray3f`` (include/mitsuba/core/ray.h).
    """
    o: Array          # (N, 3) origin
    d: Array          # (N, 3) direction (normalized)
    maxt: Array       # (N,)   maximum t

    @property
    def n(self):
        return self.o.shape[0]

    def at(self, t: Array) -> Array:
        return self.o + self.d * t[..., None]


def make_ray(o, d, maxt=None):
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    if maxt is None:
        maxt = jnp.full(o.shape[:-1], INF, jnp.float32)
    return Ray(o=o, d=d, maxt=maxt)


@struct.dataclass
class Frame:
    """Orthonormal shading frame (s, t, n), each (N, 3).

    Analog of the reference ``Frame3f`` (include/mitsuba/core/frame.h) —
    to_local/to_world are batched 3x3 products that XLA fuses.
    """
    s: Array
    t: Array
    n: Array

    def to_local(self, v: Array) -> Array:
        return jnp.stack([
            jnp.sum(v * self.s, -1),
            jnp.sum(v * self.t, -1),
            jnp.sum(v * self.n, -1),
        ], -1)

    def to_world(self, v: Array) -> Array:
        return (v[..., 0:1] * self.s + v[..., 1:2] * self.t
                + v[..., 2:3] * self.n)


@struct.dataclass
class SurfaceInteraction:
    """Surface interaction record (all fields lane-shaped).

    Mirrors the capability of the reference ``SurfaceInteraction3f``
    (include/mitsuba/render/interaction.h:232-241 for the fork's BSSRDF
    extensions, added separately in ssub/).
    """
    t: Array           # (N,) hit distance; inf => no hit
    p: Array           # (N,3) hit position
    ng: Array          # (N,3) geometric normal
    sh_frame: Frame    # shading frame
    uv: Array          # (N,2)
    wi: Array          # (N,3) incident dir in *local* shading frame
    prim: Array        # (N,) int32 triangle/primitive index (global)
    shape: Array       # (N,) int32 shape index, -1 when invalid
    # interpolated per-vertex attribute (mesh_attribute textures); zeros
    # when the scene carries no vertex attributes
    attr: Array = struct.field(
        default_factory=lambda: jnp.zeros((1, 3), jnp.float32))
    # dP/duv for texture filtering is omitted round 1 (no ray differentials).

    @property
    def valid(self) -> Array:
        return jnp.isfinite(self.t)

    def to_local(self, v):
        return self.sh_frame.to_local(v)

    def to_world(self, v):
        return self.sh_frame.to_world(v)

    def spawn_ray(self, d: Array) -> Ray:
        o = offset_p(self.p, self.ng, d)
        return Ray(o=o, d=d, maxt=jnp.full(self.t.shape, INF, jnp.float32))

    def spawn_ray_to(self, p2: Array) -> Ray:
        o = offset_p(self.p, self.ng, p2 - self.p)
        d = p2 - o
        dist = jnp.linalg.norm(d, axis=-1)
        d = d / jnp.maximum(dist, 1e-20)[..., None]
        return Ray(o=o, d=d, maxt=dist * (1.0 - 1e-3))


def offset_p(p: Array, ng: Array, d: Array) -> Array:
    """Offset a spawn origin along the geometric normal to avoid self-hits
    (semantics of reference interaction.h `offset_p`)."""
    mag = (1.0 + jnp.max(jnp.abs(p), axis=-1)) * RAY_EPS
    sgn = jnp.where(jnp.sum(ng * d, -1) >= 0.0, 1.0, -1.0)
    return p + (sgn * mag)[..., None] * ng


@struct.dataclass
class MediumInteraction:
    """Medium interaction record, analog of reference ``MediumInteraction3f``."""
    t: Array                    # (N,) sampled distance, inf => escaped medium
    p: Array                    # (N,3)
    sigma_s: Array              # (N,3)
    sigma_n: Array              # (N,3)
    sigma_t: Array              # (N,3)
    combined_extinction: Array  # (N,3) majorant
    transmittance: Array        # (N,3) fork extension: liver media set this
                                # to a one-hot channel mask (liver.cpp:521-534)
    log_p: Array = None         # (N,) differentiable log-likelihood of the
                                # sampled event (bio media score estimator;
                                # 0 for stock media whose tr/pdf ratio
                                # already carries the gradient)

    @property
    def valid(self) -> Array:
        return jnp.isfinite(self.t)


@struct.dataclass
class BSDFSample:
    wo: Array            # (N,3) sampled outgoing dir, local frame
    pdf: Array           # (N,)
    eta: Array           # (N,) relative IOR of the sampled event
    sampled_type: Array  # (N,) uint32 BSDFFlags of sampled lobe
    weight: Array        # (N,3) bsdf_val * cos / pdf


@struct.dataclass
class DirectionSample:
    """Emitter direction sample (reference records.h DirectionSample3f)."""
    p: Array       # (N,3) point on emitter
    n: Array       # (N,3) normal at emitter point
    d: Array       # (N,3) direction ref->emitter (unit)
    dist: Array    # (N,)
    pdf: Array     # (N,) solid-angle density
    delta: Array   # (N,) bool: Dirac (point/directional)
    emitter: Array # (N,) int32 emitter index (-1 invalid)


def select_st(mask: Array, a: Any, b: Any):
    """Tree-wise jnp.where(mask, a, b) with broadcast over trailing dims."""
    def sel(x, y):
        m = mask
        while m.ndim < jnp.ndim(x):
            m = m[..., None]
        return jnp.where(m, x, y)
    return jax.tree_util.tree_map(sel, a, b)
