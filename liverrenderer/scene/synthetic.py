"""A seeded liver-like test scene generated in the repository.

This is a stand-in, not a reference scene: a closed, smoothly displaced
icosphere (subdivision 4, 5,120 triangles, close to the 2.4-4.8k triangles of
the reference's liver meshes) bounds a `liver` medium (glisson capsule
layers over parenchyma absorbers) behind a dielectric boundary.  It rests
over a checkerboard floor and is lit by a constant environment and a point
emitter.  The defaults are the reference's own liver render configuration:
`biovolpath`, max depth 12, 1920x1080.  The displacement is drawn from
`seed`, so every run builds the same geometry from the same seed.
"""
from __future__ import annotations

import numpy as np

from .geometry import compute_vertex_normals, icosphere
from .transform import Transform

# liver size in scene units (metres): about 16 x 8 x 10 cm
_HALF_EXTENT = np.array([0.08, 0.04, 0.05])


def liver_medium() -> dict:
    """`liver` medium dict: glisson-capsule collagen/elastin per layer and
    the parenchyma absorbers (blood, bile, lipid/water, hepatocytes)."""
    d = {"type": "liver", "scale": 1.0}
    for i, (c, e) in enumerate([(3.0, 0.1), (2.7, 0.4), (0.003, 0.5),
                                (0.023, 0.2)], start=1):
        for ch, f in zip("RGB", (1.0, 0.7, 0.5)):
            d[f"sigma_collagen{i}_{ch}"] = c * f
            d[f"sigma_elastin{i}_{ch}"] = e * f
    d["sigma_blood"] = {"type": "rgb", "value": [0.005, 0.2, 0.25]}
    d["sigma_bile"] = {"type": "rgb", "value": [0.002, 0.003, 0.025]}
    d["sigma_lipid_water"] = {"type": "rgb", "value": [0.005, 0.0005, 0.001]}
    d["sigma_hepatocity"] = 269.0
    return d


def liver_mesh(seed: int = 0, subdiv: int = 4):
    """(vertices, faces, normals) of the displaced icosphere."""
    rng = np.random.default_rng(seed)
    mesh = icosphere(subdiv)
    v = mesh.vertices.astype(np.float64)
    # low-frequency radial displacement: a few random plane waves of
    # wavelength comparable to the radius keep the surface closed and smooth
    k = rng.normal(size=(4, 3)) * 1.5
    phase = rng.uniform(0.0, 2.0 * np.pi, 4)
    amp = rng.uniform(0.04, 0.08, 4)
    r = 1.0 + np.sin(v @ k.T + phase) @ amp
    v = v * r[:, None] * _HALF_EXTENT
    faces = mesh.faces
    return v.astype(np.float32), faces, compute_vertex_normals(v, faces)


def liver_standin(seed: int = 0, width: int = 1920, height: int = 1080,
                  spp: int = 16, max_depth: int = 12,
                  integrator: str = "biovolpath") -> dict:
    """Scene dict (for `load_dict`) of the seeded liver stand-in."""
    T = Transform
    v, f, n = liver_mesh(seed)
    floor_y = float(v[:, 1].min()) - 1e-3
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "sensor": {
            "type": "perspective",
            "fov": 40.0,
            "to_world": T().look_at(origin=[0.0, 0.12, 0.3],
                                    target=[0.0, -0.01, 0.0],
                                    up=[0, 1, 0]),
            "sampler": {"type": "independent", "sample_count": spp},
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
        },
        "liver": {
            "type": "mesh", "vertices": v, "faces": f, "normals": n,
            "bsdf": {"type": "dielectric", "int_ior": 1.38,
                     "ext_ior": 1.0},
            "interior": liver_medium(),
        },
        "floor": {
            "type": "rectangle",
            "to_world": T().translate([0.0, floor_y, 0.0])
                           .rotate([1, 0, 0], -90).scale(0.4),
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "checkerboard",
                                     "color0": 0.6, "color1": 0.15,
                                     "to_uv": T().scale([8.0, 8.0, 1.0])}},
        },
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
        "lamp": {"type": "point", "position": [0.15, 0.3, 0.2],
                 "intensity": {"type": "rgb", "value": [0.05, 0.05, 0.05]}},
    }
