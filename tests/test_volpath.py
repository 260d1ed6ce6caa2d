"""Volumetric transport tests: analytic media ground truths + bio media.

Mirrors the reference's medium test strategy (src/media/tests/
test_homogeneous.py) with analytic checks, and adds coverage the fork never
had for its own bio media (SURVEY.md par.4 gap)."""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer as lr
from liverrenderer.core import rng
from liverrenderer.media.dispatch import sample_interaction
from liverrenderer.scene.builder import load_dict


def _fog_scene(albedo, sigma_t, g=None, max_depth=64, env=1.0):
    """A scattering medium *bounded* by a null sphere in a unit env — with
    albedo 1 the equilibrium radiance everywhere is exactly env (a true
    volumetric furnace; an unbounded medium would have infinite optical
    depth to the env and converge to 0 instead)."""
    phase = {"type": "hg", "g": g} if g is not None else {"type": "isotropic"}
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth},
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 8, "height": 8,
                     "rfilter": {"type": "box"}},
        },
        "ball": {"type": "sphere", "radius": 1.0, "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous",
                              "sigma_t": {"type": "rgb",
                                          "value": [sigma_t] * 3},
                              "albedo": {"type": "rgb",
                                         "value": [albedo] * 3},
                              "phase": phase}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [env] * 3}},
    }


def test_fog_furnace_scattering_only():
    """albedo=1 bounded scattering medium inside a unit-radiance env:
    radiance is exactly 1 everywhere (volumetric energy conservation,
    including phase sampling, NEE MIS, and the null-scatter machinery)."""
    scene = load_dict(_fog_scene(1.0, 1.5, max_depth=48))
    img = np.asarray(lr.render(scene, spp=512))
    np.testing.assert_allclose(img.mean(), 1.0, atol=0.02)
    np.testing.assert_allclose(img, 1.0, atol=0.1)


def test_fog_furnace_hg():
    """Same furnace with anisotropic HG phase (g=0.7): still exactly 1."""
    scene = load_dict(_fog_scene(1.0, 1.5, g=0.7, max_depth=48))
    img = np.asarray(lr.render(scene, spp=512))
    np.testing.assert_allclose(img.mean(), 1.0, atol=0.025)


def test_beer_lambert_slab():
    """Pure absorber (albedo 0) inside a null-BSDF sphere: the center pixel
    sees env * exp(-sigma_t * chord)."""
    sigma_t = 0.8
    d = {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 16},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": lr.Transform().look_at([0, 0, 5], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 8, "height": 8,
                     "rfilter": {"type": "box"}},
        },
        "ball": {"type": "sphere", "radius": 1.0,
                 "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous",
                              "sigma_t": {"type": "rgb",
                                          "value": [sigma_t] * 3},
                              "albedo": {"type": "rgb", "value": [0.0] * 3}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }
    scene = load_dict(d)
    img = np.asarray(lr.render(scene, spp=1024))
    expect = np.exp(-sigma_t * 2.0)
    # center pixel estimator std at this spp is ~0.012 -> 4 sigma tolerance
    np.testing.assert_allclose(img[4, 4], expect, atol=0.05)
    # corner pixels miss the sphere -> env directly
    np.testing.assert_allclose(img[0, 0], 1.0, atol=0.01)


def _bio_scene_params():
    """A liver-medium scene dict (coefficients in the style of
    scenes/Liver-SingleMesh/mitsuba3/scene.xml)."""
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


def _medium_only_scene(med):
    """Build a minimal scene exposing the medium for unit-level sampling.
    integrator=biovolpath: the bio computeDistance semantics only apply
    under the bio integrator family (media/dispatch.bio_mode)."""
    return load_dict({
        "type": "scene",
        "integrator": {"type": "biovolpath"},
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4}},
        "m": med,
        "dummy": {"type": "rectangle"},
    })


def test_glisson_competing_exponentials():
    """In glisson layer 0, the free-flight distance must follow the minimum
    of two exponentials: an exponential with rate sigma_c + sigma_e."""
    scene = _medium_only_scene(_bio_scene_params())
    n = 200000
    sampler = rng.make_sampler(jnp.arange(n), 0, seed=4)
    o = jnp.zeros((n, 3))
    dvec = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    maxt = jnp.full((n,), jnp.inf)
    channel = jnp.zeros((n,), jnp.int32)
    tissue = jnp.zeros((n,))  # depth 0 -> layer 0
    mei, _ = sample_interaction(scene, jnp.zeros((n,), jnp.int32), o, dvec,
                                maxt, sampler, channel, tissue,
                                jnp.ones((n,), bool))
    t = np.asarray(mei.t)
    t = t[np.isfinite(t)]
    rate = 3.0 + 0.1   # collagen1_R + elastin1_R
    # exponential with the combined rate: mean = 1/rate
    np.testing.assert_allclose(t.mean(), 1.0 / rate, rtol=0.02)
    # scatter events are attenuators -> one-hot channel transmittance
    tr = np.asarray(mei.transmittance)
    np.testing.assert_allclose(tr[:, 0].mean(), 1.0, atol=1e-6)
    assert (tr[:, 1] == 0).all() and (tr[:, 2] == 0).all()


def test_parenchyma_absorbers_kill():
    """Beyond layer4Limit the parenchyma elements dominate; blood/bile/lipid
    events must zero the transmittance (EBioType absorber rule), hepatocyte
    events absorb only below the mean diameter (liver.cpp:508-518)."""
    scene = _medium_only_scene(_bio_scene_params())
    n = 100000
    sampler = rng.make_sampler(jnp.arange(n), 0, seed=5)
    o = jnp.zeros((n, 3))
    dvec = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    maxt = jnp.full((n,), jnp.inf)
    channel = jnp.full((n,), 1, jnp.int32)  # G
    tissue = jnp.full((n,), 0.02)  # beyond layer4Limit=0.01 -> parenchyma
    mei, _ = sample_interaction(scene, jnp.zeros((n,), jnp.int32), o, dvec,
                                maxt, sampler, channel, tissue,
                                jnp.ones((n,), bool))
    tr = np.asarray(mei.transmittance)
    t = np.asarray(mei.t)
    killed = (tr == 0).all(-1)
    scattered = tr[:, 1] == 1.0
    assert killed.mean() > 0.05           # absorbers fire
    assert scattered.mean() > 0.05        # hepatocyte attenuations fire
    # hepatocyte distance scale: -log10(269+1)*ln(u) ~ mean = log10(270)
    # among scattered (hepatocyte, d >= 0.0025) events the distances are
    # bounded below by the mean diameter rule only when killed
    hep_scale = np.log10(270.0)
    assert t[np.isfinite(t)].max() < hep_scale * 20


def test_liver_medium_in_sphere_renders():
    """End-to-end: liver medium inside a dielectric sphere under a constant
    env (the SphereLiverConstEnv configuration) renders finite and darker
    than the env."""
    d = {
        "type": "scene",
        "integrator": {"type": "biovolpath", "max_depth": 12},
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 16, "height": 16,
                     "rfilter": {"type": "box"}},
        },
        "liver_med": _bio_scene_params(),
        "ball": {"type": "sphere", "radius": 1.0,
                 "bsdf": {"type": "dielectric", "int_ior": 1.38,
                          "ext_ior": 1.0},
                 "interior": {"type": "ref", "id": "liver_med"}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }
    scene = load_dict(d)
    img = np.asarray(lr.render(scene, spp=64))
    assert np.isfinite(img).all()
    center = img[8, 8].mean()
    corner = img[0, 0].mean()
    np.testing.assert_allclose(corner, 1.0, atol=0.05)
    assert center < corner  # liver attenuates


def test_channel_stratification_exact_allocation():
    """The tracked RGB channel is stratified over each pixel's sample
    indices: spp=12 gives exactly 4 samples per channel per pixel
    (removes the channel-allocation variance of the one-hot estimator)."""
    from liverrenderer.integrators.volpath import init_state
    from liverrenderer.core.types import Ray as _Ray

    d = {
        "type": "scene",
        "integrator": {"type": "biovolpath"},
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4}},
        "dummy": {"type": "rectangle"},
    }
    scene = load_dict(d)
    spp = 12
    n_pix = 5
    pix = jnp.repeat(jnp.arange(n_pix, dtype=jnp.uint32), spp)
    samp = jnp.tile(jnp.arange(spp, dtype=jnp.uint32), n_pix)
    sampler = rng.make_sampler(pix, samp, 7, spp=spp)
    n = n_pix * spp
    ray = _Ray(o=jnp.zeros((n, 3)),
               d=jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1)),
               maxt=jnp.full((n,), jnp.inf))
    st = init_state(ray, sampler, scene)
    ch = np.asarray(st.channel).reshape(n_pix, spp)
    for p in range(n_pix):
        counts = np.bincount(ch[p], minlength=3)
        assert (counts == spp // 3).all(), (p, counts)
    # rotation varies across pixels (no global channel<->sample lock)
    assert len({tuple(ch[p]) for p in range(n_pix)}) > 1
