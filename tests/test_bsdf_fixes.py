"""Round-2 BSDF fixes: roughplastic / pplastic / principledthin as real
models, blendbsdf + mask sampling via one-level nested resolution, and the
roughdielectric eval/pdf path (VERDICT round-1 items 3/5).

Mirrors the reference test strategy (src/bsdfs/tests): chi-square
sample/pdf consistency + estimator-agreement (NEE+MIS vs BSDF-sampling-only
renders must produce the same mean, which requires eval/pdf and sample to
agree)."""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer as lr
from liverrenderer.accel.intersect import ray_intersect
from liverrenderer.bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
from liverrenderer.core.types import Ray
from liverrenderer.scene.ir import F_NULL
from liverrenderer.testutil import chi2_test_sphere

WI = jnp.asarray(np.array([0.35, -0.15, 0.93]) /
                 np.linalg.norm([0.35, -0.15, 0.93]), jnp.float32)


def _plane_scene(bsdf_dict):
    d = {
        "type": "scene",
        "integrator": {"type": "path"},
        "sensor": {
            "type": "perspective", "fov": 45,
            "to_world": lr.Transform().look_at(
                origin=[0, 0, 4], target=[0, 0, 0], up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 16, "height": 16},
        },
        "plane": {"type": "rectangle", "bsdf": bsdf_dict},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }
    return lr.load_dict(d)


def _make_si(scene, n, wi=WI):
    ray = Ray(o=jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (n, 1)),
              d=jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (n, 1)),
              maxt=jnp.full((n,), jnp.inf))
    si = ray_intersect(scene, ray)
    return si.replace(wi=jnp.broadcast_to(wi, (n, 3)))


def _bsdf_chi2(bsdf_dict, subdiv=16, drop_null=False, wi=WI):
    scene = _plane_scene(bsdf_dict)

    def sample(u2, u1):
        si = _make_si(scene, u2.shape[0], wi)
        bidx = scene.shape_bsdf[jnp.maximum(si.shape, 0)]
        bs = bsdf_sample(scene, si, bidx, u1, u2)
        ok = bs.pdf > 0
        if drop_null:
            ok = ok & ((bs.sampled_type & F_NULL) == 0)
        return bs.wo, ok

    def pdf(dirs):
        si = _make_si(scene, dirs.shape[0], wi)
        bidx = scene.shape_bsdf[jnp.maximum(si.shape, 0)]
        _, p = bsdf_eval_pdf(scene, si, bidx, dirs)
        return p

    return chi2_test_sphere(sample, pdf, pdf_subdiv=subdiv)


@pytest.mark.parametrize("alpha,nonlinear", [(0.1, False), (0.4, True)])
def test_roughplastic_chi2(alpha, nonlinear):
    ok, p, stat, dof = _bsdf_chi2({
        "type": "roughplastic", "alpha": alpha, "nonlinear": nonlinear,
        "diffuse_reflectance": {"type": "rgb", "value": [0.6, 0.4, 0.3]}})
    assert ok, (alpha, p, stat, dof)


@pytest.mark.parametrize("alpha", [0.15, 0.5])
def test_pplastic_chi2(alpha):
    ok, p, stat, dof = _bsdf_chi2({
        "type": "pplastic", "alpha": alpha,
        "diffuse_reflectance": {"type": "rgb", "value": [0.5, 0.3, 0.6]}})
    assert ok, (alpha, p, stat, dof)


@pytest.mark.parametrize("spec_trans,diff_trans,rough",
                         [(0.0, 0.0, 0.4), (0.8, 0.3, 0.3), (0.5, 1.2, 0.6)])
def test_principledthin_chi2(spec_trans, diff_trans, rough):
    ok, p, stat, dof = _bsdf_chi2({
        "type": "principledthin", "roughness": rough,
        "spec_trans": spec_trans, "diff_trans": diff_trans,
        "base_color": {"type": "rgb", "value": [0.7, 0.5, 0.4]}})
    assert ok, (spec_trans, diff_trans, p, stat, dof)


def test_blendbsdf_chi2():
    """Blend of diffuse + roughconductor: sampling must match the blended
    eval/pdf (blendbsdf.cpp one-sample scheme)."""
    ok, p, stat, dof = _bsdf_chi2({
        "type": "blendbsdf", "weight": 0.35,
        "a": {"type": "diffuse",
              "reflectance": {"type": "rgb", "value": [0.8, 0.6, 0.4]}},
        "b": {"type": "roughconductor", "alpha": 0.3, "material": "none"}})
    assert ok, (p, stat, dof)


def test_mask_chi2():
    """Mask over roughconductor: nested samples must match opacity * nested
    pdf; null-transmission samples are the delta complement (dropped)."""
    ok, p, stat, dof = _bsdf_chi2({
        "type": "mask", "opacity": 0.7,
        "a": {"type": "roughconductor", "alpha": 0.25, "material": "none"}},
        drop_null=True)
    assert ok, (p, stat, dof)


def test_mask_transmission_fraction():
    """The null lobe is picked with probability 1-opacity and passes
    straight through (mask.cpp:144-146)."""
    scene = _plane_scene({
        "type": "mask", "opacity": 0.3,
        "a": {"type": "diffuse"}})
    n = 50_000
    rng = np.random.default_rng(3)
    si = _make_si(scene, n)
    bidx = scene.shape_bsdf[jnp.maximum(si.shape, 0)]
    bs = bsdf_sample(scene, si, bidx,
                     jnp.asarray(rng.random(n), jnp.float32),
                     jnp.asarray(rng.random((n, 2)), jnp.float32))
    is_null = np.asarray((bs.sampled_type & F_NULL) != 0)
    assert abs(is_null.mean() - 0.7) < 0.02
    # transmission continues straight through with weight ~ 1
    wo = np.asarray(bs.wo)[is_null]
    assert np.allclose(wo, -np.asarray(jnp.broadcast_to(WI, (n, 3)))[is_null],
                       atol=1e-5)
    w = np.asarray(bs.weight)[is_null]
    assert np.allclose(w, 1.0, atol=1e-5)


@pytest.mark.parametrize("alpha", [0.2, 0.45])
def test_roughdielectric_chi2_full_sphere(alpha):
    """Reflection AND transmission lobes vs the new eval/pdf entry."""
    ok, p, stat, dof = _bsdf_chi2({
        "type": "roughdielectric", "alpha": alpha, "int_ior": 1.5},
        subdiv=16)
    assert ok, (alpha, p, stat, dof)


def test_roughdielectric_weight_matches_eval_over_pdf():
    """sample().weight must equal eval/pdf at the sampled direction (up to
    the G2/G1 estimator identity) -- guards eval/sample consistency used by
    MIS."""
    scene = _plane_scene({"type": "roughdielectric", "alpha": 0.3,
                          "int_ior": 1.5})
    n = 20_000
    rng = np.random.default_rng(11)
    si = _make_si(scene, n)
    bidx = scene.shape_bsdf[jnp.maximum(si.shape, 0)]
    bs = bsdf_sample(scene, si, bidx,
                     jnp.asarray(rng.random(n), jnp.float32),
                     jnp.asarray(rng.random((n, 2)), jnp.float32))
    val, pdf = bsdf_eval_pdf(scene, si, bidx, bs.wo)
    ok = np.asarray((bs.pdf > 1e-3) & (pdf > 1e-3))
    w_s = np.asarray(bs.weight)[ok, 0]
    w_e = (np.asarray(val)[..., 0] / np.maximum(np.asarray(pdf), 1e-12))[ok]
    # agreement in the mean (the sample weight uses the G2/G1 identity,
    # the eval ratio uses D G2 / pdf_vis -- identical in expectation)
    assert abs(np.mean(w_s) - np.mean(w_e)) / max(np.mean(w_e), 1e-6) < 0.05
    # and pointwise within a loose factor
    ratio = w_s / np.maximum(w_e, 1e-9)
    assert np.percentile(np.abs(np.log(np.maximum(ratio, 1e-9))), 90) < 0.2


@pytest.mark.parametrize("bsdf", [
    {"type": "roughplastic", "alpha": 0.3,
     "diffuse_reflectance": {"type": "rgb", "value": [0.5, 0.5, 0.5]}},
    {"type": "blendbsdf", "weight": 0.4,
     "a": {"type": "diffuse"},
     "b": {"type": "roughconductor", "alpha": 0.3, "material": "none"}},
    {"type": "mask", "opacity": 0.6, "a": {"type": "diffuse"}},
])
def test_estimator_agreement_nee_vs_bsdf(bsdf):
    """Rendering with NEE+MIS and with pure BSDF sampling must agree in the
    mean (the reference's estimator-consistency property; catches missing
    _EVALS entries like round-1 roughdielectric)."""
    scene = _plane_scene(bsdf)
    scene = scene.replace(max_depth=3, spp=256)
    img_mis = lr.render(scene, spp=256, seed=1)
    img_bsdf = lr.render(scene.replace(needs_surface_nee=False),
                         spp=256, seed=2)
    m1 = float(jnp.mean(img_mis))
    m2 = float(jnp.mean(img_bsdf))
    assert abs(m1 - m2) / max(m1, 1e-6) < 0.03, (m1, m2)


def test_blend_mask_not_black():
    """Round-1 regression: blend/mask surfaces rendered black because no
    dispatch consumed inner/inner2 (VERDICT Missing #3)."""
    for bsdf in ({"type": "blendbsdf", "weight": 0.5,
                  "a": {"type": "diffuse"},
                  "b": {"type": "conductor", "material": "none"}},
                 {"type": "mask", "opacity": 0.99,
                  "a": {"type": "diffuse"}}):
        scene = _plane_scene(bsdf)
        img = lr.render(scene.replace(max_depth=3), spp=64, seed=0)
        # center pixels see the plane; a working surface reflects the env
        c = float(jnp.mean(img[6:10, 6:10]))
        assert c > 0.05, (bsdf["type"], c)
