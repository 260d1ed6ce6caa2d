"""Chi-square sample/pdf consistency tests (the reference's chi2.py
strategy, src/bsdfs/tests + src/phase/tests/test_hg.py analog)."""
import jax.numpy as jnp
import numpy as np
import pytest

from liverrenderer.core import warp
from liverrenderer.phase.dispatch import phase_eval, phase_sample
from liverrenderer.scene.ir import PHASE_HG, PHASE_ISOTROPIC
from liverrenderer.testutil import chi2_test_sphere


def test_uniform_sphere_chi2():
    ok, p, stat, dof = chi2_test_sphere(
        lambda u2, u1: warp.square_to_uniform_sphere(u2),
        lambda d: jnp.full(d.shape[:-1], warp.INV_FOURPI))
    assert ok, (p, stat, dof)


def test_cosine_hemisphere_chi2():
    def pdf(d):
        return jnp.maximum(d[..., 2], 0.0) / jnp.pi

    ok, p, stat, dof = chi2_test_sphere(
        lambda u2, u1: warp.square_to_cosine_hemisphere(u2), pdf)
    assert ok, (p, stat, dof)


@pytest.mark.parametrize("g", [-0.5, 0.0, 0.3, 0.8])
def test_hg_phase_chi2(g):
    fwd = jnp.array([0.0, 0.0, 1.0])

    def sample(u2, u1):
        n = u2.shape[0]
        ptype = jnp.full((n,), PHASE_HG, jnp.int32)
        gl = jnp.full((n,), g)
        wo, _, _ = phase_sample(ptype, gl, jnp.broadcast_to(fwd, (n, 3)), u2)
        return wo

    def pdf(d):
        n = d.shape[0]
        ptype = jnp.full((n,), PHASE_HG, jnp.int32)
        return phase_eval(ptype, jnp.full((n,), g), d[..., 2])

    # strongly peaked lobes need finer pdf quadrature inside each cell
    ok, p, stat, dof = chi2_test_sphere(sample, pdf, pdf_subdiv=16)
    assert ok, (g, p, stat, dof)


def test_chi2_catches_wrong_pdf():
    """The harness must REJECT a mismatched pdf (sanity of the test)."""
    ok, p, _, _ = chi2_test_sphere(
        lambda u2, u1: warp.square_to_cosine_hemisphere(u2),
        lambda d: jnp.full(d.shape[:-1], warp.INV_FOURPI))
    assert not ok


def test_diffuse_bsdf_chi2():
    """Diffuse BSDF sampling vs its eval/pdf (src/bsdfs/tests analog)."""
    import liverrenderer as lr
    from liverrenderer.accel.intersect import ray_intersect
    from liverrenderer.bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
    from liverrenderer.core.types import Ray

    d = lr.cornell_box()
    scene = lr.load_dict(d)
    n = 200_000

    wi = jnp.array([0.3, -0.2, 0.9])
    wi = wi / jnp.linalg.norm(wi)

    def make_si(n):
        ray = Ray(o=jnp.tile(jnp.array([[0.0, 0.0, 0.0]]), (n, 1)),
                  d=jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (n, 1)),
                  maxt=jnp.full((n,), jnp.inf))
        si = ray_intersect(scene, ray)
        return si.replace(wi=jnp.broadcast_to(wi, (n, 3)))

    def sample(u2, u1):
        si = make_si(u2.shape[0])
        bsdf_idx = scene.shape_bsdf[jnp.maximum(si.shape, 0)]
        bs = bsdf_sample(scene, si, bsdf_idx, u1, u2)
        return bs.wo

    def pdf(dirs):
        si = make_si(dirs.shape[0])
        bsdf_idx = scene.shape_bsdf[jnp.maximum(si.shape, 0)]
        _, p = bsdf_eval_pdf(scene, si, bsdf_idx, dirs)
        return p

    ok, p, stat, dof = chi2_test_sphere(sample, pdf)
    assert ok, (p, stat, dof)


@pytest.mark.parametrize("metallic,rough", [(0.0, 0.3), (1.0, 0.2),
                                            (0.5, 0.6)])
def test_principled_bsdf_chi2(metallic, rough):
    """Principled BSDF sample/eval-pdf consistency."""
    import liverrenderer as lr
    from liverrenderer.accel.intersect import ray_intersect
    from liverrenderer.bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
    from liverrenderer.core.types import Ray

    d = lr.cornell_box()
    d["floor_override"] = None
    del d["floor_override"]
    # replace a wall bsdf with principled by building a tiny scene
    d2 = {
        "type": "scene",
        "integrator": {"type": "path"},
        "sensor": d["sensor"],
        "plane": {"type": "rectangle",
                  "bsdf": {"type": "principled", "metallic": metallic,
                           "roughness": rough,
                           "base_color": {"type": "rgb",
                                          "value": [0.7, 0.5, 0.4]}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }
    scene = lr.load_dict(d2)
    wi = jnp.array([0.4, -0.1, 0.9])
    wi = wi / jnp.linalg.norm(wi)

    def make_si(n):
        ray = Ray(o=jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (n, 1)),
                  d=jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (n, 1)),
                  maxt=jnp.full((n,), jnp.inf))
        si = ray_intersect(scene, ray)
        return si.replace(wi=jnp.broadcast_to(wi, (n, 3)))

    def sample(u2, u1):
        si = make_si(u2.shape[0])
        bs = bsdf_sample(scene, si,
                         scene.shape_bsdf[jnp.maximum(si.shape, 0)], u1, u2)
        return bs.wo, bs.pdf > 0

    def pdf(dirs):
        si = make_si(dirs.shape[0])
        _, p = bsdf_eval_pdf(scene, si,
                             scene.shape_bsdf[jnp.maximum(si.shape, 0)],
                             dirs)
        return p

    ok, p, stat, dof = chi2_test_sphere(sample, pdf, pdf_subdiv=16)
    assert ok, (metallic, rough, p, stat, dof)


@pytest.mark.parametrize("beta_m,beta_n", [(0.3, 0.3), (0.6, 0.2)])
def test_hair_bsdf_chi2(beta_m, beta_n):
    """Hair fiber sampling vs pdf (src/bsdfs/hair.cpp capability)."""
    from liverrenderer.bsdf.hair import hair_eval_pdf, hair_sample

    wi = jnp.array([0.35, 0.2, 0.91])
    wi = wi / jnp.linalg.norm(wi)
    p_row = jnp.array([1.55, beta_m, beta_n, np.deg2rad(2.0)])

    def sample(u2, u1):
        n = u2.shape[0]
        wo, _, _, _, _ = hair_sample(
            jnp.broadcast_to(wi, (n, 3)), u1, u2,
            jnp.broadcast_to(p_row, (n, 4)), jnp.full((n, 3), 0.2))
        return wo

    def pdf(dirs):
        n = dirs.shape[0]
        _, p = hair_eval_pdf(jnp.broadcast_to(wi, (n, 3)), dirs,
                             jnp.broadcast_to(p_row, (n, 4)),
                             jnp.full((n, 3), 0.2))
        return p

    ok, p, stat, dof = chi2_test_sphere(sample, pdf, pdf_subdiv=16)
    assert ok, (beta_m, beta_n, p, stat, dof)


def _phase_chi2(ptype_code, prm_row, g=0.0, subdiv=16):
    fwd = jnp.array([0.0, 0.0, 1.0])

    def sample(u2, u1):
        n = u2.shape[0]
        ptype = jnp.full((n,), ptype_code, jnp.int32)
        gl = jnp.full((n,), g)
        prm = jnp.broadcast_to(prm_row, (n,) + prm_row.shape)
        wo, _, _ = phase_sample(ptype, gl, jnp.broadcast_to(fwd, (n, 3)),
                                u2, prm)
        return wo

    def pdf(d):
        n = d.shape[0]
        ptype = jnp.full((n,), ptype_code, jnp.int32)
        gl = jnp.full((n,), g)
        prm = jnp.broadcast_to(prm_row, (n,) + prm_row.shape)
        return phase_eval(ptype, gl, d[..., 2], prm,
                          jnp.broadcast_to(fwd, (n, 3)), d)

    return chi2_test_sphere(sample, pdf, pdf_subdiv=subdiv)


def test_blendphase_chi2():
    from liverrenderer.scene.ir import PHASE_BLEND, PHASE_HG, \
        PHASE_ISOTROPIC
    prm = jnp.zeros(48).at[11].set(0.35).at[12].set(PHASE_HG) \
        .at[13].set(0.6).at[14].set(PHASE_ISOTROPIC)
    ok, p, stat, dof = _phase_chi2(PHASE_BLEND, prm)
    assert ok, (p, stat, dof)


def test_tabphase_chi2():
    from liverrenderer.scene.ir import PHASE_TAB
    vals = np.linspace(0.2, 2.0, 32) ** 2
    prm = jnp.zeros(48).at[16:48].set(jnp.asarray(vals, jnp.float32))
    ok, p, stat, dof = _phase_chi2(PHASE_TAB, prm)
    assert ok, (p, stat, dof)


def test_sggx_phase_chi2():
    from liverrenderer.scene.ir import PHASE_SGGX
    # anisotropic fiber-like S
    prm = jnp.zeros(48).at[16].set(1.0).at[17].set(0.25).at[18].set(0.6) \
        .at[19].set(0.1)
    ok, p, stat, dof = _phase_chi2(PHASE_SGGX, prm, subdiv=16)
    assert ok, (p, stat, dof)
