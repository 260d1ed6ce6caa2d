"""PRB inverse rendering on the seeded liver stand-in — the BASELINE.json
evaluation config: gradients of an image loss w.r.t. the liver medium
coefficients (sigma_t analog), optimized with Adam (reference
ad/integrators/prbvolpath + drjit.opt Adam workflow)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax

import liverrenderer as lr
from liverrenderer.scene.synthetic import liver_standin

# parenchyma absorbers of the packed `liver` medium row: blood 40:43,
# bile 43:46, hepatocytes 46, lipid/water 48:51 (scene/builder.py); the
# FD check uses blood's green channel, its strongest absorption here
PARENCHYMA = slice(40, 51)
BLOOD = 41


def test_sphere_liver_gradient_finite_and_descends():
    # integrator=biovolpath: this test exercises the BIO score-function
    # gradients of the medium coefficients; the scene's default (stock
    # volpath) reaches the parenchyma medium through the standard path
    # where those coefficients are unused (media/dispatch.bio_mode)
    scene = lr.load_dict(liver_standin(seed=0, width=24, height=14, spp=4,
                                       max_depth=4))
    target = lr.render(scene, spp=16, seed=7)

    # perturb the parenchyma medium coefficients by 2x
    p0 = scene.media.params
    perturbed = p0.at[:, PARENCHYMA].multiply(2.0)
    sc = lr.apply_params(scene, {"media.params": perturbed})

    params = {"media.params": perturbed}

    def loss_fn(img):
        return jnp.mean((img - target) ** 2)

    # gradients of the bio-media score estimator: finite and non-zero
    g_acc = 0.0
    for s in range(4):
        loss0, grads, _ = lr.render_grad(sc, params, loss_fn, spp=16,
                                         seed=s)
        g = np.asarray(grads["media.params"])
        assert np.isfinite(g).all()
        g_acc = g_acc + g
    assert np.abs(g_acc[:, PARENCHYMA]).max() > 0   # medium coeffs get gradient

    # validate the strong channel (blood absorption) against correlated
    # finite differences of the *mean image*: sign + order of magnitude.
    # (weakly-coupled coefficients like the hepatocyte rate carry high
    # score-estimator variance — inherent to REINFORCE-style gradients.)
    def mean_loss(img):
        return jnp.mean(img)

    g_mean = 0.0
    for s in range(6):
        _, grads, _ = lr.render_grad(scene, {"media.params": p0},
                                     mean_loss, spp=32, seed=s)
        g_mean = g_mean + np.asarray(grads["media.params"])
    g_blood = g_mean[:, BLOOD].sum() / 6

    eps = 0.05
    def mean_at(delta):
        pm = p0.at[:, BLOOD].add(delta)
        s_in = lr.apply_params(scene, {"media.params": pm})
        tot = 0.0
        for s in range(6):
            tot += float(jnp.mean(lr.render(s_in, spp=32, seed=s,
                                            mode="ad")))
        return tot / 6
    fd = (mean_at(eps) - mean_at(-eps)) / (2 * eps)
    assert fd != 0.0
    assert np.sign(g_blood) == np.sign(fd), (g_blood, fd)
    assert 0.1 < abs(g_blood / fd) < 10.0, (g_blood, fd)
