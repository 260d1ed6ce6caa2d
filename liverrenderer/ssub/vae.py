"""Learned shape-adaptive subsurface scattering: VAE decoder inference.

Loads the reference's shipped model weights
(pysrc/outputs/vae3d/models/<name>/variables/*.bin, binary format
`int32 ndims, int32 dims..., float32 data` per scattereigen.h
NetworkHelpers::load*) and runs the three networks as batched jitted
matmuls over the wavefront — the wavefront replacement for the per-lane
Eigen inference in ScatterModelSimShared::run (scattereigen.h:314-440):

  shared preproc MLP : 23 features -> 64 -> 64 -> 64 (ReLU)
  absorption head    : 64 -> 32 (ReLU) -> 1 (sigmoid)
  scatter decoder    : [4 latent, 64 features] -> 64^3 (ReLU) -> 3

Feature layout (preprocessFeatures, scattereigen.h:152-179): 20 normalized
light-space poly coefficients, then effective-albedo, g, 2*(ior-1.25);
similarity-theory effective albedo uses the reduced albedo (g-scaled).
"""
from __future__ import annotations

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from .poly import effective_albedo

DEFAULT_MODEL_DIR = ("/root/reference/pysrc/outputs/vae3d/models/"
                     "0487_FinalSharedLs7Mixed3_AbsSharedSimComplexMixed3")
DEFAULT_STATS = ("/root/reference/pysrc/outputs/vae3d/datasets/"
                 "0118_ScatterDataMixed3/train/data_stats.json")

N_LATENT = 4


def load_bin(path: str) -> np.ndarray:
    """Reference weight file: int32 ndims, int32 dims[ndims], f32 data."""
    with open(path, "rb") as f:
        ndims = np.fromfile(f, np.int32, 1)[0]
        dims = np.fromfile(f, np.int32, ndims)
        data = np.fromfile(f, np.float32, int(np.prod(dims)))
    return data.reshape(dims)


@struct.dataclass
class VAEWeights:
    """All model tensors, stored (in_dim, out_dim) for x @ W."""
    pre_w0: jax.Array   # (23, 64)
    pre_b0: jax.Array
    pre_w1: jax.Array   # (64, 64)
    pre_b1: jax.Array
    pre_w2: jax.Array
    pre_b2: jax.Array
    abs_w0: jax.Array   # (64, 32)
    abs_b0: jax.Array
    abs_w1: jax.Array   # (32, 1)
    abs_b1: jax.Array
    dec_w0: jax.Array   # (68, 64)
    dec_b0: jax.Array
    dec_w1: jax.Array
    dec_b1: jax.Array
    dec_w2: jax.Array
    dec_b2: jax.Array
    out_w: jax.Array    # (64, 3)
    out_b: jax.Array
    feat_mean: jax.Array    # (20,)
    feat_stdinv: jax.Array  # (20,)
    albedo_mean: jax.Array  # ()
    albedo_stdinv: jax.Array
    g_mean: jax.Array
    g_stdinv: jax.Array


def load_model(model_dir: str = DEFAULT_MODEL_DIR,
               stats_path: str = DEFAULT_STATS) -> VAEWeights:
    v = os.path.join(model_dir, "variables")

    def W(name):  # stored (out, in) row-major -> transpose for x @ W
        return jnp.asarray(load_bin(os.path.join(v, name)).T)

    def b(name):
        return jnp.asarray(load_bin(os.path.join(v, name)).reshape(-1))

    stats = json.load(open(stats_path))
    # The poly-feature normalization must use the stats the model was
    # TRAINED with: training-metadata.json config0.shape_features_name =
    # "mlsPolyLS3" (light-space) for the shipped model.  NOTE the
    # reference's ScatterModelSimShared ctor hardcodes "mlsPoly3_mean"
    # (scattereigen.h:280-285) — world-space stats under a light-space
    # rotation, part of this snapshot's broken SSS plumbing (SURVEY
    # §2.6); we follow the training contract, which also matches the
    # AbsorptionModel ctor's stats[shapeFeaturesName + "_mean"].
    feat_key = "mlsPolyLS3"
    meta_path = os.path.join(model_dir, "training-metadata.json")
    if os.path.exists(meta_path):
        meta = json.load(open(meta_path))
        feat_key = meta.get("config0", {}).get("shape_features_name",
                                               feat_key)
    return VAEWeights(
        pre_w0=W("shared_preproc_mlp_2_shapemlp_fcn_0_weights.bin"),
        pre_b0=b("shared_preproc_mlp_2_shapemlp_fcn_0_biases.bin"),
        pre_w1=W("shared_preproc_mlp_2_shapemlp_fcn_1_weights.bin"),
        pre_b1=b("shared_preproc_mlp_2_shapemlp_fcn_1_biases.bin"),
        pre_w2=W("shared_preproc_mlp_2_shapemlp_fcn_2_weights.bin"),
        pre_b2=b("shared_preproc_mlp_2_shapemlp_fcn_2_biases.bin"),
        abs_w0=W("absorption_mlp_fcn_0_weights.bin"),
        abs_b0=b("absorption_mlp_fcn_0_biases.bin"),
        abs_w1=W("absorption_dense_kernel.bin"),
        abs_b1=b("absorption_dense_bias.bin"),
        dec_w0=W("scatter_decoder_fcn_fcn_0_weights.bin"),
        dec_b0=b("scatter_decoder_fcn_fcn_0_biases.bin"),
        dec_w1=W("scatter_decoder_fcn_fcn_1_weights.bin"),
        dec_b1=b("scatter_decoder_fcn_fcn_1_biases.bin"),
        dec_w2=W("scatter_decoder_fcn_fcn_2_weights.bin"),
        dec_b2=b("scatter_decoder_fcn_fcn_2_biases.bin"),
        out_w=W("scatter_dense_2_kernel.bin"),
        out_b=b("scatter_dense_2_bias.bin"),
        feat_mean=jnp.asarray(np.asarray(stats[feat_key + "_mean"],
                                         np.float32)),
        feat_stdinv=jnp.asarray(np.asarray(stats[feat_key + "_stdinv"],
                                           np.float32)),
        albedo_mean=jnp.float32(stats["effAlbedo_mean"][0]),
        albedo_stdinv=jnp.float32(stats["effAlbedo_stdinv"][0]),
        g_mean=jnp.float32(stats["g_mean"][0]),
        g_stdinv=jnp.float32(stats["g_stdinv"][0]),
    )


def model_available(model_dir: str = DEFAULT_MODEL_DIR) -> bool:
    return os.path.isdir(os.path.join(model_dir, "variables"))


def preprocess_features(w: VAEWeights, poly_ls, albedo, g, eta, sigma_t):
    """scattereigen.h preprocessFeatures<3, useSimilarityTheory=true>.

    poly_ls (N, 20) light-space coeffs; albedo/sigma_t (N,) channel values;
    g/eta scalars or (N,). Returns (N, 23)."""
    sigma_s = albedo * sigma_t
    sigma_a = sigma_t - sigma_s
    albedo_p = (1.0 - g) * sigma_s / jnp.maximum(
        (1.0 - g) * sigma_s + sigma_a, 1e-12)
    eff = effective_albedo(albedo_p)
    a_n = (eff - w.albedo_mean) * w.albedo_stdinv
    g_n = (g - w.g_mean) * w.g_stdinv
    i_n = 2.0 * (eta - 1.25)
    feat = (poly_ls - w.feat_mean) * w.feat_stdinv
    n = poly_ls.shape[0]
    extras = jnp.stack([jnp.broadcast_to(a_n, (n,)),
                        jnp.broadcast_to(g_n, (n,)),
                        jnp.broadcast_to(i_n, (n,))], -1)
    return jnp.concatenate([feat, extras], -1)


def shared_features(w: VAEWeights, x):
    """(N, 23) -> (N, 64) preproc MLP."""
    h = jax.nn.relu(x @ w.pre_w0 + w.pre_b0)
    h = jax.nn.relu(h @ w.pre_w1 + w.pre_b1)
    return jax.nn.relu(h @ w.pre_w2 + w.pre_b2)


def absorption_prob(w: VAEWeights, feat):
    """(N, 64) -> (N,) absorption probability (sigmoid head)."""
    h = jax.nn.relu(feat @ w.abs_w0 + w.abs_b0)
    return jax.nn.sigmoid((h @ w.abs_w1 + w.abs_b1)[..., 0])


def decode_outpos(w: VAEWeights, feat, latent):
    """(N, 64) features + (N, 4) latent -> (N, 3) tangent-space offset."""
    x = jnp.concatenate([latent, feat], -1)
    h = jax.nn.relu(x @ w.dec_w0 + w.dec_b0)
    h = jax.nn.relu(h @ w.dec_w1 + w.dec_b1)
    h = jax.nn.relu(h @ w.dec_w2 + w.dec_b2)
    return h @ w.out_w + w.out_b


def gaussian_from_uniform(u1, u2):
    """Box-Muller (VaeHelper::sampleGaussianVector equivalent)."""
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u1, 1e-12)))
    return r * jnp.cos(2.0 * jnp.pi * u2), r * jnp.sin(2.0 * jnp.pi * u2)
