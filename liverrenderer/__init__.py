"""liverrenderer — a differentiable wavefront renderer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
mmigas/LiverRenderer (a Mitsuba 3 fork specialized for biophysical liver
rendering): wavefront path tracing, volumetric transport with the layered
liver media, learned subsurface scattering, and radiative-backprop
differentiable rendering — built on SoA scene pytrees, jit/scan wavefront
loops, and jax.sharding for multi-chip scaling.

Facade mirrors the pieces of the `mitsuba` Python API the liver pipeline
uses: load_dict / load_file / render / cornell_box / traverse / Bitmap-ish IO.
"""

import jax as _jax

# Geometry math must be true fp32: a reduced-precision matmul (bf16, or
# TF32 on a GPU's tensor cores) quantizes camera-ray directions
# (sensor/perspective.py `d_cam @ R.T`) and shifts every silhouette by up
# to a pixel (found round 4 as a 1-px silhouette ring against the golden).
# The few matmuls in this renderer are tiny (3x3 frames, 64-wide VAE
# MLPs); reduced precision buys nothing here.
_jax.config.update("jax_default_matmul_precision", "highest")

from .scene.builder import load_dict
from .scene.cornell import cornell_box
from .scene.transform import Transform
from .scene.xml import load_file
from .integrators.common import render
from .integrators.regen import RenderControl
from .integrators.prb import render_grad, render_fwd_grad
from .integrators.aux import (render_aovs, render_depth, render_direct,
                              render_moments)
from .integrators.ptracer import render_ptracer
from .integrators.spectral import render_specfilm
from .integrators.stokes import render_stokes
from .util import traverse, apply_params, SceneParameters
from .largesteps import LargeSteps
from .io.image import read_image, write_image

__version__ = "0.1.0"

__all__ = [
    "load_dict", "load_file", "cornell_box", "Transform", "render",
    "render_grad", "render_fwd_grad", "render_aovs", "render_depth",
    "render_direct", "render_moments", "render_ptracer", "render_stokes",
    "traverse",
    "apply_params", "SceneParameters", "LargeSteps", "read_image",
    "write_image",
]
