"""Tonemapping utility (reference src/python/python/tonemap.py analog):
EXR -> LDR PNG with exposure / gamma / Reinhard options.

    python -m liverrenderer.tonemap in.exr out.png --exposure 1.5
"""
from __future__ import annotations

import argparse

import numpy as np


def tonemap(img: np.ndarray, exposure: float = 0.0, gamma: float | None
            = None, reinhard: bool = False) -> np.ndarray:
    """Linear HDR -> display-encoded LDR in [0,1].  exposure in f-stops;
    gamma=None applies the sRGB transfer curve."""
    from .core.spectrum import linear_to_srgb_np
    x = np.asarray(img, np.float32) * (2.0 ** exposure)
    if reinhard:
        # luminance-normalized Reinhard operator
        lum = 0.212671 * x[..., 0] + 0.715160 * x[..., 1] \
            + 0.072169 * x[..., 2]
        scale = 1.0 / (1.0 + lum)
        x = x * scale[..., None]
    x = np.clip(x, 0.0, None)
    if gamma is None:
        out = linear_to_srgb_np(x)
    else:
        out = x ** (1.0 / gamma)
    return np.clip(out, 0.0, 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description="HDR -> LDR tonemapper")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--exposure", type=float, default=0.0,
                    help="exposure in f-stops")
    ap.add_argument("--gamma", type=float, default=None,
                    help="gamma (default: sRGB curve)")
    ap.add_argument("--reinhard", action="store_true")
    a = ap.parse_args(argv)

    from .io.image import read_image
    from PIL import Image
    img = read_image(a.input)
    ldr = tonemap(img, a.exposure, a.gamma, a.reinhard)
    Image.fromarray((ldr * 255 + 0.5).astype(np.uint8)).save(a.output)
    print(f"wrote {a.output}")


if __name__ == "__main__":
    main()
