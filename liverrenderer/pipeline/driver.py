"""Top-level liver rendering pipeline driver.

Analog of reference LiverRenderer.py: reads RendererSettings.yml (model /
scene / resolution / spp / tissue volume fractions), computes the medium
coefficients with prepare_medium, loads the scene with the computed
parameters substituted (instead of rewriting the XML on disk,
LiverRenderer.py:81-289), renders, and writes PNG/EXR + time.txt.

Usage:
    python -m liverrenderer.pipeline.driver [settings.yml] [--scenes-dir D]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

SCENE_DIRS = {
    "Liver-SingleMesh": "Liver-SingleMesh/mitsuba3/scene.xml",
    "Liver-MultiMesh": "Liver-MultiMesh/mitsuba3/scene.xml",
    "GlissonCapsule": "GlissonCapsule/mitsuba3/scene.xml",
    "Parenchyma": "Parenchyma/mitsuba3/scene.xml",
    "SphereLiverConstEnv": "SphereLiverConstEnv/mitsuba3/scene.xml",
    "SphereLiverPoint": "SphereLiverPoint/mitsuba3/scene.xml",
    "SphereLiverCavityEnv": "SphereLiverCavityEnv/mitsuba3/scene.xml",
}


def load_settings(path: str) -> dict:
    import yaml
    with open(path) as f:
        y = yaml.safe_load(f)
    s = {
        "scene": y.get("Scene", "Liver-SingleMesh"),
        "width": int(y.get("Resolution", {}).get("Width", 1920)),
        "height": int(y.get("Resolution", {}).get("Height", 1080)),
        "spp": int(y.get("Samples Per Pixel", 256)),
        "max_depth": int(y.get("Max Depth", y.get("Max Depth ", 12))),
    }
    tissue = {}
    gc = y.get("Glisson Capsule", {}) or {}
    pa = y.get("Parenchyma", {}) or {}
    for k, v in {**gc, **pa}.items():
        tissue[k.replace("St02", "St02")] = v
    # YAML keys -> prepare_medium keys
    remap = {"blood_St02": "blood_St02", "collagen_nMed": "collagen_n_med",
             "collagen_nP": "collagen_n_p", "elastin_nMed": "elastin_n_med",
             "elastin_nP": "elastin_n_p"}
    s["tissue"] = {remap.get(k, k): v for k, v in tissue.items()}
    return s


def apply_medium_coefficients(scene, coeffs: dict):
    """Substitute the computed sigma_* values into the loaded scene's
    medium parameter rows (builder packs them per media/dispatch.py)."""
    import jax.numpy as jnp

    from ..scene.ir import (MEDIUM_GLISSON, MEDIUM_LIVER, MEDIUM_PARENCHYMA)
    prm = np.asarray(scene.media.params).copy()
    mtypes = np.asarray(scene.media.mtype)
    for i, mt in enumerate(mtypes):
        if mt not in (MEDIUM_GLISSON, MEDIUM_PARENCHYMA, MEDIUM_LIVER):
            continue
        for layer in range(4):
            for c in range(3):
                ch = "RGB"[c]
                prm[i, 12 + layer * 3 + c] = coeffs[
                    f"sigma_collagen{layer + 1}_{ch}"]
                prm[i, 24 + layer * 3 + c] = coeffs[
                    f"sigma_elastin{layer + 1}_{ch}"]
        if mt == MEDIUM_LIVER:
            prm[i, 40:43] = coeffs["sigma_blood"]
            prm[i, 43:46] = coeffs["sigma_bile"]
            prm[i, 3:6] = coeffs["sigma_lipid_water"]
            prm[i, 46] = coeffs["sigma_hepatocity"]
        elif mt == MEDIUM_PARENCHYMA:
            prm[i, 12:15] = coeffs["sigma_blood"]
            prm[i, 15:18] = coeffs["sigma_bile"]
            prm[i, 18:21] = coeffs["sigma_lipid_water"]
            prm[i, 21] = coeffs["sigma_hepatocity"]
    return scene.replace(media=scene.media.replace(params=jnp.asarray(prm)))


def run(settings_path: str = "/root/reference/RendererSettings.yml",
        scenes_dir: str = "/root/reference/scenes",
        out_dir: str = ".", spp: int | None = None,
        width: int | None = None, height: int | None = None):
    import liverrenderer as lr
    from ..log import log
    from .prepare_medium import compute_coefficients

    s = load_settings(settings_path)
    if spp:
        s["spp"] = spp
    if width:
        s["width"] = width
    if height:
        s["height"] = height

    log(f"pipeline: scene={s['scene']} {s['width']}x{s['height']} "
        f"@{s['spp']}spp d{s['max_depth']}")
    coeffs = compute_coefficients(s["tissue"])
    log("computed medium coefficients "
        f"(collagen1_R={coeffs['sigma_collagen1_R']:.4f})")

    xml = os.path.join(scenes_dir, SCENE_DIRS[s["scene"]])
    t0 = time.time()
    scene = lr.load_file(xml, res_width=s["width"], res_height=s["height"],
                         spp=s["spp"], max_depth=s["max_depth"])
    scene = apply_medium_coefficients(scene, coeffs)
    t1 = time.time()
    img = np.asarray(lr.render(scene, spp=s["spp"], seed=0))
    t2 = time.time()

    base = os.path.join(out_dir, s["scene"].lower())
    lr.write_image(base + ".exr", img)
    lr.write_image(base + ".png", img)
    with open(os.path.join(out_dir, "time.txt"), "w") as f:
        f.write(f"Scene: {s['scene']}\n")
        f.write(f"Resolution: {s['width']}x{s['height']}\n")
        f.write(f"SPP: {s['spp']}\n")
        f.write(f"Load time: {t1 - t0:.4f} s\n")
        f.write(f"Render time: {(t2 - t1) / 60.0:.4f} min\n")
    log(f"render {t2 - t1:.1f}s -> {base}.exr/.png")
    return img


def main(argv=None):
    ap = argparse.ArgumentParser(description="Liver rendering pipeline")
    ap.add_argument("settings", nargs="?",
                    default="/root/reference/RendererSettings.yml")
    ap.add_argument("--scenes-dir", default="/root/reference/scenes")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    a = ap.parse_args(argv)
    run(a.settings, a.scenes_dir, a.out_dir, a.spp, a.width, a.height)


if __name__ == "__main__":
    main()
