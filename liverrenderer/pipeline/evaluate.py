"""End-to-end evaluation against the reference's shipped goldens.

The results.py analog as a batch tool: renders each liver scene whose
reference EXR golden survives in the checkout and reports RMSE/SSIM
(optionally masked), writing a JSON table + side-by-side PNGs.

    python -m liverrenderer.pipeline.evaluate --out-dir results/
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# scene xml -> (golden image, mask exr or None, opts), paths relative to
# scenes/.  EXR goldens compare in linear radiance; PNG goldens (the
# reference's committed Mitsuba3-CPU renders, scenes/*/mitsuba3/outputs/)
# compare in display (sRGB) space — both sides tonemapped identically.
#
# legacy_env: GlissonCapsule / Parenchyma goldens were rendered BEFORE
# the envmap switch (their backgrounds are pure white; the current
# scene.xml's cavidade envmap at scale 2.5 cannot clip to white in a
# view that renders pink in Liver-SingleMesh — same camera, same
# emitter block; the constant white emitter is still in the XML,
# commented out).  Those scenes are evaluated with the legacy constant
# white environment restored.
CONFIGS = {
    "Liver-MultiMesh": ("Liver-MultiMesh/mitsuba3/scene.xml",
                        "Liver-MultiMesh/mitsuba3/scene.exr",
                        "Liver-MultiMesh/mitsuba3/LiverMask-MultiMesh.exr",
                        {}),
    # denoise_probe: additionally render at that (low) spp, denoise with
    # the SVGF-style a-trous filter (denoise.py), and report noisy vs
    # denoised metrics against the golden — the OptixRSME.png analog
    # (reference results/OptixRSME.png, optixdenoiser.cpp).
    "Liver-SingleMesh": (
        "Liver-SingleMesh/mitsuba3/scene.xml",
        "Liver-SingleMesh/mitsuba3/outputs/Mitsuba3/CPU/liver-singlemesh.png",
        None, {"denoise_probe": 16}),
    # Integrator stays the scene default (biovolpath06): a tiny-res probe
    # against the golden pins it — biovolpath06 object mean 0.664/0.662/
    # 0.657 vs golden 0.656/0.650/0.646, while a stock-volpath override
    # reads 0.511 (glisson attenuators are lossless scatterers under the
    # bio path; volpath sees the medium's default 0.75 albedo instead).
    "GlissonCapsule": (
        "GlissonCapsule/mitsuba3/scene.xml",
        "GlissonCapsule/mitsuba3/outputs/Mitsuba3/CPU/glissoncapsule.png",
        None, {"legacy_env": True}),
    # Parenchyma: the committed golden does NOT correspond to scene.xml
    # (hide_emitters=true + constant env -> black background; the golden
    # shows the pink cavidade envmap and a dark bio liver).  Round-4
    # archaeology reconstructed the config: scene_temp.xml (the RUNNER-
    # written file with prepare_medium's per-channel sigmas — the flat
    # "360:x" placeholders of scene.xml render the object 40% too dark)
    # + the commented-out cavidade envmap + hide_emitters=false.  Probe:
    # bg corner matches exactly (0.692/0.362/0.35x), object mean within
    # noise of the golden's (0.420/0.152/0.147 vs 0.447/0.176/0.167 at
    # 48spp/96x54).
    "Parenchyma": (
        "Parenchyma/mitsuba3/scene_temp.xml",
        "Parenchyma/mitsuba3/outputs/Mitsuba/CPU/parenchyma.png",
        None, {"restore_envmap": True, "hide_emitters": False}),
    # the golden EXR is byte-for-near the shipped scene_temp.exr (mean
    # diff <2%, 16-spp noise) => it was rendered from scene_temp.xml:
    # 960x540 @ 16spp, max_depth 12 (NOT scene.xml's 65).  Evaluating
    # the temp config both matches provenance and avoids compiling the
    # depth-65 programs, which took 20+ minutes.
    "SphereLiverConstEnv": (
        "SphereLiverConstEnv/mitsuba3/scene_temp.xml",
        "SphereLiverConstEnv/mitsuba3/sphereliverconstenv.exr",
        None, {}),
    "SphereLiverPoint": (
        "SphereLiverPoint/mitsuba3/scene.xml",
        "SphereLiverPoint/mitsuba3/sphereliverpoint.exr",
        None, {}),
    # Learned-SSS end-to-end vs the shipped golden (vaescatter.cpp demo;
    # results/LearnedRSME.png analog).  TWO caveats, both forensically
    # documented in pipeline/soap_substitute.json:
    #   1. soap_fine.obj is STRIPPED from this checkout
    #      (.MISSING_LARGE_BLOBS:24) — a rounded-box stand-in fitted to
    #      the golden silhouette (IoU ~0.89, tools/fit_soap.py)
    #      substitutes, so full-frame metrics are silhouette-limited;
    #   2. the golden's OBJECT is a stale render from a different medium
    #      config (its near-black radiance is unreachable under the XML's
    #      0.9966+ albedo at ANY object scale — scale sweep + shipped
    #      absorption-head probe in soap_substitute.json; same failure
    #      mode as the Parenchyma golden above).
    # The background (pure envmap through the sensor/filter/develop path)
    # IS valid reference data -> rmse/ssim_background are the parity
    # numbers; object means are reported for the record.
    "SphereLiverPoint-SSS": (
        "SphereLiverPoint/sss/scene.xml",
        "SphereLiverPoint/sss/scene.exr",
        None, {"substitute": "soap", "sss_report": True}),
}


def _clean_error(e: Exception, limit: int = 400) -> str:
    """Persistable error string: ANSI escapes and infra log lines (URLs,
    host paths) stripped, truncated — raw XLA errors embed both."""
    import re
    txt = f"{type(e).__name__}: {e}"
    txt = re.sub(r"\x1b\[[0-9;]*m", "", txt)
    lines = [ln for ln in txt.splitlines()
             if not re.search(r"https?://|^[EWI]\d{4}|\.cc:\d", ln)]
    out = " ".join(" ".join(lines).split())
    return out[:limit] + ("…" if len(out) > limit else "")


def _subsurface_silhouette(scene) -> np.ndarray:
    """(h, w) bool mask of pixels whose center camera ray hits a shape
    with a subsurface instance attached — the exact object silhouette."""
    import jax.numpy as jnp

    from ..accel.intersect import ray_intersect
    from ..core import math as m
    from ..sensor.perspective import sample_ray

    w, h = scene.film_w, scene.film_h
    px, py = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    pos = jnp.asarray(np.stack([px.ravel(), py.ravel()], -1), jnp.float32)
    si = ray_intersect(scene, sample_ray(scene, pos))
    ss = m.table_lookup(scene.shape_subsurface, jnp.maximum(si.shape, 0))
    return np.asarray(si.valid & (ss >= 0)).reshape(h, w)


def _load_scene(path: str, opts: dict, w: int, h: int, spp: int):
    import liverrenderer as lr  # noqa: F401
    from ..scene.builder import load_dict
    from ..scene.xml import parse_xml
    ov = {"res_width": w, "res_height": h, "spp": spp}
    if "integrator" in opts:
        ov["integrator"] = opts["integrator"]
    d = parse_xml(path, ov)
    if opts.get("legacy_env"):
        for k, v in list(d.items()):
            if isinstance(v, dict) and v.get("type") == "envmap":
                d[k] = {"type": "constant",
                        "radiance": {"type": "rgb", "value": [1.0] * 3}}
    if opts.get("restore_envmap"):
        # the cavidade envmap block commented out of the shipped XMLs
        # (scene.xml:68-76 in Parenchyma) — the goldens were rendered
        # with it active
        import liverrenderer as lr
        for k, v in list(d.items()):
            if isinstance(v, dict) and v.get("type") in ("constant",
                                                         "envmap"):
                del d[k]
        d["env_restored"] = {
            "type": "envmap", "filename": "cavidade_latitude.exr",
            "scale": 2.5,
            "to_world": lr.Transform().translate([-3, 3, 4])
                        .rotate([0.57735, 0.57735, 0.57735], 180)}
    if "hide_emitters" in opts:
        d["integrator"]["hide_emitters"] = opts["hide_emitters"]
    if opts.get("substitute") == "soap":
        from .substitute import soap_mesh
        v, f, _ = soap_mesh()
        for k, val in list(d.items()):
            if isinstance(val, dict) and val.get("filename") == \
                    "soap_fine.obj":
                refs = {rk: rv for rk, rv in val.items()
                        if isinstance(rv, dict) and rv.get("type") == "ref"}
                d[k] = {"type": "mesh", "vertices": v, "faces": f, **refs}
    return load_dict(d, base_dir=os.path.dirname(os.path.abspath(path)))


def evaluate(scenes_dir="/root/reference/scenes", out_dir=".",
             downsample=4, spp=64, scenes=None, merge=False):
    from ..compile_cache import enable_compile_cache
    enable_compile_cache()
    import liverrenderer as lr
    from ..log import log
    from .results import rmse, ssim

    os.makedirs(out_dir, exist_ok=True)
    table = {}
    rpath = os.path.join(out_dir, "results.json")
    if merge and os.path.exists(rpath):
        with open(rpath) as f:
            table = json.load(f)
    for name, (xml, golden, mask, opts) in CONFIGS.items():
        if scenes and name not in scenes:
            continue
        try:
            _eval_one(scenes_dir, out_dir, downsample, spp, table, name,
                      xml, golden, mask, opts, lr, log, rmse, ssim)
        except Exception as e:             # noqa: BLE001 — a device
            # fault on one scene must not abort the batch
            log(f"{name}: FAILED ({type(e).__name__}: {e})")
            table[name] = {"error": _clean_error(e)}
        with open(rpath, "w") as f:
            json.dump(table, f, indent=2)
    return table


def _eval_one(scenes_dir, out_dir, downsample, spp, table, name, xml,
              golden, mask, opts, lr, log, rmse, ssim):
    if True:
        gpath = os.path.join(scenes_dir, golden)
        if not os.path.exists(gpath):
            log(f"{name}: golden missing, skipped")
            return
        is_ldr = gpath.lower().endswith(".png")
        # PNG goldens stay display-encoded; ours gets the same transfer
        g = lr.read_image(gpath, srgb_to_linear=False)[..., :3]
        # crop to a downsample multiple (e.g. 540-row goldens at ds=8)
        gh = g.shape[0] - g.shape[0] % downsample
        gw = g.shape[1] - g.shape[1] % downsample
        g = g[:gh, :gw]
        h, w = gh // downsample, gw // downsample
        gd = g.reshape(h, downsample, w, downsample, 3).mean((1, 3))
        scene = _load_scene(os.path.join(scenes_dir, xml), opts, w, h, spp)
        t0 = time.time()
        img_lin = np.asarray(lr.render(scene, spp=spp, seed=0))
        dt = time.time() - t0
        if is_ldr:
            from ..tonemap import tonemap
            img = tonemap(img_lin)
        else:
            img = img_lin
        m = None
        if mask and os.path.exists(os.path.join(scenes_dir, mask)):
            marr = lr.read_image(os.path.join(scenes_dir, mask))[..., 0]
            mh = marr.shape[0] // h
            m = marr.reshape(h, mh, w, marr.shape[1] // w).mean((1, 3)) > 0.5
        a, b = np.clip(img, 0, 1), np.clip(gd, 0, 1)
        entry = {
            "rmse": rmse(a, b), "ssim": ssim(a, b),
            "render_s": round(dt, 2),
            "paths_per_s": round(w * h * spp / dt),
        }
        if m is not None:
            entry["rmse_masked"] = rmse(a, b, m)
            entry["ssim_masked"] = ssim(a, b, m)
        if opts.get("sss_report"):
            # substitute-geometry row: split the comparison into (1) the
            # background, where both images are pure envmap and should
            # agree exactly, and (2) the object interiors, whose mean
            # radiance isolates the VAE-SSS absorption from the
            # unmatchable silhouette.  The golden's object reads as its
            # dark region; OURS is taken geometrically (camera-ray hits
            # on the subsurface shape) — our render is legitimately
            # bright (golden-object staleness, see header note), so a
            # luminance mask would miss it entirely.
            lum_r = b @ np.array([0.2126, 0.7152, 0.0722])
            obj_r = lum_r < 0.02
            obj_o = _subsurface_silhouette(scene)

            def dilate(msk):
                from numpy.lib.stride_tricks import sliding_window_view
                p = np.pad(msk, 2)
                return sliding_window_view(p, (5, 5)).any((-1, -2))

            bg = ~(dilate(obj_r) | dilate(obj_o))
            inter = obj_r & obj_o
            entry["substitute_mesh"] = True
            entry["silhouette_iou"] = round(
                float((obj_r & obj_o).sum() / max((obj_r | obj_o).sum(),
                                                  1)), 4)
            entry["rmse_background"] = rmse(a, b, bg)
            entry["ssim_background"] = ssim(a, b, bg)
            if inter.any():
                entry["obj_mean_ours"] = [round(float(x), 5)
                                          for x in a[inter].mean(0)]
                entry["obj_mean_ref"] = [round(float(x), 5)
                                         for x in b[inter].mean(0)]
        if opts.get("denoise_probe"):
            from ..denoise import denoise_render
            spp_lo = int(opts["denoise_probe"])
            img_lo = np.asarray(lr.render(scene, spp=spp_lo, seed=1))
            img_dn = denoise_render(scene, spp=spp_lo, seed=1)
            if is_ldr:
                from ..tonemap import tonemap
                img_lo, img_dn = tonemap(img_lo), tonemap(img_dn)
            lo = np.clip(np.asarray(img_lo), 0, 1)
            dn = np.clip(np.asarray(img_dn), 0, 1)
            entry["denoise"] = {
                "spp": spp_lo,
                "noisy_rmse": rmse(lo, b), "noisy_ssim": ssim(lo, b),
                "denoised_rmse": rmse(dn, b), "denoised_ssim": ssim(dn, b),
            }
        table[name] = entry
        # write_image expects LINEAR data for PNGs (applies sRGB itself)
        if is_ldr:
            from PIL import Image
            Image.fromarray((a * 255 + 0.5).astype(np.uint8)).save(
                os.path.join(out_dir, f"{name.lower()}_ours.png"))
            Image.fromarray((b * 255 + 0.5).astype(np.uint8)).save(
                os.path.join(out_dir, f"{name.lower()}_ref.png"))
        else:
            lr.write_image(
                os.path.join(out_dir, f"{name.lower()}_ours.png"), img)
            lr.write_image(
                os.path.join(out_dir, f"{name.lower()}_ref.png"), gd)
        log(f"{name}: rmse {entry['rmse']:.4f} ssim {entry['ssim']:.4f} "
            f"({dt:.1f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes-dir", default="/root/reference/scenes")
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--downsample", type=int, default=4)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--scenes", default=None,
                    help="comma-separated subset of CONFIGS keys")
    ap.add_argument("--merge", action="store_true",
                    help="update rows in the existing results.json")
    a = ap.parse_args(argv)
    scenes = a.scenes.split(",") if a.scenes else None
    print(json.dumps(evaluate(a.scenes_dir, a.out_dir, a.downsample,
                              a.spp, scenes=scenes, merge=a.merge),
                     indent=2))


if __name__ == "__main__":
    main()
