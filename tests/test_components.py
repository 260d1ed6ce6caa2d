"""Component-breadth tests: samplers, rfilters, sensors, spectra, aux
integrators (reference src/{samplers,rfilters,sensors,spectra}/tests and
integrator interface tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer as lr
from liverrenderer.core import rng


# ---------------------------- samplers ------------------------------------

@pytest.mark.parametrize("kind", ["independent", "stratified", "multijitter",
                                  "ldsampler"])
def test_sampler_range_and_mean(kind):
    spp = 16
    n_pix = 512
    lane = jnp.repeat(jnp.arange(n_pix, dtype=jnp.uint32), spp)
    samp = jnp.tile(jnp.arange(spp, dtype=jnp.uint32), n_pix)
    s = rng.make_sampler(lane, samp, 3, kind=kind, spp=spp)
    u1, s = s.next_1d()
    u2, s = s.next_2d()
    for u in (np.asarray(u1), np.asarray(u2).ravel()):
        assert (u >= 0).all() and (u < 1).all()
        np.testing.assert_allclose(u.mean(), 0.5, atol=0.01)


def test_stratified_lower_variance():
    """Per-pixel mean of spp samples: stratified must beat independent."""
    spp = 16
    n_pix = 2048
    lane = jnp.repeat(jnp.arange(n_pix, dtype=jnp.uint32), spp)
    samp = jnp.tile(jnp.arange(spp, dtype=jnp.uint32), n_pix)

    def pixel_mean_var(kind):
        s = rng.make_sampler(lane, samp, 1, kind=kind, spp=spp)
        u, _ = s.next_1d()
        pm = np.asarray(u).reshape(n_pix, spp).mean(1)
        return pm.var()

    v_ind = pixel_mean_var("independent")
    v_str = pixel_mean_var("stratified")
    v_ld = pixel_mean_var("ldsampler")
    assert v_str < v_ind / 4
    assert v_ld < v_ind / 4


def test_stratified_covers_strata():
    spp = 8
    lane = jnp.zeros(spp, jnp.uint32)
    samp = jnp.arange(spp, dtype=jnp.uint32)
    s = rng.make_sampler(lane, samp, 0, kind="stratified", spp=spp)
    u, _ = s.next_1d()
    strata = np.sort((np.asarray(u) * spp).astype(int))
    np.testing.assert_array_equal(strata, np.arange(spp))


# ---------------------------- rfilters ------------------------------------

@pytest.mark.parametrize("rf", ["box", "tent", "gaussian", "mitchell",
                                "catmullrom", "lanczos"])
def test_rfilter_renders(rf):
    d = lr.cornell_box()
    d["sensor"]["film"]["width"] = 32
    d["sensor"]["film"]["height"] = 32
    d["sensor"]["film"]["rfilter"] = {"type": rf}
    scene = lr.load_dict(d)
    img = np.asarray(lr.render(scene, spp=4, seed=0))
    assert np.isfinite(img).all()
    assert img.mean() > 0.05


# ---------------------------- sensors -------------------------------------

def test_thinlens_blurs_defocused():
    def make(ap):
        d = lr.cornell_box()
        d["sensor"]["type"] = "thinlens"
        d["sensor"]["aperture_radius"] = ap
        d["sensor"]["focus_distance"] = 1.0   # box is ~4 away: defocused
        d["sensor"]["film"]["width"] = 48
        d["sensor"]["film"]["height"] = 48
        return lr.load_dict(d)

    sharp = np.asarray(lr.render(make(0.0), spp=16, seed=0))
    blurred = np.asarray(lr.render(make(0.3), spp=16, seed=0))
    # defocus spreads the bright lamp across many pixels: the brightest
    # smoothed 3x3 neighborhood must drop substantially
    def peak(img):
        y = img.mean(-1)
        k = (y[:-2, :-2] + y[1:-1, :-2] + y[2:, :-2] + y[:-2, 1:-1]
             + y[1:-1, 1:-1] + y[2:, 1:-1] + y[:-2, 2:] + y[1:-1, 2:]
             + y[2:, 2:]) / 9.0
        return k.max()
    assert peak(blurred) < peak(sharp) * 0.6
    assert np.isfinite(blurred).all()


def test_orthographic_renders():
    d = lr.cornell_box()
    d["sensor"]["type"] = "orthographic"
    d["sensor"]["film"]["width"] = 32
    d["sensor"]["film"]["height"] = 32
    scene = lr.load_dict(d)
    img = np.asarray(lr.render(scene, spp=4, seed=0))
    assert np.isfinite(img).all()


# ---------------------------- spectra -------------------------------------

def test_blackbody_hue():
    from liverrenderer.core.spectrum import blackbody_rgb
    warm = blackbody_rgb(2000.0)
    cool = blackbody_rgb(10000.0)
    assert warm[0] > warm[2] * 2          # 2000 K is strongly red
    assert cool[2] > cool[0]              # 10000 K is blue-ish


def test_flat_spd_is_whiteish():
    from liverrenderer.core.spectrum import spd_to_rgb
    rgb = spd_to_rgb(np.linspace(380, 730, 10), np.ones(10))
    assert rgb.max() / max(rgb.min(), 1e-6) < 1.6


# ---------------------------- aux integrators ------------------------------

def _tiny_cornell():
    d = lr.cornell_box()
    d["sensor"]["film"]["width"] = 48
    d["sensor"]["film"]["height"] = 48
    return lr.load_dict(d)


def test_depth_and_aovs():
    scene = _tiny_cornell()
    dep = np.asarray(lr.render_depth(scene))
    assert (dep[24, 24] > 0.5) and np.isfinite(dep).all()
    aovs = lr.render_aovs(scene)
    n = np.asarray(aovs["sh_normal"])
    assert np.abs(np.linalg.norm(n[24, 24]) - 1.0) < 1e-3


def test_ptracer_matches_path():
    """Light tracer and path tracer estimate the same measurement
    (AdjointIntegrator::render vs SamplingIntegrator::render)."""
    scene = _tiny_cornell()
    pt = np.asarray(lr.render_ptracer(scene, spp=64, seed=0))
    fw = np.asarray(lr.render(scene.replace(hide_emitters=True), spp=32,
                              seed=0))
    assert abs(pt.mean() - fw.mean()) / fw.mean() < 0.05


def test_moments_variance_positive():
    scene = _tiny_cornell()
    mean, m2 = lr.render_moments(scene, spp=4)
    var = np.asarray(m2) - np.asarray(mean) ** 2
    assert var.mean() > -1e-4


def test_serialized_mesh_roundtrip(tmp_path):
    """Mitsuba .serialized container loader (src/shapes/serialized.cpp)."""
    import struct
    import zlib

    from liverrenderer.scene.meshio import load_mesh

    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [2, 1, 3]], np.uint32)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uvs = verts[:, :2].astype(np.float32)

    payload = struct.pack("<I", 0x0001 | 0x0002 | 0x1000)  # normals+uv+f32
    payload += b"quad\0"
    payload += struct.pack("<QQ", 4, 2)
    payload += verts.tobytes() + normals.tobytes() + uvs.tobytes()
    payload += faces.astype("<u4").tobytes()

    blob = struct.pack("<HH", 0x041C, 4) + zlib.compress(payload)
    blob += struct.pack("<Q", 0)          # offset of mesh 0
    blob += struct.pack("<I", 1)          # mesh count
    path = tmp_path / "quad.serialized"
    path.write_bytes(blob)

    mesh = load_mesh(str(path))
    np.testing.assert_allclose(mesh.vertices, verts)
    np.testing.assert_array_equal(mesh.faces, faces.astype(np.int32))
    np.testing.assert_allclose(mesh.normals, normals)
    np.testing.assert_allclose(mesh.uvs, uvs)


def test_merge_shape_container():
    """merge shape: children flattened into the scene (merge.cpp)."""
    import numpy as np

    import liverrenderer as lr
    scene = lr.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0],
                                                      [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}}},
        "group": {"type": "merge",
                  "a": {"type": "rectangle",
                        "to_world": lr.Transform().translate([-1.2, 0, 0])
                        .scale(0.5)},
                  "b": {"type": "rectangle",
                        "to_world": lr.Transform().translate([1.2, 0, 0])
                        .scale(0.5)}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    })
    assert scene.n_shapes == 2
    img = np.asarray(lr.render(scene, spp=8, seed=0))
    assert np.isfinite(img).all()


def test_bump_and_normal_map_perturb_shading():
    """bumpmap/normalmap wrappers perturb the frame (bumpmap.cpp,
    normalmap.cpp) — including when attached via a named ref."""
    import numpy as np

    import liverrenderer as lr

    h = np.zeros((16, 16), np.float32)
    h[::2, :] = 1.0                       # strong horizontal stripes

    def scene(bsdf):
        return lr.load_dict({
            "type": "scene",
            "integrator": {"type": "path", "max_depth": 2},
            "sensor": {"type": "perspective", "fov": 40.0,
                       "to_world": lr.Transform().look_at(
                           [0, 1.5, 2.5], [0, 0, 0], [0, 1, 0]),
                       "film": {"type": "hdrfilm", "width": 16,
                                "height": 16,
                                "rfilter": {"type": "box"}}},
            "named_mat": {**bsdf, "id": "mat"},
            "floor": {"type": "rectangle",
                      "to_world": lr.Transform().rotate([1, 0, 0], -90),
                      "bsdf": {"type": "ref", "id": "mat"}},
            "sun": {"type": "directional", "direction": [0.5, -1, -0.2],
                    "irradiance": {"type": "rgb", "value": [3.0] * 3}},
        })

    flat = scene({"type": "diffuse"})
    bumpy = scene({"type": "bumpmap", "scale": 0.4,
                   "texture": {"type": "bitmap", "data": h},
                   "bsdf": {"type": "diffuse"}})
    assert bumpy.has_bump and bumpy.has_heightmap
    img_f = np.asarray(lr.render(flat, spp=16, seed=0))
    img_b = np.asarray(lr.render(bumpy, spp=16, seed=0))
    assert np.isfinite(img_b).all()
    # stripes modulate the shading across rows
    assert np.abs(img_b - img_f).max() > 0.05


def test_mesh_attribute_texture():
    """Per-vertex attribute texture (mesh_attribute.cpp): vertex colors
    interpolate across the face."""
    import numpy as np

    import liverrenderer as lr
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    col = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    scene = lr.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 50.0,
                   "to_world": lr.Transform().look_at([0, 0, 2.5], [0, 0, 0],
                                                      [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16,
                            "rfilter": {"type": "box"}}},
        "quad": {"type": "mesh", "vertices": v, "faces": f,
                 "vertex_attrs": col,
                 "bsdf": {"type": "diffuse",
                          "reflectance": {"type": "mesh_attribute",
                                          "name": "vertex_color"}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    })
    assert scene.has_vertex_attr
    img = np.asarray(lr.render(scene, spp=16, seed=0))
    # world bottom-left (red) renders at the bottom rows
    corner_r = img[13, 2]
    corner_g = img[13, 13]
    assert corner_r[0] > 2 * corner_r[2], corner_r
    assert corner_g[1] > 2 * corner_g[2], corner_g


def test_volume_texture():
    """3D grid texture sampled at the hit position (volume texture)."""
    import numpy as np

    import liverrenderer as lr
    g = np.zeros((2, 2, 2, 3), np.float32)
    g[..., 0] = 1.0            # red everywhere
    g[:, :, 1, 1] = 1.0        # +x half becomes yellow
    scene = lr.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 25.0,
                   "to_world": lr.Transform().look_at([0.5, 0.5, 3.0],
                                                      [0.5, 0.5, 0.0],
                                                      [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16,
                            "rfilter": {"type": "box"}}},
        "wall": {"type": "rectangle",
                 "to_world": lr.Transform().translate([0.5, 0.5, 0.0])
                 .scale(0.5),
                 "bsdf": {"type": "diffuse",
                          "reflectance": {"type": "volume", "data": g}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    })
    img = np.asarray(lr.render(scene, spp=16, seed=0))
    left = img[8, 4]
    right = img[8, 12]
    assert left[0] > 2 * left[1], left          # red half
    assert right[1] > 0.5 * right[0], right     # yellow half


def test_xml_matrix_comma_separators(tmp_path):
    """<matrix value> accepts comma and/or whitespace separators
    (parser.cpp tokenization; SphereLiverPoint/sss/scene.xml uses commas)."""
    import numpy as np

    import liverrenderer as lr
    xml = """<scene version="3.0.0">
      <integrator type="path"/>
      <sensor type="perspective">
        <float name="fov" value="45"/>
        <transform name="to_world">
          <matrix value="1, 0, 0, 0, 0, 1, 0, 0.5, 0, 0, 1, -3, 0, 0, 0, 1"/>
        </transform>
        <film type="hdrfilm">
          <integer name="width" value="4"/>
          <integer name="height" value="4"/>
        </film>
      </sensor>
      <emitter type="constant">
        <rgb name="radiance" value="1, 1, 1"/>
      </emitter>
    </scene>"""
    f = tmp_path / "s.xml"
    f.write_text(xml)
    scene = lr.load_file(str(f))
    tw = np.asarray(scene.sensor.to_world)
    assert abs(tw[1, 3] - 0.5) < 1e-6 and abs(tw[2, 3] + 3.0) < 1e-6


def test_device_trace_captures_profile(tmp_path):
    """log.device_trace wraps jax.profiler start/stop_trace and turns
    scoped_phase markers into TraceAnnotations on the device timeline
    (profiler.h ScopedPhase -> hardware-level xprof capture)."""
    import jax.numpy as jnp

    from liverrenderer.log import device_trace, scoped_phase

    out = str(tmp_path / "trace")
    with device_trace(out):
        with scoped_phase("test_phase"):
            jnp.dot(jnp.ones((64, 64)), jnp.ones((64, 64))).block_until_ready()
    import glob
    assert glob.glob(out + "/**/*.xplane.pb", recursive=True) or \
        glob.glob(out + "/**/*.trace.json*", recursive=True)


def _plane_light_scene(emitters):
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {
            "type": "perspective", "fov": 45,
            "to_world": lr.Transform().look_at([0, 0, 4], [0, 0, 0],
                                               [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 24, "height": 24,
                     "rfilter": {"type": "box"}},
        },
        "floor": {"type": "rectangle",
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb",
                                           "value": [0.6, 0.5, 0.4]}}},
    }
    d.update(emitters)
    return lr.load_dict(d)


@pytest.mark.parametrize("emitters", [
    {"env": {"type": "constant",
             "radiance": {"type": "rgb", "value": [0.8, 0.7, 0.9]}}},
    {"sun": {"type": "directional", "direction": [0.3, -0.2, -1.0],
             "irradiance": {"type": "rgb", "value": [2.0, 1.8, 1.5]}}},
])
def test_ptracer_infinite_emitters_match_path(emitters):
    """Light tracing from constant-env / directional emitters
    (bounding-sphere-disk endpoint sampling) agrees with the forward
    path tracer on the scattered light."""
    scene = _plane_light_scene(emitters)
    pt = np.asarray(lr.render_ptracer(scene, spp=256, seed=0))
    fw = np.asarray(lr.render(scene.replace(hide_emitters=True), spp=64,
                              seed=0))
    # compare where the plane projects (the env itself is not splatted)
    c_pt = pt[8:16, 8:16].mean()
    c_fw = fw[8:16, 8:16].mean()
    assert c_fw > 0.01
    assert abs(c_pt - c_fw) / c_fw < 0.08, (c_pt, c_fw)
