"""Stream/filesystem layer (io/stream.py): typed IO, zlib streaming,
memory mapping, file resolution — and the serialized-mesh path through it.
"""
import os
import zlib

import numpy as np

from liverrenderer.io.stream import (FileResolver, FileStream,
                                         MemoryMappedFile, MemoryStream,
                                         Stream, ZStream)


def test_memory_stream_typed_roundtrip():
    ms = MemoryStream()
    ms.write_value("u4", 0x041C)
    ms.write_value("f4", 2.5)
    ms.write(b"name\0")
    ms.write_value("u8", 123456789)
    ms.seek(0)
    assert ms.read_value("u4") == 0x041C
    assert abs(ms.read_value("f4") - 2.5) < 1e-7
    assert ms.read_string() == "name"
    assert ms.read_value("u8") == 123456789
    assert ms.size() == 4 + 4 + 5 + 8


def test_file_stream_and_mmap(tmp_path):
    p = str(tmp_path / "blob.bin")
    arr = np.arange(1000, dtype="<f4")
    with FileStream(p, "wb") as fs:
        fs.write_value("u4", 7)
        fs.write(arr.tobytes())
    with FileStream(p) as fs:
        assert fs.size() == 4 + 4000
        assert fs.read_value("u4") == 7
        got = fs.read_array("f4", 1000)
        np.testing.assert_array_equal(got, arr)
    with MemoryMappedFile(p) as mf:
        assert mf.size() == 4 + 4000
        # zero-copy view usable by frombuffer at an offset
        view = np.frombuffer(mf.data(), "<f4", 1000, 4)
        np.testing.assert_array_equal(view, arr)
        mf.seek(4)
        np.testing.assert_array_equal(mf.read_array("f4", 10), arr[:10])


def test_zstream_read_write_roundtrip(tmp_path):
    payload = os.urandom(1000) + b"\0" * 100000   # compressible tail
    p = str(tmp_path / "z.bin")
    with FileStream(p, "wb") as fs:
        zs = ZStream(fs, "w")
        zs.write(payload[:512])
        zs.write(payload[512:])
        zs.close()
    assert os.path.getsize(p) < len(payload)      # actually deflated
    with FileStream(p) as fs:
        zs = ZStream(fs, "r")
        # chunked reads + forward seek (skip) semantics
        head = zs.read(256)
        zs.seek(512)
        tail = zs.read(len(payload) - 512)
        assert head == payload[:256]
        assert tail == payload[512:]


def test_zstream_matches_zlib_one_shot():
    blob = zlib.compress(b"abc" * 50000)
    zs = ZStream(MemoryStream(blob), "r")
    assert zs.read(150000) == b"abc" * 50000


def test_file_resolver(tmp_path):
    sub = tmp_path / "a"
    sub.mkdir()
    (sub / "x.obj").write_text("o")
    r = FileResolver([str(tmp_path)])
    assert r.resolve("missing.obj") == "missing.obj"
    r.append(str(sub))
    assert r.resolve("x.obj") == str(sub / "x.obj")
    r.prepend(str(tmp_path))
    assert r.paths[0] == str(tmp_path)


def test_serialized_mesh_through_streams(tmp_path):
    """Write a 2-mesh v4 serialized container and read shape 1 back
    through the mmap+ZStream path (serialized.cpp container layout)."""
    from liverrenderer.scene.meshio import load_mesh

    def mesh_blob(name, verts, faces, uvs=None):
        ms = MemoryStream()
        ms.write_value("u2", 0x041C)
        ms.write_value("u2", 4)
        zs = ZStream(ms, "w")
        flags = 0x0002 if uvs is not None else 0
        zs.write_value("u4", flags)
        zs.write(name.encode() + b"\0")
        zs.write_value("u8", len(verts))
        zs.write_value("u8", len(faces))
        zs.write(np.asarray(verts, "<f4").tobytes())
        if uvs is not None:
            zs.write(np.asarray(uvs, "<f4").tobytes())
        zs.write(np.asarray(faces, "<u4").tobytes())
        zs.close()
        return ms.getvalue()

    v0 = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    v1 = [[0, 0, 1], [2, 0, 1], [0, 2, 1], [2, 2, 1]]
    f0 = [[0, 1, 2]]
    f1 = [[0, 1, 2], [1, 3, 2]]
    uv1 = [[0, 0], [1, 0], [0, 1], [1, 1]]
    b0 = mesh_blob("m0", v0, f0)
    b1 = mesh_blob("m1", v1, f1, uv1)
    out = MemoryStream()
    out.write(b0)
    off1 = out.tell()
    out.write(b1)
    out.write_value("u8", 0)
    out.write_value("u8", off1)
    out.write_value("u4", 2)
    p = str(tmp_path / "two.serialized")
    with open(p, "wb") as f:
        f.write(out.getvalue())

    m = load_mesh(p, shape_index=1)
    np.testing.assert_allclose(m.vertices, np.asarray(v1, np.float32))
    np.testing.assert_array_equal(m.faces, np.asarray(f1, np.int32))
    assert m.uvs is not None and m.uvs.shape == (4, 2)
    m0 = load_mesh(p, shape_index=0)
    assert m0.vertices.shape == (3, 3)
