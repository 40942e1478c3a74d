"""The port's scanner formats and host codecs against the JAX package's,
on the same numpy inputs made from a seed: ``utils.config``, the native
text parser, ``io/{las,e57,velodyne,ply,png,meshio}``, the binary branch
of ``io.scandir.read_scan``, zipped directories and ragged text.

Bounds:
- writers: byte-identical files (LAS, E57 — the test of the port's
  page-vectorized CRC-32C —, PNG, OBJ and binary PLY meshes, the scans
  and poses of ``e57_to_scan``);
- readers and parsers: identical arrays (``np.testing.assert_array_equal``);
- the native parser also equals ``np.loadtxt`` on a regular table, builds
  into ``build/tpu3dtk_torch/`` (never next to its source) and raises
  with the compiler's output when its build fails;
- ``synth.velodyne_capture``: decoded points on the room's faces within
  0.3 cm (the 2 mm distance LSB bounds them by 0.1 cm).
"""

import os
import struct
import time
import zipfile

import numpy as np
import pytest
import torch

from tpu3dtk import native as jnative
from tpu3dtk.io import e57 as je57
from tpu3dtk.io import las as jlas
from tpu3dtk.io import meshio as jmeshio
from tpu3dtk.io import ply as jply
from tpu3dtk.io import png as jpng
from tpu3dtk.io import scandir as jscandir
from tpu3dtk.io import velodyne as jvelo
from tpu3dtk.utils import config as jconfig
from tpu3dtk_torch import native as tnative
from tpu3dtk_torch import synth
from tpu3dtk_torch.core import math3d
from tpu3dtk_torch.io import e57 as te57
from tpu3dtk_torch.io import las as tlas
from tpu3dtk_torch.io import meshio as tmeshio
from tpu3dtk_torch.io import ply as tply
from tpu3dtk_torch.io import png as tpng
from tpu3dtk_torch.io import scandir as tscandir
from tpu3dtk_torch.io import velodyne as tvelo
from tpu3dtk_torch.ops import cuda_build
from tpu3dtk_torch.utils import config as tconfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _write_pose(path, pos=(0.0, 0.0, 0.0), theta=(0.0, 0.0, 0.0)):
    with open(path, "w") as f:
        f.write(" ".join(map(str, pos)) + "\n" + " ".join(map(str, theta)) + "\n")


def _same_scans(a, b):
    assert [s.identifier for s in a] == [s.identifier for s in b]
    for sa, sb in zip(a, b):
        assert sorted(sa.channels) == sorted(sb.channels)
        for k in sa.channels:
            np.testing.assert_array_equal(sa.channels[k], sb.channels[k])
        np.testing.assert_array_equal(sa.pose_pos, sb.pose_pos)
        np.testing.assert_array_equal(sa.pose_theta, sb.pose_theta)


# ---- utils.config ----------------------------------------------------------

@pytest.mark.parametrize("spec", ["1:5,8,10:12", "0:20:5, 3", "-2:2", "7", " 4:4 ,, 9"])
def test_scan_ranges_match_jax(spec):
    assert tconfig.parse_scan_ranges(spec) == jconfig.parse_scan_ranges(spec)


def test_kv_config_matches_jax(tmp_path):
    import dataclasses

    @dataclasses.dataclass
    class Cfg:
        max_dist: float = 25.0
        iterations: int = 50
        use_frames: bool = False
        name: str = "uos"

    p = tmp_path / "c.ini"
    p.write_text("[section]\n# comment\n; comment\nMaxDist = 150\niterations 20\n"
                 "USE_FRAMES yes\nname city\nbogus 1\niterations_extra\nmax_dist_x 3\n")
    kv = tconfig.load_kv_file(str(p))
    assert kv == jconfig.load_kv_file(str(p))
    assert tconfig.apply_config(Cfg(), kv) == jconfig.apply_config(Cfg(), kv)
    assert tconfig.apply_config(Cfg(), kv) == Cfg(150.0, 20, True, "city")
    with pytest.raises(ValueError):
        tconfig.parse_scan_ranges("1:a")


# ---- the native parser -----------------------------------------------------

def test_native_parse_matches_numpy_and_jax(tmp_path):
    rng = np.random.default_rng(0)
    p = tmp_path / "t.3d"
    np.savetxt(p, rng.normal(0, 100, (500, 4)), fmt="%.10g")
    out = tnative.parse_table(str(p))
    np.testing.assert_array_equal(out, np.loadtxt(p))
    np.testing.assert_array_equal(out, jnative.parse_table(str(p)))


@pytest.mark.parametrize("text,skip", [
    ("# header comment\n1 2 3\n4 5 6\nbad line here\n7 8 9 10\n11 12 13\n", 0),
    ("81360\n1 2 3\n", 1),
    ("1 2 x 3\n4 5 6\n\n  \t7 8 9\r\n1e3 -2.5 nan\n", 0),
    ("", 0),
    ("# only a comment\n", 0),
])
def test_native_ragged_matches_jax(tmp_path, text, skip):
    p = tmp_path / "r.3d"
    p.write_text(text)
    out = tnative.parse_table(str(p), skip_lines=skip)
    ref = jnative.parse_table(str(p), skip_lines=skip)
    assert out.dtype == np.float64 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_native_builds_into_the_build_dir_and_raises_on_a_failed_build(monkeypatch, tmp_path):
    tnative.load()
    built = list(cuda_build.BUILD_DIR.glob("libfastscan-*.so"))
    assert built, "the parser is not in build/tpu3dtk_torch/"
    assert not list(cuda_build.CSRC_DIR.glob("*.so"))
    with pytest.raises(FileNotFoundError):
        tnative.parse_table(str(tmp_path / "missing.3d"))
    monkeypatch.setattr(cuda_build, "HOST_FLAGS", cuda_build.HOST_FLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*no-such-option"):
        cuda_build.load_host_library("fastscan_broken", ["fastscan.cpp"])


def test_ragged_scan_reads_through_the_native_parser(tmp_path):
    rng = np.random.default_rng(1)
    good = rng.uniform(-500, 500, (3000, 3))
    lines = [f"{x:.4f} {y:.4f} {z:.4f}" for x, y, z in good]
    keep = np.ones(len(lines), bool)
    for k in range(0, len(lines), 100):
        lines[k] = lines[k].rsplit(" ", 1)[0] if k % 200 else "junk here"
        keep[k] = False
    (tmp_path / "scan000.3d").write_text("\n".join(lines) + "\n")
    _write_pose(tmp_path / "scan000.pose")
    with pytest.raises(ValueError):
        np.loadtxt(tmp_path / "scan000.3d")
    t = tscandir.read_scan(str(tmp_path), "000", tscandir.get_format("uos"))
    j = jscandir.read_scan(str(tmp_path), "000", jscandir.get_format("uos"))
    _same_scans([t], [j])
    np.testing.assert_allclose(t.xyz, np.round(good[keep], 4), atol=1e-9)


# ---- LAS -------------------------------------------------------------------

@pytest.mark.parametrize("rgb", [False, True])
def test_las_writer_bytes_and_reader_match_jax(tmp_path, rgb):
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-5000, 5000, (2001, 3))
    inten = rng.integers(0, 65535, 2001)
    col = rng.integers(0, 255, (2001, 3)) if rgb else None
    tlas.write_las(str(tmp_path / "t.las"), xyz, inten, col)
    jlas.write_las(str(tmp_path / "j.las"), xyz, inten, col)
    assert _bytes(tmp_path / "t.las") == _bytes(tmp_path / "j.las")
    t = tlas.read_las(str(tmp_path / "j.las"))
    j = jlas.read_las(str(tmp_path / "j.las"))
    assert sorted(t) == sorted(j) == sorted(["xyz", "reflectance"] + (["rgb"] if rgb else []))
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_allclose(t["xyz"], xyz, atol=0.5e-3 + 1e-9)


def test_las_rejects_a_laz_payload_as_jax_does(tmp_path):
    tlas.write_las(str(tmp_path / "a.las"), np.zeros((4, 3)))
    raw = bytearray(_bytes(tmp_path / "a.las"))
    raw[104] |= 0x80
    (tmp_path / "a.laz").write_bytes(bytes(raw))
    for mod in (tlas, jlas):
        with pytest.raises(ValueError, match="LAZ-compressed"):
            mod.read_las(str(tmp_path / "a.laz"))


@pytest.mark.parametrize("fmt", ["las", "laz"])
def test_read_scan_las_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(3)
    for k in range(2):
        # .laz files of LAS 1.2 content read through the same reader
        name = f"scan{k:03d}.{fmt if k == 0 else 'las'}"
        tlas.write_las(str(tmp_path / name), rng.uniform(-50, 50, (700, 3)),
                       rng.integers(0, 1000, 700))
        _write_pose(tmp_path / f"scan{k:03d}.pose", (10.0 * k, 0, 0), (0, 5.0 * k, 0))
    t = list(tscandir.read_scan_dir(str(tmp_path), fmt))
    j = list(jscandir.read_scan_dir(str(tmp_path), fmt))
    assert len(t) == 2
    _same_scans(t, j)


# ---- E57 -------------------------------------------------------------------

@pytest.mark.parametrize("n,pose,inten", [(3001, True, True), (20000, False, False), (0, False, False),
                                          (1, True, False)])
def test_e57_writer_is_byte_identical_to_jax(tmp_path, n, pose, inten):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (n, 3))
    kw = {}
    if pose:
        kw = dict(translation=[1.0, 2.0, 3.0], quaternion=[0.9238795, 0.0, 0.3826834, 0.0])
    if inten:
        kw["intensity"] = rng.uniform(0, 1, n)
    te57.write_e57(str(tmp_path / "t.e57"), pts, **kw)
    je57.write_e57(str(tmp_path / "j.e57"), pts, **kw)
    assert _bytes(tmp_path / "t.e57") == _bytes(tmp_path / "j.e57")
    t = te57.read_e57(str(tmp_path / "j.e57"))
    j = je57.read_e57(str(tmp_path / "j.e57"))
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_array_equal(t["xyz"], pts)


@pytest.mark.parametrize("length", [0, 1, 7, 1020, 4093])
def test_crc32c_matches_jax(length):
    data = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    assert te57._crc32c(data) == je57._crc32c(data)
    rows = np.frombuffer(data * 3, np.uint8).reshape(3, length)
    assert te57._crc32c_rows(rows).tolist() == [je57._crc32c(data)] * 3


def test_e57_bitpack_decoder_matches_jax():
    """Odd widths go through the [count, width] uint64 bit matrix in both
    packages; its size and the decode time at this small size are
    printed (run with -s)."""
    rng = np.random.default_rng(5)
    for width in (1, 3, 8, 10, 16, 17, 24, 32, 33):
        vals = rng.integers(0, 2**width, 20001, dtype=np.uint64)
        bits = ((vals[:, None] >> np.arange(width, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)
        buf = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
        t0 = time.perf_counter()
        out = te57._decode_bitpack(buf, width, len(vals))
        ms = (time.perf_counter() - t0) * 1e3
        np.testing.assert_array_equal(out, vals)
        np.testing.assert_array_equal(out, je57._decode_bitpack(buf, width, len(vals)))
        if width % 8:
            print(f"_decode_bitpack {len(vals)} x {width} bits: bit matrix "
                  f"{len(vals) * width * 8 / 1e6:.2f} MB, {ms:.2f} ms on this host")


def _e57_integer_fields(path, fields, n):
    """An E57 file whose points are ScaledInteger / Integer fields (the
    layout of Faro/Leica exports), paged by the port's writer: one data
    packet holding each field's LSB-first bit-packed stream.  ``fields``:
    (name, xml attributes, values, minimum, width in bits)."""
    streams = []
    for _name, _attrs, vals, mn, width in fields:
        raw = (np.asarray(vals, np.int64) - mn).astype(np.uint64)
        bits = ((raw[:, None] >> np.arange(width, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)
        streams.append(np.packbits(bits.reshape(-1), bitorder="little").tobytes())
    body = struct.pack("<BBHH", 1, 0, 0, len(streams))
    body += struct.pack(f"<{len(streams)}H", *map(len, streams)) + b"".join(streams)
    body += b"\0" * ((-len(body)) % 4)
    body = body[:2] + struct.pack("<H", len(body) - 1) + body[4:]
    sec_len = 32 + len(body)

    def phys(lo):
        return lo + 4 * (lo // 1020)

    proto = "".join(f"<{name} {attrs}/>" for name, attrs, *_ in fields)
    xml = (
        f'<?xml version="1.0" encoding="UTF-8"?><e57Root type="Structure" xmlns="{te57.E57_NS}">'
        '<data3D type="Vector"><vectorChild type="Structure">'
        f'<points type="CompressedVector" fileOffset="{phys(48)}" recordCount="{n}">'
        f'<prototype type="Structure">{proto}</prototype></points>'
        "</vectorChild></data3D></e57Root>"
    ).encode()
    logical = struct.pack("<8sIIQQQQ", b"ASTM-E57", 1, 0, 0, phys(48 + sec_len), len(xml), 1024)
    logical += struct.pack("<B7xQQQ", 1, sec_len, phys(48 + 32), 0) + body + xml
    with open(path, "wb") as f:
        te57._paged_write(f, logical)


def test_e57_scaled_integer_fields_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    n, lo = 3000, -2**20
    cols = [rng.integers(lo, -lo, n) for _ in range(3)]
    inten = rng.integers(0, 2**11, n)
    scaled = f'type="ScaledInteger" minimum="{lo}" maximum="{-lo - 1}" scale="0.0001" offset="2.5"'
    fields = [(name, scaled, c, lo, 21) for name, c in zip(("cartesianX", "cartesianY", "cartesianZ"), cols)]
    fields.append(("intensity", 'type="Integer" minimum="0" maximum="2047"', inten, 0, 11))
    path = str(tmp_path / "s.e57")
    _e57_integer_fields(path, fields, n)
    t = te57.read_e57(path)
    j = je57.read_e57(path)
    assert sorted(t) == sorted(j) == ["reflectance", "xyz"]
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_allclose(t["xyz"], np.stack(cols, 1) * 1e-4 + 2.5, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(t["reflectance"], inten)


def test_e57_to_scan_and_read_scan_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-20, 20, (1500, 3))
    te57.write_e57(str(tmp_path / "city.e57"), pts, translation=[1.0, 0.25, 2.0])
    assert te57.e57_to_scan(str(tmp_path / "city.e57"), str(tmp_path / "t"), 4) == 1
    assert je57.e57_to_scan(str(tmp_path / "city.e57"), str(tmp_path / "j"), 4) == 1
    for name in ("scan004.3d", "scan004.pose"):
        assert _bytes(tmp_path / "t" / name) == _bytes(tmp_path / "j" / name)
    d = tmp_path / "dir"
    d.mkdir()
    for k in range(2):
        te57.write_e57(str(d / f"scan{k:03d}.e57"), pts + k, translation=[k, 0.0, 0.0])
        _write_pose(d / f"scan{k:03d}.pose", (0, 0, 100.0 * k))
    t = list(tscandir.read_scan_dir(str(d), "e57"))
    j = list(jscandir.read_scan_dir(str(d), "e57"))
    _same_scans(t, j)
    assert sorted(t[1].channels) == ["xyz"]  # the pose_* channels are dropped
    np.testing.assert_array_equal(t[1].xyz[:, 2], 100.0 * (pts[:, 0] + 1))


# ---- velodyne --------------------------------------------------------------

def _calibration_csv(path, rows=64):
    rng = np.random.default_rng(8)
    lines = ["vert,rot,dist,voff,hoff,en"]
    for i in range(rows):
        v = rng.uniform(-25, 3), rng.uniform(-3, 3), rng.uniform(-5, 5), rng.uniform(-10, 10)
        lines.append(f"{v[0]},{v[1]},{v[2]},{v[3]},{rng.uniform(-5, 5)},{int(i % 17 != 3)}")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("rows", [None, 64, 40])
def test_velodyne_decode_matches_jax(tmp_path, rows):
    T = np.asarray(math3d.euler_to_matrix4(np.array([30.0, 0.0, -20.0]), np.array([0.0, 0.3, 0.0])))
    cap = synth.velodyne_capture(T)
    cal_t = cal_j = None
    if rows:
        _calibration_csv(tmp_path / "calibration.txt", rows)
        cal_t = tvelo.read_calibration_csv(str(tmp_path / "calibration.txt"))
        cal_j = jvelo.read_calibration_csv(str(tmp_path / "calibration.txt"))
        np.testing.assert_array_equal(cal_t, cal_j)
    t = tvelo.decode_velodyne(cap, cal_t)
    j = jvelo.decode_velodyne(cap, cal_j)
    assert len(t["xyz"]) > (0 if rows else 100000)
    for k in ("xyz", "reflectance"):
        np.testing.assert_array_equal(t[k], j[k])
    (tmp_path / "scan000.bin").write_bytes(cap)
    _write_pose(tmp_path / "scan000.pose", (30.0, 0.0, -20.0), (0.0, 0.3, 0.0))
    _same_scans(list(tscandir.read_scan_dir(str(tmp_path), "velodyne")),
                list(jscandir.read_scan_dir(str(tmp_path), "velodyne")))


def test_velodyne_capture_lies_on_the_room_faces():
    caps, true_mats, odo_mats = synth.synth_velodyne(n_captures=3)
    assert len(caps) == 3 and len(caps[0]) == 360 * (tvelo.BLOCK_OFFSET + tvelo.BLOCK_SIZE)
    for cap, T in zip(caps, true_mats):
        out = tvelo.decode_velodyne(cap)
        assert len(out["xyz"]) == 360 * 12 * 32  # every return inside the gates
        w = np.asarray(math3d.transform3(T, out["xyz"]))
        face = np.minimum(np.abs(w - synth.VELO_ROOM_LO), np.abs(w - synth.VELO_ROOM_HI)).min(1)
        assert face.max() <= 0.3
    steps = np.linalg.norm(np.diff(true_mats[:, :3, 3], axis=0), axis=1)
    np.testing.assert_allclose(steps, 10.0)
    assert not np.allclose(true_mats[1:], odo_mats[1:])


def test_velodyne_gates_written_as_zero():
    """A sensor against a near wall: returns under 2.2 m are written as 0
    and the decoder drops them."""
    T = np.asarray(math3d.euler_to_matrix4(np.array([-600.0, 0.0, 0.0]), np.zeros(3)))
    cap = synth.velodyne_capture(T)
    raw = np.frombuffer(cap, np.uint8).reshape(360, -1)[:, tvelo.BLOCK_OFFSET:tvelo.BLOCK_OFFSET + 1200]
    dist = raw.reshape(360, 12, 100)[:, :, 4:].reshape(360, 12, 32, 3)
    d = dist[..., 0].astype(np.int64) | (dist[..., 1].astype(np.int64) << 8)
    assert (d == 0).any() and ((d == 0) | (d * 0.002 > 2.2)).all()
    out = tvelo.decode_velodyne(cap)
    assert len(out["xyz"]) == int((d > 0).sum())


# ---- PLY, PNG, meshes --------------------------------------------------------

def _ply(path, fmt, rng, n=300):
    xyz = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    inten = rng.uniform(0, 1, n).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    head = (f"ply\nformat {fmt} 1.0\ncomment seeded\nelement vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "property float intensity\nproperty float nx\nproperty float ny\nproperty float nz\n"
            "element face 1\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        if fmt == "ascii":
            for k in range(n):
                f.write((" ".join(map(str, [*xyz[k], *rgb[k], inten[k], *nrm[k]])) + "\n").encode())
            f.write(b"3 0 1 2\n")
        else:
            rec = np.zeros(n, [("xyz", "<f4", 3), ("rgb", "u1", 3), ("i", "<f4"), ("n", "<f4", 3)])
            rec["xyz"], rec["rgb"], rec["i"], rec["n"] = xyz, rgb, inten, nrm
            f.write(rec.tobytes() + struct.pack("<Biii", 3, 0, 1, 2))


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_read_ply_matches_jax(tmp_path, fmt):
    _ply(tmp_path / "c.ply", fmt, np.random.default_rng(9))
    t = tply.read_ply(str(tmp_path / "c.ply"))
    j = jply.read_ply(str(tmp_path / "c.ply"))
    assert sorted(t) == sorted(j) == ["normal", "reflectance", "rgb", "xyz"]
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("shape", [(37, 53, 3), (20, 9)])
def test_png_matches_jax(tmp_path, shape):
    img = np.random.default_rng(10).integers(0, 256, shape).astype(np.uint8)
    tpng.write_png(str(tmp_path / "t.png"), img)
    jpng.write_png(str(tmp_path / "j.png"), img)
    assert _bytes(tmp_path / "t.png") == _bytes(tmp_path / "j.png")
    np.testing.assert_array_equal(tpng.read_png(str(tmp_path / "j.png")),
                                  jpng.read_png(str(tmp_path / "j.png")))


def test_meshes_match_jax(tmp_path):
    rng = np.random.default_rng(11)
    v = rng.uniform(-100, 100, (120, 3))
    f = rng.integers(0, 120, (200, 3))
    for name, (tw, jw) in {"obj": (tmeshio.write_obj, jmeshio.write_obj),
                           "ply": (tmeshio.write_ply_mesh, jmeshio.write_ply_mesh)}.items():
        tw(str(tmp_path / f"t.{name}"), v, f)
        jw(str(tmp_path / f"j.{name}"), v, f)
        assert _bytes(tmp_path / f"t.{name}") == _bytes(tmp_path / f"j.{name}")


# ---- zipped directories ------------------------------------------------------

@pytest.mark.parametrize("fmt", ["uos", "las", "velodyne"])
def test_zipped_directory_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(12)
    d = tmp_path / "plain"
    d.mkdir()
    for k in range(2):
        pts = rng.uniform(-300, 300, (400, 3))
        if fmt == "uos":
            np.savetxt(d / f"scan{k:03d}.3d", pts, fmt="%.6f")
        elif fmt == "las":
            tlas.write_las(str(d / f"scan{k:03d}.las"), pts, rng.integers(0, 100, 400))
        else:
            T = np.asarray(math3d.euler_to_matrix4(np.array([20.0 * k, 0, 0]), np.zeros(3)))
            (d / f"scan{k:03d}.bin").write_bytes(synth.velodyne_capture(T))
        _write_pose(d / f"scan{k:03d}.pose", (10.0 * k, 0, 0), (0, 45.0 * k, 0))
    if fmt == "velodyne":
        _calibration_csv(d / "calibration.txt")
    zpath = tmp_path / "scans.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for fn in os.listdir(d):
            z.write(d / fn, arcname=f"inner/{fn}")
    vdir = str(zpath) + "/inner"
    t = list(tscandir.read_scan_dir(vdir, fmt))
    assert len(t) == 2
    _same_scans(t, list(jscandir.read_scan_dir(vdir, fmt)))
    _same_scans(t, list(tscandir.read_scan_dir(str(d), fmt)))


def test_ragged_text_in_a_zip_raises_numpys_error(tmp_path):
    """The native parser wants a real path: inside a zip archive numpy's
    error stands, as in the JAX package."""
    d = tmp_path / "plain"
    d.mkdir()
    (d / "scan000.3d").write_text("1 2 3\njunk\n4 5 6\n")
    _write_pose(d / "scan000.pose")
    with zipfile.ZipFile(tmp_path / "s.zip", "w") as z:
        for fn in os.listdir(d):
            z.write(d / fn, arcname=fn)
    vdir = str(tmp_path / "s.zip")
    for mod in (tscandir, jscandir):
        with pytest.raises(ValueError):
            list(mod.read_scan_dir(vdir, "uos"))
    assert tscandir.read_scan(str(d), "000", tscandir.get_format("uos")).size == 2


def test_velodyne_point_to_point_stops_short_as_in_jax(tmp_path):
    """Point-to-point ICP between two HDL-64E captures of a bare room, one
    10 cm step apart, stops well short of the step in both packages: the
    floor's laser rings move with the sensor and each ring pairs with
    itself.  ``torchslam -f velodyne --device cpu`` against ``tpuslam -f
    velodyne`` at ``-r 20 -O 1``: each keeps one random point a voxel,
    drawn by its own generator (``-O 0`` would put the points on a voxel
    lattice that moves with the sensor too), so the two errors are held
    within 1 cm of each other, both above 3 cm of the 10 cm step; the
    port's ``--plane`` reaches the step within 0.5 cm.  The errors are
    printed (run with -s)."""
    import contextlib
    import io

    from tpu3dtk.cli import slam6d as jslam
    from tpu3dtk.io import frames as jframes
    from tpu3dtk_torch.cli import slam6d as tslam

    caps, true_mats, odo_mats = synth.synth_velodyne(n_captures=2)
    scan_dir = str(tmp_path / "scans")
    synth.write_velodyne_dir(scan_dir, caps, odo_mats)
    flags = ["-f", "velodyne", "-r", "20", "-O", "1", "-d", "50", "-i", "50", "--epsICP", "1e-6"]
    step = np.linalg.inv(true_mats[0]) @ true_mats[1]
    err = {}
    for name, mod, extra in (("jax", jslam, []), ("port", tslam, ["--device", "cpu"]),
                             ("port --plane", tslam, ["--device", "cpu", "--plane"])):
        out = tmp_path / name.replace(" ", "_")
        out.mkdir()
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod.main([scan_dir, *flags, *extra, "--frames-out", str(out)]) == 0
        T0, T1 = (jframes.final_pose(str(out / f"scan{k:03d}.frames")) for k in range(2))
        err[name] = float(np.linalg.norm((np.linalg.inv(T0) @ T1)[:3, 3] - step[:3, 3]))
    print(f"velodyne step error (cm): {err}")
    assert abs(err["jax"] - err["port"]) <= 1.0
    assert err["jax"] > 3.0 and err["port"] > 3.0
    assert err["port --plane"] < 0.5
