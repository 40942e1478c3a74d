"""ASTM E57 point-cloud reader/writer in pure numpy.

The reference reads E57 through the bundled libE57 (3rdparty/e57,
``src/slam6d/e572scan.cc``); this is a from-scratch implementation of
the subset 3D scans actually use:

- the paged physical file layout (1024-byte pages, each ending in a
  4-byte CRC-32C of the preceding 1020 payload bytes),
- the XML section describing /data3D/N/points as a CompressedVector
  with a prototype of Float / ScaledInteger / Integer elements,
- CompressedVector binary sections made of data packets, each carrying
  per-prototype-field bytestream buffers; a field's buffers concatenate
  across packets into one bit-packed stream,
- bit-packed integer decoding (LSB-first) and raw float/double streams,
- per-scan rigid pose (translation + unit quaternion) from the XML.

The writer emits double-precision Floats (bit width 64 = raw bytes), a
single bytestream buffer per packet, and correct CRC-32C page
checksums — enough for round-trip tests and interchange with readers
that follow the standard.

The port's copy of ``tpu3dtk.io.e57`` (numpy only).  One difference,
of speed alone: the CRC-32C of the pages is computed for all pages at
once, one table lookup per byte position across every page
(:func:`_crc32c_rows`), where the JAX package loops over every byte in
Python; the files are byte-identical.  As there, the reader does not
verify the checksums.
"""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET

import numpy as np

__all__ = ["read_e57", "write_e57", "E57_NS"]

E57_NS = "http://www.astm.org/COMMIT/E57/2010-e57-v1.0"
_PAGE = 1024
_PAYLOAD = _PAGE - 4


def _crc32c_table():
    poly = np.uint32(0x82F63B78)
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = (c >> np.uint32(1)) ^ np.where(c & np.uint32(1), poly, np.uint32(0))
    return c


_CRC_TABLE = _crc32c_table()


def _crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """CRC-32C of each row of a [n, L] uint8 array ([n] uint32): the
    byte-wise table recurrence, advanced one byte position at a time for
    all rows at once."""
    cols = np.ascontiguousarray(np.asarray(rows, np.uint8).T).astype(np.uint32)
    crc = np.full(cols.shape[1], 0xFFFFFFFF, np.uint32)
    t = _CRC_TABLE
    for byte in cols:
        crc = t[(crc ^ byte) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    return crc ^ np.uint32(0xFFFFFFFF)


def _crc32c(data: bytes) -> int:
    return int(_crc32c_rows(np.frombuffer(data, np.uint8)[None, :])[0])


def _logical_bytes(raw: bytes) -> bytes:
    """Strip the trailing 4-byte CRC of every 1024-byte page."""
    a = np.frombuffer(raw, np.uint8)
    n_pages = len(a) // _PAGE
    body = a[: n_pages * _PAGE].reshape(n_pages, _PAGE)[:, :_PAYLOAD]
    tail = a[n_pages * _PAGE:]
    if len(tail) > 4:
        tail = tail[:-4]
    return body.tobytes() + tail.tobytes()


def _phys_to_logical(off: int) -> int:
    return off - 4 * (off // _PAGE)


def _tag(el):
    t = el.tag
    return t.split("}", 1)[1] if "}" in t else t


def _find(el, name):
    for c in el:
        if _tag(c) == name:
            return c
    return None


def _decode_bitpack(buf: bytes, width: int, count: int) -> np.ndarray:
    """LSB-first bit-packed unsigned integers."""
    if width % 8 == 0:
        nbytes = width // 8
        a = np.frombuffer(buf[: count * nbytes], np.uint8).reshape(
            count, nbytes
        ).astype(np.uint64)
        shifts = (8 * np.arange(nbytes, dtype=np.uint64))[None, :]
        return (a << shifts).sum(axis=1, dtype=np.uint64)
    bits = np.unpackbits(
        np.frombuffer(buf, np.uint8), bitorder="little"
    )
    need = count * width
    bits = bits[:need].reshape(count, width).astype(np.uint64)
    weights = (np.uint64(1) << np.arange(width, dtype=np.uint64))[None, :]
    return (bits * weights).sum(axis=1, dtype=np.uint64)


def _proto_fields(proto):
    """(name, kind, params) per prototype child, in order."""
    fields = []
    for el in proto:
        name = _tag(el)
        typ = el.get("type")
        if typ == "Float":
            prec = el.get("precision", "double")
            fields.append((name, "float", {"single": prec == "single"}))
        elif typ == "ScaledInteger":
            mn = int(el.get("minimum", "0"))
            mx = int(el.get("maximum", "0"))
            sc = float(el.get("scale", "1"))
            offs = float(el.get("offset", "0"))
            width = max((mx - mn).bit_length(), 1)
            fields.append(
                (name, "scaled", {
                    "min": mn, "width": width, "scale": sc, "offset": offs,
                })
            )
        elif typ == "Integer":
            mn = int(el.get("minimum", "0"))
            mx = int(el.get("maximum", "0"))
            width = max((mx - mn).bit_length(), 1)
            fields.append((name, "int", {"min": mn, "width": width}))
        else:
            raise ValueError(f"unsupported e57 prototype type {typ!r}")
    return fields


def _read_vector(logical: bytes, phys_offset: int, count: int, fields):
    """Decode a CompressedVector's binary section into per-field arrays."""
    lo = _phys_to_logical(phys_offset)
    # CompressedVectorSectionHeader: id(1) reserved(7) sectionLogicalLength(8)
    # dataPhysicalOffset(8) indexPhysicalOffset(8)
    sec_id = logical[lo]
    if sec_id != 1:
        raise ValueError(f"not a CompressedVector section (id {sec_id})")
    sec_len, data_phys, _index_phys = struct.unpack_from(
        "<QQQ", logical, lo + 8
    )
    pos = _phys_to_logical(data_phys)
    end = lo + sec_len
    streams: list[list[bytes]] = [[] for _ in fields]
    while pos < end:
        ptype = logical[pos]
        if ptype == 1:  # data packet
            (pk_len_m1,) = struct.unpack_from("<H", logical, pos + 2)
            (n_streams,) = struct.unpack_from("<H", logical, pos + 4)
            counts = struct.unpack_from(f"<{n_streams}H", logical, pos + 6)
            p = pos + 6 + 2 * n_streams
            for k in range(n_streams):
                streams[k].append(logical[p: p + counts[k]])
                p += counts[k]
            pos += pk_len_m1 + 1
        elif ptype == 0:  # index packet: skip
            (pk_len_m1,) = struct.unpack_from("<H", logical, pos + 2)
            pos += pk_len_m1 + 1
        elif ptype == 2:  # empty packet
            (pk_len_m1,) = struct.unpack_from("<H", logical, pos + 2)
            pos += pk_len_m1 + 1
        else:
            break
    out = {}
    for (name, kind, par), bufs in zip(fields, streams):
        buf = b"".join(bufs)
        if kind == "float":
            dt = "<f4" if par["single"] else "<f8"
            out[name] = np.frombuffer(
                buf, dt, count=count
            ).astype(np.float64)
        elif kind == "scaled":
            raw = _decode_bitpack(buf, par["width"], count)
            out[name] = (
                raw.astype(np.float64) + par["min"]
            ) * par["scale"] + par["offset"]
        else:
            raw = _decode_bitpack(buf, par["width"], count)
            out[name] = raw.astype(np.int64) + par["min"]
    return out


def read_e57(path: str, scan_index: int = 0) -> dict:
    """Read one Data3D scan from an E57 file.

    Returns channels: "xyz" [N,3] f64 (file units, right-handed),
    optional "reflectance"/"rgb", plus "pose_translation" [3] and
    "pose_quaternion" [4] (w, x, y, z) when present."""
    raw = open(path, "rb").read()
    if raw[:8] != b"ASTM-E57":
        raise ValueError(f"{path}: not an E57 file")
    (xml_phys, xml_len) = struct.unpack_from("<QQ", raw, 24)
    logical = _logical_bytes(raw)
    xoff = _phys_to_logical(xml_phys)
    xml = logical[xoff: xoff + xml_len]
    root = ET.fromstring(xml.decode("utf-8"))
    d3 = _find(root, "data3D")
    if d3 is None:
        raise ValueError(f"{path}: no data3D section")
    scans = list(d3)
    if scan_index >= len(scans):
        raise IndexError(f"{path}: scan {scan_index} of {len(scans)}")
    scan = scans[scan_index]
    points = _find(scan, "points")
    count = int(points.get("recordCount"))
    phys = int(points.get("fileOffset"))
    proto = _find(points, "prototype")
    fields = _proto_fields(proto)
    cols = _read_vector(logical, phys, count, fields)
    out = {}
    out["xyz"] = np.stack(
        [cols["cartesianX"], cols["cartesianY"], cols["cartesianZ"]],
        axis=1,
    )
    if "intensity" in cols:
        out["reflectance"] = cols["intensity"]
    if "colorRed" in cols:
        out["rgb"] = np.stack(
            [cols["colorRed"], cols["colorGreen"], cols["colorBlue"]],
            axis=1,
        ).astype(np.float64)
    pose = _find(scan, "pose")
    if pose is not None:
        tr = _find(pose, "translation")
        rot = _find(pose, "rotation")
        if tr is not None:
            out["pose_translation"] = np.array(
                [float(_find(tr, k).text) for k in ("x", "y", "z")]
            )
        if rot is not None:
            out["pose_quaternion"] = np.array(
                [float(_find(rot, k).text) for k in ("w", "x", "y", "z")]
            )
    return out


def _paged_write(f, logical: bytes):
    """Write a logical byte stream as CRC-32C checksummed pages (the last
    page's payload padded with zeros)."""
    n_pages = -(-len(logical) // _PAYLOAD)
    pages = np.zeros((n_pages, _PAGE), np.uint8)
    body = np.zeros(n_pages * _PAYLOAD, np.uint8)
    body[: len(logical)] = np.frombuffer(logical, np.uint8)
    pages[:, :_PAYLOAD] = body.reshape(n_pages, _PAYLOAD)
    crc = _crc32c_rows(pages[:, :_PAYLOAD]).astype("<u4")
    pages[:, _PAYLOAD:] = crc.view(np.uint8).reshape(n_pages, 4)
    f.write(pages.tobytes())


def write_e57(path: str, points: np.ndarray, *,
              translation=None, quaternion=None,
              intensity=None) -> None:
    """Write a minimal single-scan E57 file (double-precision floats)."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    cols = [("cartesianX", pts[:, 0]), ("cartesianY", pts[:, 1]),
            ("cartesianZ", pts[:, 2])]
    if intensity is not None:
        cols.append(("intensity", np.asarray(intensity, np.float64)))

    # ---- binary section (logical layout) -------------------------------
    # one data packet per <= 64 KiB of payload
    per_val = 8
    vals_per_packet = max(1, (60000 // per_val) // len(cols))
    packets = []
    a = 0
    while a < n or (n == 0 and not packets):
        b = min(n, a + vals_per_packet)
        bufs = [c[1][a:b].astype("<f8").tobytes() for c in cols]
        head = struct.pack("<BBHH", 1, 0, 0, len(bufs))
        counts = struct.pack(f"<{len(bufs)}H", *[len(x) for x in bufs])
        body = head + counts + b"".join(bufs)
        body += b"\0" * ((-len(body)) % 4)  # packets end 4-byte aligned
        body = (
            body[:2] + struct.pack("<H", len(body) - 1) + body[4:]
        )
        packets.append(body)
        a = b
        if n == 0:
            break
    pk = b"".join(packets)
    sec_header_len = 32
    sec_len = sec_header_len + len(pk)

    # physical layout: file header page-aligned at 0, binary section at
    # logical offset 48 (right after the 48-byte header)
    header_len = 48
    bin_logical_off = header_len
    data_logical_off = bin_logical_off + sec_header_len

    def logical_to_phys(lo):
        return lo + 4 * (lo // _PAYLOAD)

    sec = struct.pack(
        "<B7xQQQ", 1, sec_len,
        logical_to_phys(data_logical_off), 0,
    )
    xml_logical_off = bin_logical_off + sec_len

    proto = "".join(
        f'<{name} type="Float" precision="double"/>' for name, _ in cols
    )
    pose_xml = ""
    if translation is not None or quaternion is not None:
        t = np.asarray(
            translation if translation is not None else [0, 0, 0],
            np.float64,
        )
        q = np.asarray(
            quaternion if quaternion is not None else [1, 0, 0, 0],
            np.float64,
        )
        pose_xml = (
            '<pose type="Structure">'
            '<rotation type="Structure">'
            + "".join(
                f'<{k} type="Float">{float(v)!r}</{k}>'
                for k, v in zip("wxyz", q)
            )
            + "</rotation><translation type=\"Structure\">"
            + "".join(
                f'<{k} type="Float">{float(v)!r}</{k}>'
                for k, v in zip("xyz", t)
            )
            + "</translation></pose>"
        )
    xml = (
        f'<?xml version="1.0" encoding="UTF-8"?>'
        f'<e57Root type="Structure" xmlns="{E57_NS}">'
        f'<formatName type="String"><![CDATA[ASTM E57 3D Imaging Data File]]></formatName>'
        f'<guid type="String"><![CDATA[{{tpu3dtk}}]]></guid>'
        f'<versionMajor type="Integer">1</versionMajor>'
        f'<versionMinor type="Integer">0</versionMinor>'
        f'<data3D type="Vector" allowHeterogeneousChildren="1">'
        f'<vectorChild type="Structure">'
        f'<guid type="String"><![CDATA[{{scan0}}]]></guid>'
        f"{pose_xml}"
        f'<points type="CompressedVector" fileOffset="{logical_to_phys(bin_logical_off)}" recordCount="{n}">'
        f'<prototype type="Structure">{proto}</prototype>'
        f'<codecs type="Vector" allowHeterogeneousChildren="1"/>'
        f"</points></vectorChild></data3D></e57Root>"
    ).encode()

    logical = bytearray()
    xml_phys = logical_to_phys(xml_logical_off)
    header = struct.pack(
        "<8sIIQQQQ", b"ASTM-E57", 1, 0,
        0,  # filePhysicalLength patched below
        xml_phys, len(xml), _PAGE,
    )
    assert len(header) == 48
    logical += header
    logical += sec
    logical += pk
    logical += xml
    n_pages = -(-len(logical) // _PAYLOAD)
    phys_len = n_pages * _PAGE
    logical[24 - 8: 24] = struct.pack("<Q", phys_len)
    with open(path, "wb") as f:
        _paged_write(f, bytes(logical))


def e57_to_scan(path: str, out_dir: str, start_index: int = 0) -> int:
    """The reference's ``e572scan`` converter (src/slam6d/e572scan.cc):
    every Data3D scan becomes scanNNN.3d (uos frame, cm) + scanNNN.pose.
    Returns the number of scans written."""
    from .formats import _t_xyz

    raw = open(path, "rb").read()
    (xml_phys, xml_len) = struct.unpack_from("<QQ", raw, 24)
    logical = _logical_bytes(raw)
    xoff = _phys_to_logical(xml_phys)
    root = ET.fromstring(logical[xoff: xoff + xml_len].decode())
    d3 = _find(root, "data3D")
    n_scans = len(list(d3)) if d3 is not None else 0
    os.makedirs(out_dir, exist_ok=True)
    for k in range(n_scans):
        ch = read_e57(path, scan_index=k)
        xyz = _t_xyz(ch["xyz"])  # metres right-handed -> uos cm
        ident = f"{start_index + k:03d}"
        np.savetxt(
            os.path.join(out_dir, f"scan{ident}.3d"), xyz, fmt="%.4f"
        )
        pos = np.zeros(3)
        theta = np.zeros(3)
        if "pose_translation" in ch:
            t = ch["pose_translation"]
            pos = np.array([-100.0 * t[1], 100.0 * t[2], 100.0 * t[0]])
        with open(os.path.join(out_dir, f"scan{ident}.pose"), "w") as f:
            f.write(f"{pos[0]} {pos[1]} {pos[2]}\n")
            f.write(f"{theta[0]} {theta[1]} {theta[2]}\n")
    return n_scans
