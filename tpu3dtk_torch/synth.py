"""Synthetic scan sequences — numpy-only copies of ``synth_loop``,
``synth_ring`` and ``synth_city`` from ``scripts/make_golden.py`` (which
imports the JAX package).  With the same arguments they return the same arrays: the
random draws are identical and the pose math is the port's numpy
``math3d``, the same formulas.

- :func:`synth_loop`: a 60-scan loop through a pillared hall.
- :func:`synth_ring`: the h468 regime, 468 scans of 16384 points on a
  ring corridor traversed 1.3 times.
- :func:`synth_city`: the bremen_city regime, 13 dense terrestrial scans
  of 1M raw points of a city block.
- :func:`synth_linescans`: line scans of a mobile mapper with linear
  lateral odometry drift, the construction of
  ``tests/test_srr.py::_make_linescans`` (for ``models.srr``).

Each returns (locals [n][n_pts,3] f32, true_mats, odo_mats).
:func:`write_scan_dir` stores such a sequence as a uos scan directory;
:func:`write_net_graph` stores a pose graph as a ``.net`` file.

- :func:`building_room`: a scanner at the centre of a 20 x 12 x 4 m room
  (the velodyne room's box) with doors and windows cut in its walls, for
  ``models.building``.
- :func:`velodyne_capture`: one revolution of an HDL-64E in a box room,
  ray-cast and packed as the raw ``.bin`` capture ``-f velodyne`` reads
  (the JAX package has no writer; this one follows the decoder,
  ``io/velodyne.py``); :func:`synth_velodyne` drives a sensor through
  such a room and :func:`write_velodyne_dir` stores the captures.
"""

from __future__ import annotations

import os

import numpy as np

from .core import math3d
from .io import velodyne
from .io.writer import write_pose, write_uos

__all__ = [
    "building_room", "city_planes", "ring_normals", "synth_city", "synth_linescans", "synth_loop",
    "synth_ring", "synth_velodyne", "velodyne_capture", "write_net_graph",
    "write_scan_dir", "write_velodyne_dir",
]

# synth_city's blocks: 4 x 4 of CITY_BLOCK cm squares, CITY_PITCH cm apart
CITY_BLOCK = 2200.0
CITY_PITCH = 3500.0
CITY_ORIGIN = 800.0


def write_scan_dir(directory: str, locals_, poses) -> list[str]:
    """Write ``scanNNN.3d`` (local points) and ``scanNNN.pose`` (the
    given 4x4 poses as position + Euler degrees) for each scan, the uos
    layout ``-f uos`` reads.  Returns the identifiers."""
    os.makedirs(directory, exist_ok=True)
    idents = []
    for k, (pts, T) in enumerate(zip(locals_, poses)):
        ident = f"{k:03d}"
        write_uos(os.path.join(directory, f"scan{ident}.3d"), pts)
        theta, pos = math3d.matrix4_to_euler(np.asarray(T, np.float64))
        write_pose(os.path.join(directory, f"scan{ident}.pose"), pos, theta)
        idents.append(ident)
    return idents


def write_net_graph(path: str, n_scans: int, links) -> None:
    """Write a pose graph in the ``.net`` format
    ``models.graphslam.read_net_graph`` reads: the number of scans, the
    number of links, then one 'from to' pair per line."""
    links = np.asarray(links, np.int64).reshape(-1, 2)
    with open(path, "w") as f:
        f.write(f"{int(n_scans)}\n{len(links)}\n")
        for a, b in links:
            f.write(f"{a} {b}\n")


def _room_cloud(rng, n=4000, size=1000.0):
    """Points on the six walls of a box, n // 6 a wall (the construction
    of ``tests/conftest.py::make_room_cloud``, the same draws)."""
    n_face = n // 6
    pts = []
    for axis in range(3):
        for side in (0.0, size):
            p = rng.uniform(0, size, size=(n_face, 3))
            p[:, axis] = side
            pts.append(p)
    return np.concatenate(pts, axis=0)


def synth_linescans(n_lines=40, pts_per_line=1500, drift=0.25, seed=42):
    """Line scans of a mobile mapper: a 30000-point room cloud 800 cm
    wide (``_room_cloud``) seen from ``n_lines`` poses 5 cm apart along
    x, each line a random slice of ``pts_per_line`` world points in its
    local frame; the odometry drifts laterally by ``drift`` cm a line in
    z (a miscalibrated platform).  With the defaults and
    ``np.random.default_rng(42)``'s draws, the data of
    ``tests/test_srr.py::_make_linescans``.  Returns (locals
    [n_lines][pts_per_line,3] f64, true_mats, odo_mats)."""
    rng = np.random.default_rng(seed)
    world = _room_cloud(rng, n=30000, size=800.0)
    locals_, true_mats, odo_mats = [], [], []
    acc = np.zeros(3)
    for i in range(n_lines):
        pos = np.array([5.0 * i, 0.0, 0.0])
        T_true = math3d.euler_to_matrix4(pos, np.zeros(3), xp=np)
        sel = rng.choice(len(world), pts_per_line, replace=False)
        locals_.append(math3d.transform3(math3d.m4inv(T_true, xp=np), world[sel], xp=np))
        true_mats.append(T_true)
        acc = acc + np.array([0.0, 0.0, drift])
        odo_mats.append(math3d.euler_to_matrix4(pos + acc, np.zeros(3), xp=np))
    return locals_, np.stack(true_mats), np.stack(odo_mats)


def synth_loop(n_scans=60, seed=7, n_pts=6000, density=1.0):
    """Deterministic synthetic loop: a room-scape sampled from poses on
    a closed circuit, odometry poses perturbed with drift-like noise.
    Returns (locals, true_mats, odo_mats).  ``n_pts``: points per scan
    sample; ``density``: environment point multiplier (raise together
    to simulate denser sensors for the 16k-point bench variant)."""
    rng = np.random.default_rng(seed)
    # environment: walls of a big hall + pillars (well-constrained)
    walls = []
    size = 4000.0
    n_face = int(9000 * density)
    for axis in range(3):
        for side in (0.0, size):
            p = rng.uniform(0, size, (n_face, 3))
            p[:, axis] = side
            walls.append(p)
    for _ in range(14):  # pillars
        c = rng.uniform(500, size - 500, 2)
        n_pillar = int(800 * density)
        ang = rng.uniform(0, 2 * np.pi, n_pillar)
        r = 60.0
        pts = np.stack(
            [c[0] + r * np.cos(ang), rng.uniform(0, size, n_pillar),
             c[1] + r * np.sin(ang)],
            axis=1,
        )
        walls.append(pts)
    env = np.concatenate(walls)

    true_mats, odo_mats, locals_ = [], [], []
    drift = np.zeros(3)
    for k in range(n_scans):
        ang = 2 * np.pi * k / n_scans
        center = np.array(
            [size / 2 + 1200 * np.cos(ang), size / 2, size / 2 + 1200 * np.sin(ang)]
        )
        theta = np.array([0.0, -ang, 0.0])
        T = np.asarray(math3d.euler_to_matrix4(center, theta, xp=np))
        true_mats.append(T)
        # simulated scan: environment points within range, in local frame
        d2 = ((env - center) ** 2).sum(1)
        vis = env[d2 < 1500.0**2]
        vis = vis[rng.permutation(len(vis))[:n_pts]]
        Ti = np.linalg.inv(T)
        local = vis @ Ti[:3, :3].T + Ti[:3, 3]
        local += rng.normal(0, 1.0, local.shape)  # 1 cm sensor noise
        locals_.append(local.astype(np.float32))
        # odometry: true pose + accumulating drift
        drift += rng.normal(0, 6.0, 3)
        To = T.copy()
        To[:3, 3] += drift
        odo_mats.append(To)
    return locals_, true_mats, odo_mats


def synth_ring(n_scans=468, n_pts=16384, radius=4500.0, half_width=300.0,
               half_height=600.0, laps=1.3, drift=2.0, seed=11, n_render=None):
    """The hannover2 regime: a ring CORRIDOR (two cylindrical walls +
    floor + ceiling + pillars) traversed for ``laps`` laps, so the
    second lap continuously re-visits the first — the -L 4 continuous
    loop-closure schedule of the reference (README.md hannover2 config).
    Unlike :func:`synth_loop`, the geometry scales with n_scans: scan
    spacing stays sensor-realistic (~laps·2πR/n cm) instead of shrinking
    to nothing.  Returns (locals [n][n_pts,3] f32, true_mats, odo_mats).
    ``n_render``: make only the first so many scans of the ring (the
    same scans and poses the whole ring starts with).
    """
    rng = np.random.default_rng(seed)
    cy = 0.0
    # corridor surface sampling: area-weighted among inner wall, outer
    # wall, floor, ceiling; ~1.2M points for a 45 m ring
    n_env = 1_200_000
    phi = rng.uniform(0, 2 * np.pi, n_env)
    kind = rng.integers(0, 4, n_env)
    r = np.where(
        kind == 0, radius - half_width,
        np.where(kind == 1, radius + half_width,
                 rng.uniform(radius - half_width, radius + half_width, n_env)),
    )
    y = np.where(
        kind == 2, cy - half_height,
        np.where(kind == 3, cy + half_height,
                 rng.uniform(cy - half_height, cy + half_height, n_env)),
    )
    env = np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=1)
    # pillars along the ring every ~15 degrees
    extra = [env]
    for a in np.arange(0, 2 * np.pi, np.pi / 12):
        n_p = 3000
        ang = rng.uniform(0, 2 * np.pi, n_p)
        pr = 40.0
        c = np.array([radius * np.cos(a), 0.0, radius * np.sin(a)])
        extra.append(np.stack(
            [c[0] + pr * np.cos(ang),
             rng.uniform(cy - half_height, cy + half_height, n_p),
             c[2] + pr * np.sin(ang)], axis=1,
        ))
    # clutter boxes on the corridor floor: the asymmetric structure
    # that anchors the tangential DOF (a bare ring corridor is
    # rotationally symmetric — ICP's cost valley is flat along the
    # tangent and sparse-sampling noise makes the chain slide)
    n_boxes = 240
    for _ in range(n_boxes):
        a = rng.uniform(0, 2 * np.pi)
        br = rng.uniform(radius - half_width + 60, radius + half_width - 60)
        c = np.array([br * np.cos(a), cy - half_height, br * np.sin(a)])
        w, d, h = rng.uniform(40, 160, 3)
        yaw = rng.uniform(0, 2 * np.pi)
        n_b = 2200
        face = rng.integers(0, 5, n_b)  # 4 sides + top
        u, v = rng.uniform(0, 1, n_b), rng.uniform(0, 1, n_b)
        bx = np.where(face == 0, 0.0, np.where(face == 1, w, u * w))
        bz = np.where(face == 2, 0.0, np.where(face == 3, d, v * d))
        bx = np.where(face >= 2, u * w, bx)
        bz = np.where(face < 2, v * d, bz)
        by = np.where(face == 4, h, v * h)
        bx, bz = bx - w / 2, bz - d / 2
        ca, sa = np.cos(yaw), np.sin(yaw)
        pts = np.stack(
            [c[0] + ca * bx - sa * bz, c[1] + by, c[2] + sa * bx + ca * bz],
            axis=1,
        )
        extra.append(pts)
    env = np.concatenate(extra).astype(np.float32)

    range_max = 8.0 * half_width
    true_mats, odo_mats, locals_ = [], [], []
    dacc = np.zeros(3)
    for k in range(n_scans if n_render is None else n_render):
        ang = laps * 2 * np.pi * k / n_scans
        center = np.array(
            [radius * np.cos(ang), cy, radius * np.sin(ang)]
        )
        theta = np.array([0.0, -ang, 0.0])
        T = np.asarray(math3d.euler_to_matrix4(center, theta, xp=np))
        true_mats.append(T)
        d2 = ((env - center) ** 2).sum(1)
        inr = d2 < range_max**2
        vis = env[inr]
        # solid-angle sampling (P ∝ 1/d²): a real scanner resolves
        # nearby surfaces densely — uniform-area sampling leaves ~25 cm
        # inter-scan surface gaps everywhere and ICP walks the
        # resulting flat cost valley (measured 2 m per-match error)
        w = 1.0 / np.maximum(d2[inr], 100.0**2)
        take = min(n_pts, len(vis))
        sel = rng.choice(len(vis), take, replace=False, p=w / w.sum())
        vis = vis[sel]
        Ti = np.linalg.inv(T)
        local = vis @ Ti[:3, :3].T + Ti[:3, 3]
        local += rng.normal(0, 1.0, local.shape)  # 1 cm sensor noise
        locals_.append(local.astype(np.float32))
        dacc += rng.normal(0, drift, 3)
        To = T.copy()
        To[:3, 3] += dacc
        odo_mats.append(To)
    return locals_, true_mats, odo_mats


def synth_city(n_scans=13, n_pts=1_000_000, seed=23):
    """The bremen_city regime: ~13 dense terrestrial scans (≥1M raw
    points each) of a city block — ground plane + building facades —
    taken along a street path (riegl_txt, octree reduction, -d 150
    matching).  Returns (locals, true_mats, odo_mats); locals are RAW
    (unreduced) f32 clouds."""
    rng = np.random.default_rng(seed)
    area = 14000.0  # 140 m square
    parts = []
    n_ground = 2_500_000
    g = rng.uniform(0, area, (n_ground, 2))
    parts.append(np.stack([g[:, 0], np.zeros(n_ground), g[:, 1]], axis=1))
    # building blocks on a grid with street gaps
    for bx in range(4):
        for bz in range(4):
            x0, z0 = CITY_ORIGIN + bx * CITY_PITCH, CITY_ORIGIN + bz * CITY_PITCH
            w, d, h = CITY_BLOCK, CITY_BLOCK, rng.uniform(800, 2500)
            n_f = 160_000
            side = rng.integers(0, 4, n_f)
            u = rng.uniform(0, 1, n_f)
            yy = rng.uniform(0, h, n_f)
            xx = np.where(side == 0, x0, np.where(side == 1, x0 + w, x0 + u * w))
            zz = np.where(side == 2, z0, np.where(side == 3, z0 + d, z0 + u * d))
            xx = np.where(side >= 2, x0 + u * w, xx)
            zz = np.where(side < 2, z0 + u * d, zz)
            parts.append(np.stack([xx, yy, zz], axis=1))
    env = np.concatenate(parts).astype(np.float32)

    range_max = 5000.0
    true_mats, odo_mats, locals_ = [], [], []
    dacc = np.zeros(3)
    # street path: L-shaped route through the block grid
    waypoints = np.linspace(0, 1, n_scans)
    for t in waypoints:
        if t < 0.5:
            center = np.array([2900.0, 170.0, 1500 + t * 2 * 10000])
            yaw = 0.0
        else:
            center = np.array(
                [2900 + (t - 0.5) * 2 * 9000, 170.0, 11500.0]
            )
            yaw = -np.pi / 2
        T = np.asarray(
            math3d.euler_to_matrix4(center, np.array([0.0, yaw, 0.0]), xp=np)
        )
        true_mats.append(T)
        d2 = ((env - center) ** 2).sum(1)
        inr = d2 < range_max**2
        vis = env[inr]
        # solid-angle sampling (P ∝ 1/d², Gumbel top-k): see synth_ring
        w = 1.0 / np.maximum(d2[inr], 300.0**2)
        keys = np.log(w) + rng.gumbel(size=len(vis))
        take = min(n_pts, len(vis))
        vis = vis[np.argpartition(-keys, take - 1)[:take]]
        Ti = np.linalg.inv(T)
        local = vis @ Ti[:3, :3].T + Ti[:3, 3]
        local += rng.normal(0, 1.5, local.shape)
        locals_.append(local.astype(np.float32))
        dacc += rng.normal(0, 15.0, 3)  # coarse GPS/odometry prior
        To = T.copy()
        To[:3, 3] += dacc
        odo_mats.append(To)
    return locals_, true_mats, odo_mats


def city_people(true_mats, n_people=10, n_pts=1500, size=(40.0, 180.0, 40.0), seed=31,
                near=300.0, far=2000.0):
    """Person columns standing on :func:`synth_city`'s ground near each
    scanner, at places drawn anew for every scan (the transient objects a
    people remover deletes): ``n_people`` boxes of ``size`` (x, height,
    z in cm) a scan, ``near``-``far`` cm from the scanner, each sampled
    with ``n_pts`` points on its four sides and top.  Returns, a scan,
    (boxes [n_people] of (lo [3], hi [3]), points [n_people·n_pts, 3] f32),
    both in the world frame."""
    rng = np.random.default_rng(seed)
    w, h, d = size
    out = []
    for T in true_mats:
        c = np.asarray(T)[:3, 3]
        ang = rng.uniform(0, 2 * np.pi, n_people)
        dist = rng.uniform(near, far, n_people)
        boxes, pts = [], []
        for a, r in zip(ang, dist):
            lo = np.array([c[0] + r * np.cos(a) - w / 2, 0.0, c[2] + r * np.sin(a) - d / 2])
            hi = lo + np.array([w, h, d])
            face = rng.integers(0, 5, n_pts)  # 4 sides + top
            u, v, t = rng.uniform(0, 1, (3, n_pts))
            x = np.where(face == 0, 0.0, np.where(face == 1, w, u * w))
            z = np.where(face == 2, 0.0, np.where(face == 3, d, v * d))
            y = np.where(face == 4, h, t * h)
            boxes.append((lo, hi))
            pts.append(lo + np.stack([x, y, z], axis=1))
        out.append((boxes, np.concatenate(pts).astype(np.float32)))
    return out


def city_planes():
    """The distinct planes of :func:`synth_city`'s world as (unit normal
    [3], d) with n·p = d: the ground y = 0, then the facade planes x =
    const and z = const of the 4 x 4 blocks (each shared by a row of
    blocks)."""
    edges = sorted({CITY_ORIGIN + k * CITY_PITCH + s for k in range(4) for s in (0.0, CITY_BLOCK)})
    planes = [(np.array([0.0, 1.0, 0.0]), 0.0)]
    for axis in (0, 2):
        n = np.zeros(3)
        n[axis] = 1.0
        planes += [(n.copy(), float(e)) for e in edges]
    return planes


def ring_normals(world, radius=4500.0, half_width=300.0, half_height=600.0, tol=5.0):
    """The analytic surface normals of :func:`synth_ring`'s corridor at
    world points [N,3] (its default geometry): radial on the two walls,
    vertical on the floor and the ceiling.  Returns (normals [N,3],
    on_surface [N] bool): points within ``tol`` cm of a wall, the floor
    or the ceiling, and not within 60 cm of a pillar's axis (pillars
    every 15 degrees on the centre line)."""
    w = np.asarray(world, np.float64)
    r = np.hypot(w[:, 0], w[:, 2])
    wall = (np.abs(r - (radius - half_width)) < tol) | (np.abs(r - (radius + half_width)) < tol)
    flat = np.abs(np.abs(w[:, 1]) - half_height) < tol
    a = np.arange(0, 2 * np.pi, np.pi / 12)
    pillars = np.stack([radius * np.cos(a), radius * np.sin(a)], 1)
    near = (((w[:, None, [0, 2]] - pillars[None]) ** 2).sum(-1) < 60.0**2).any(1)
    n = np.zeros_like(w)
    n[:, 0], n[:, 2] = w[:, 0] / np.maximum(r, 1e-9), w[:, 2] / np.maximum(r, 1e-9)
    n[flat & ~wall] = [0.0, 1.0, 0.0]
    return n, (wall ^ flat) & ~near


# one firing of the raw capture (io/velodyne.py's layout): the block
# header (0xEEFF upper lasers 0-31, 0xDDFF lower 32-63), the rotational
# position in 1/100 deg, 32 x (distance in 2 mm LSB, intensity)
_FIRING = np.dtype([
    ("head", "<u2"), ("rot", "<u2"),
    ("ret", [("dist", "<u2"), ("inten", "u1")], (32,)),
])
_BLOCK = np.dtype([
    ("record", "u1", (velodyne.BLOCK_OFFSET,)),  # pcap-style header, skipped
    ("fire", _FIRING, (12,)),
    ("status", "u1", (6,)),
])
# the decoder's range gates (m, exclusive)
VELO_MIN_M, VELO_MAX_M = 2.2, 120.0
# synth_velodyne's room: 20 x 12 x 4 m (uos x, z, y), the floor 180 cm
# below the sensor's first position
VELO_ROOM_LO = np.array([-700.0, -180.0, -600.0])
VELO_ROOM_HI = np.array([1300.0, 220.0, 600.0])


# building_room's openings: (wall axis, wall side (0: lo, 1: hi), along-wall
# lo, along-wall hi, height lo, height hi, kind); heights from the floor
ROOM_OPENINGS = (
    (2, 0, 0.0, 90.0, 0.0, 210.0, "door"),
    (0, 1, -200.0, -110.0, 0.0, 210.0, "door"),
    (2, 1, -300.0, -180.0, 100.0, 200.0, "window"),
    (2, 1, 500.0, 620.0, 100.0, 200.0, "window"),
    (0, 0, 100.0, 220.0, 100.0, 200.0, "window"),
    (2, 0, 700.0, 820.0, 100.0, 200.0, "window"),
)


def building_room(n_pts=2_000_000, noise=0.5, seed=37, lo=VELO_ROOM_LO, hi=VELO_ROOM_HI,
                  openings=ROOM_OPENINGS):
    """A terrestrial scan from the centre of a box room (``lo``-``hi``,
    y up; the velodyne room: 20 m along x, 12 m along z, 4 m high) with
    ``openings`` cut in its walls: rays in uniformly random directions
    hit the nearest face and return with ``noise`` cm of Gaussian noise,
    except where they leave through an opening (no return).  Each
    opening is (wall axis 0: x = const / 2: z = const, side 0: lo / 1:
    hi, along-wall lo, hi, height above the floor lo, hi, kind).
    Returns (points [~n_pts, 3] f32 in the room's frame, the scanner
    position [3], openings as (axis, side, box lo [3], box hi [3],
    kind))."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    c = 0.5 * (lo + hi)
    d = rng.normal(size=(n_pts, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        t_face = np.where(d > 0, (hi - c) / d, (lo - c) / d)
    axis = np.argmin(t_face, 1)
    t = t_face[np.arange(n_pts), axis]
    p = c + d * t[:, None]
    boxes = []
    keep = np.ones(n_pts, bool)
    for ax, side, a0, a1, h0, h1, kind in openings:
        along = 2 if ax == 0 else 0
        wall = (lo if side == 0 else hi)[ax]
        b_lo, b_hi = np.empty(3), np.empty(3)
        b_lo[ax], b_hi[ax] = wall, wall
        b_lo[along], b_hi[along] = a0, a1
        b_lo[1], b_hi[1] = lo[1] + h0, lo[1] + h1
        boxes.append((ax, side, b_lo, b_hi, kind))
        on = (axis == ax) & (np.sign(d[:, ax]) == (1 if side else -1))
        inside = (p[:, along] > a0) & (p[:, along] < a1) & (p[:, 1] > b_lo[1]) & (p[:, 1] < b_hi[1])
        keep &= ~(on & inside)
    p = p[keep] + rng.normal(0, noise, (int(keep.sum()), 3))
    return p.astype(np.float32), c, boxes



def velodyne_capture(pose, lo=VELO_ROOM_LO, hi=VELO_ROOM_HI, intensity=100, boxes=()) -> bytes:
    """One revolution of an HDL-64E at ``pose`` (4x4, uos frame, cm) inside
    the box room [lo, hi] (cm), as a raw capture: 360 blocks of 12
    firings, upper and lower blocks alternating, 2160 rotational
    positions 1/6 deg apart, 32 lasers a firing (138240 returns at most).
    Each laser's ray uses the decoder's default calibration and its angle
    formula (``io/velodyne.py::decode_velodyne``), so the decoded points
    are the ray's first hit on a face, up to the 2 mm distance LSB.
    ``boxes``: axis-aligned obstacles ((lo [3], hi [3]) in cm, world
    frame) inside the room; a ray returns its nearest hit among the
    room's faces and the boxes' outsides.  Returns outside the decoder's
    gates (2.2, 120) m are written as 0."""
    cal = velodyne.default_calibration()
    n_fire = velodyne.CIRCLELENGTH * 12
    k = np.arange(n_fire)
    upper = k % 2 == 0
    rot = np.round((k // 2) * 100.0 / 6.0).astype(np.uint16)  # 1/100 deg
    base = np.where(upper, 0, 32)
    vert = np.deg2rad(cal[:, 0])[base[:, None] + np.arange(32)[None, :]]  # [F, 32]
    ctheta = 2.0 * np.pi - np.deg2rad(rot.astype(np.float64) / 100.0)
    ctheta = np.where(ctheta >= 2.0 * np.pi, 0.0, ctheta)[:, None]
    # unit ray in the sensor frame, mapped to uos as the decoder maps points
    d_local = np.stack([
        np.cos(ctheta) * np.cos(vert), np.sin(vert), -np.sin(ctheta) * np.cos(vert),
    ], axis=-1)
    T = np.asarray(pose, np.float64)
    d = d_local @ T[:3, :3].T
    o = T[:3, 3]
    with np.errstate(divide="ignore"):
        t_face = np.where(d > 0, (np.asarray(hi) - o) / d, (np.asarray(lo) - o) / d)
    t = np.where(d != 0, t_face, np.inf).min(-1)  # cm to the first face hit
    for blo, bhi in boxes:  # slab test: enter at the largest near-plane t
        with np.errstate(divide="ignore", invalid="ignore"):
            t1, t2 = (np.asarray(blo) - o) / d, (np.asarray(bhi) - o) / d
        t_in = np.fmax.reduce(np.fmin(t1, t2), axis=-1)
        t_out = np.fmin.reduce(np.fmax(t1, t2), axis=-1)
        t = np.where((t_in <= t_out) & (t_in > 0), np.minimum(t, t_in), t)
    lsb = np.round(t / 100.0 / velodyne.METERS_PER_LSB)
    dist_m = lsb * velodyne.METERS_PER_LSB
    ok = (dist_m > VELO_MIN_M) & (dist_m < VELO_MAX_M)
    blocks = np.zeros(velodyne.CIRCLELENGTH, _BLOCK)
    fire = blocks["fire"].reshape(n_fire)
    fire["head"] = np.where(upper, 0xEEFF, 0xDDFF)
    fire["rot"] = rot
    fire["ret"]["dist"] = np.where(ok, lsb, 0).astype(np.uint16)
    fire["ret"]["inten"] = np.where(ok, intensity, 0).astype(np.uint8)
    blocks["fire"] = fire.reshape(velodyne.CIRCLELENGTH, 12)
    return blocks.tobytes()


def velodyne_mover(n_captures=20, speed=90.0, size=(450.0, 150.0, 180.0), x0=-500.0,
                   z=350.0, clearance=30.0):
    """A car-sized box (``size`` = length along x, height, width in cm)
    driving along +x at ``speed`` cm a capture beside
    :func:`synth_velodyne`'s path, ``clearance`` cm above the room's floor,
    from centre x = ``x0`` through the room (it enters and leaves through
    the end walls).  Returns one [(lo, hi)] box list a capture."""
    half = np.array([size[0] / 2, 0.0, size[2] / 2])
    out = []
    for i in range(n_captures):
        c = np.array([x0 + speed * i, VELO_ROOM_LO[1] + clearance, z])
        out.append([(c - half, c + half + np.array([0.0, size[1], 0.0]))])
    return out


def synth_velodyne(n_captures=20, step=10.0, yaw_step_deg=0.5, seed=29,
                   odo_sigma_cm=2.0, odo_sigma_deg=0.3, boxes=None):
    """A sensor driven through :func:`velodyne_capture`'s room: ``step``
    cm along its heading and ``yaw_step_deg`` about the vertical (uos y)
    a capture; odometry accumulates a seeded error on every step (normal,
    ``odo_sigma_cm`` on x and z, ``odo_sigma_deg`` of yaw).  ``boxes``:
    one obstacle list a capture (e.g. :func:`velodyne_mover`'s).  Returns
    (captures [n] bytes, true_mats, odo_mats)."""
    rng = np.random.default_rng(seed)
    captures, true_mats, odo_mats = [], [], []
    pos, yaw = np.zeros(3), 0.0
    opos, oyaw = np.zeros(3), 0.0
    for i in range(n_captures):
        if i:
            fwd = np.array([np.cos(yaw), 0.0, -np.sin(yaw)])
            ofwd = np.array([np.cos(oyaw), 0.0, -np.sin(oyaw)])
            pos = pos + step * fwd
            yaw += np.deg2rad(yaw_step_deg)
            err = rng.normal(0.0, odo_sigma_cm, 2)
            opos = opos + step * ofwd + np.array([err[0], 0.0, err[1]])
            oyaw += np.deg2rad(yaw_step_deg + rng.normal(0.0, odo_sigma_deg))
        T = np.asarray(math3d.euler_to_matrix4(pos, np.array([0.0, yaw, 0.0]), xp=np))
        captures.append(velodyne_capture(T, boxes=boxes[i] if boxes is not None else ()))
        true_mats.append(T)
        odo_mats.append(np.asarray(
            math3d.euler_to_matrix4(opos, np.array([0.0, oyaw, 0.0]), xp=np)
        ))
    return captures, np.stack(true_mats), np.stack(odo_mats)


def write_velodyne_dir(directory: str, captures, poses) -> list[str]:
    """Write ``scanNNN.bin`` (the raw captures) and ``scanNNN.pose`` (the
    given 4x4 poses), the layout ``-f velodyne`` reads.  Returns the
    identifiers."""
    os.makedirs(directory, exist_ok=True)
    idents = []
    for k, (cap, T) in enumerate(zip(captures, poses)):
        ident = f"{k:03d}"
        with open(os.path.join(directory, f"scan{ident}.bin"), "wb") as f:
            f.write(cap)
        theta, pos = math3d.matrix4_to_euler(np.asarray(T, np.float64))
        write_pose(os.path.join(directory, f"scan{ident}.pose"), pos, theta)
        idents.append(ident)
    return idents
