"""Plane-based registration of the port (``models.preg6d``,
``torchplanereg``) against the JAX package's, on the same numpy inputs:
the perturbed room scans of tests/test_preg6d.py, with the JAX package's
reduced points (the random reduction differs between the packages) and,
for the normals gate, its normals.

Bounds:
- Gauss-Newton ``plane_register`` with and without normals: T within
  1e-3 cm / 1e-5, the same iterations ±1, the same associations ±0.1%.
- AdaDelta, 200 iterations: T within 0.01 cm; the energy's autograd
  gradient passes ``torch.autograd.gradcheck`` in f64.
- ``preg6d`` detecting its own planes (SHT on the condensed cloud):
  poses within 0.05 cm, on the room and on a sparse 13-scan city (the
  bremen sequence at 300 points a scan) perturbed by 5 cm and 0.03° or
  0.3° a Euler angle.
- ``match_planes``: identical pairs.
- ``torchplanereg --device cpu`` against ``tpuplanereg`` (no reduction,
  ``.frames`` in, ``.frames`` out): poses within 0.05 cm / 1e-5, the
  same AlgoType tags.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_room_cloud
from tpu3dtk.cli import preg6d as jcli
from tpu3dtk.core import math3d as jmath3d
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.io import frames as jframes
from tpu3dtk.models import preg6d as jpreg
from tpu3dtk.models.shapes import HoughParams as JHoughParams
from tpu3dtk.models.shapes import Plane as JPlane
from tpu3dtk_torch import interop
from tpu3dtk_torch.cli import preg6d as tcli
from tpu3dtk_torch.core import math3d as tmath3d
from tpu3dtk_torch.io import frames as tframes
from tpu3dtk_torch.models import preg6d as tpreg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def room_planes(size=800.0):
    """The 6 exact wall planes of the conftest room cloud (as
    tests/test_preg6d.py builds them)."""
    planes = []
    for axis in range(3):
        n = np.zeros(3)
        n[axis] = 1.0
        c0 = np.full(3, size / 2)
        for side in (0.0, size):
            c = c0.copy()
            c[axis] = side
            planes.append(JPlane(normal=n.copy(), rho=side, n_inliers=1000, center=c))
    return planes


def _jax_scan(seed, offset, angles_deg):
    """tests/test_preg6d.py::_perturbed_scan: the room in its own frame
    at a perturbed pose, reduced by the JAX package (-r 15 -O 1)."""
    world = make_room_cloud(np.random.default_rng(seed), n=6000, size=800.0)
    T0 = np.asarray(jmath3d.euler_to_matrix4(np.asarray(offset, float), np.deg2rad(angles_deg)))
    s = TPUScan.from_points(world, "000", pose=T0)
    s.set_reduction(15.0, 1)
    s.reduced_local()
    return s


def _carry(jscans):
    tscans, _ = interop.scans_from_numpy([
        {"identifier": s.identifier, "xyz": s.xyz, "reduced_local": s.reduced_local(),
         "transMatOrg": s.transMatOrg, "transMat": s.transMat}
        for s in jscans
    ])
    for t in tscans:
        t.device = "cpu"
    return tscans


def _both_register(s, planes, iterations, optimizer, use_normals, eps_hesse=30.0):
    """plane_register of both packages on scan ``s``'s JAX-reduced points:
    the JAX one padded to a multiple of 512 as its preg6d() does, the
    port's unpadded."""
    pn, pd = jpreg._plane_arrays(planes)
    r = np.asarray(s.reduced_local(), np.float32)
    cap = ((len(r) + 511) // 512) * 512
    pts = np.zeros((cap, 3), np.float32)
    pts[: len(r)] = r
    mask = np.arange(cap) < len(r)
    normals = s.reduced_normals_padded(cap) if use_normals else None
    kw = dict(iterations=iterations, optimizer=optimizer, use_normals=use_normals)
    T0 = s.transMat.astype(np.float32)
    # unjitted: the jitted JAX function cannot trace its use_normals
    # branch (np.cos of the traced cos_sim); eagerly cos_sim stays a float
    jT, je, jit, jn = jpreg.plane_register.__wrapped__(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pn), jnp.asarray(pd), jnp.asarray(T0),
        eps_hesse, 1e-6, normals_local=None if normals is None else jnp.asarray(normals),
        cos_sim=30.0, **kw,
    )
    tT, te, tit, tn = tpreg.plane_register(
        torch.as_tensor(r), torch.ones(len(r), dtype=torch.bool), torch.as_tensor(pn),
        torch.as_tensor(pd), torch.as_tensor(T0), eps_hesse, 1e-6,
        normals_local=None if normals is None else torch.as_tensor(normals[: len(r)]),
        cos_sim=30.0, **kw,
    )
    return (np.asarray(jT, np.float64), float(je), int(jit), int(jn)), (
        tT.numpy().astype(np.float64), te, tit, tn)


@pytest.mark.parametrize("use_normals", [False, True])
def test_gauss_newton_matches_jax(use_normals):
    s = _jax_scan(42, [8.0, -5.0, 6.0], [1.5, -1.0, 2.0])
    (jT, je, jit, jn), (tT, te, tit, tn) = _both_register(
        s, room_planes(), 50, "gaussnewton", use_normals)
    assert np.abs(tT[:3, 3] - jT[:3, 3]).max() <= 1e-3, (tT, jT)
    assert np.abs(tT[:3, :3] - jT[:3, :3]).max() <= 1e-5
    assert abs(tit - jit) <= 1 and 1 < tit <= 50
    assert abs(tn - jn) <= 1e-3 * jn and tn > 3000
    assert te == pytest.approx(je, rel=1e-2, abs=1e-2)
    # the registration pulls the scan back to the identity
    assert np.linalg.norm(tT[:3, 3]) < 0.5


def test_adadelta_matches_jax():
    s = _jax_scan(42, [3.0, -2.0, 2.0], [0.0, 0.0, 0.0])
    (jT, je, jit, jn), (tT, te, tit, tn) = _both_register(s, room_planes(), 200, "adadelta", False)
    assert jit == tit == 200
    assert np.abs(tT[:3, 3] - jT[:3, 3]).max() <= 0.01, (tT[:3, 3], jT[:3, 3])
    assert np.abs(tT[:3, :3] - jT[:3, :3]).max() <= 1e-5
    assert abs(tn - jn) <= 1e-3 * jn
    assert np.linalg.norm(tT[:3, 3]) < np.linalg.norm([3.0, -2.0, 2.0])


def test_adadelta_energy_gradient_is_autograd_exact():
    """The energy AdaDelta differentiates (the mean squared signed
    distance to the associated planes) through the port's Euler math:
    autograd against finite differences in f64."""
    rng = np.random.default_rng(3)
    world = torch.as_tensor(make_room_cloud(rng, n=600, size=800.0))
    pn, pd = (torch.as_tensor(a, dtype=torch.float64) for a in jpreg._plane_arrays(room_planes()))
    mask = torch.ones(len(world), dtype=torch.bool)

    def energy(pose6):
        T = tmath3d.euler_to_matrix4(pose6[:3], pose6[3:])
        pts_g = tmath3d.transform3(T, world)
        _idx, signed, valid = tpreg.associate_points(pts_g, mask, pn, pd, 30.0)
        w = valid.to(pose6.dtype)
        return (w * signed * signed).sum() / torch.clamp(w.sum(), min=1.0)

    pose = torch.tensor([2.0, -1.5, 1.0, 0.01, -0.005, 0.008], dtype=torch.float64,
                        requires_grad=True)
    assert torch.autograd.gradcheck(energy, (pose,), eps=1e-6, atol=1e-6)


def test_preg6d_detecting_its_planes_matches_jax():
    """tests/test_preg6d.py::test_preg6d_detects_planes_itself through
    both packages."""
    js = _jax_scan(42, [5.0, 4.0, -3.0], [0.8, 0.5, -0.6])
    ja = _jax_scan(7, [0, 0, 0], [0, 0, 0])
    ts = _carry([ja, js])
    params = jpreg.PregParams(eps_hesse=30.0, iterations=50)
    hough = JHoughParams(min_inliers=300, max_planes=8, dist_tol=12.0)
    jinfo = jpreg.preg6d([ja, js], params=params, hough=hough)
    tinfo = tpreg.preg6d(
        ts, params=interop.preg_params_from(vars(params)),
        hough=interop.hough_params_from(vars(hough)), device="cpu",
    )
    for j, t in zip([ja, js], ts):
        assert np.abs(t.transMat[:3, 3] - j.transMat[:3, 3]).max() <= 0.05
        assert np.abs(t.transMat[:3, :3] - j.transMat[:3, :3]).max() <= 1e-4
        assert [f[1] for f in t.frames] == [f[1] for f in j.frames]
    # iteration counts are not compared here: on the unperturbed anchor
    # |dx| hovers about epsilon = 1e-6 in f32 in both packages
    for a, b in zip(tinfo, jinfo):
        assert abs(a["associated"] - b["associated"]) <= 1e-3 * b["associated"]
    assert np.linalg.norm(ts[1].transMat[:3, 3]) < 0.7 * np.linalg.norm([5.0, 4.0, -3.0])


@pytest.fixture(scope="module")
def sparse_city():
    """synth_city's 13 scans at 300 points each (its [N, D] SHT fits the
    JAX package on the CPU) and their true poses."""
    from tpu3dtk_torch.synth import synth_city

    locals_, true, _odo = synth_city(n_scans=13, n_pts=300, seed=23)
    return locals_, [np.asarray(T, np.float64) for T in true]


@pytest.mark.parametrize("angle_deg", [0.03, 0.3])
def test_preg6d_city_matches_jax(sparse_city, angle_deg):
    """The plane-based refinement of a registered city sequence, as
    chip_smoke's phase 24 runs it at full size: scans 1-12 off their true
    poses by 5 cm and ``angle_deg`` a Euler angle, preg6d detecting its
    own planes.  At 0.03° the ground sheets of the scans stay within the
    10 cm band and the mean error falls below 0.7x its start (the JAX
    package's bound); at 0.3° they sit tens of cm apart 50 m out, the
    plane model splits the ground, and both packages move the scans
    along the axes it leaves free, by the same amounts."""
    locals_, truth = sparse_city
    rng = np.random.default_rng(24)
    starts = [truth[0]]
    for T in truth[1:]:
        dt = rng.normal(size=3)
        dt *= 5.0 / np.linalg.norm(dt)
        ang = np.deg2rad(angle_deg) * rng.choice([-1.0, 1.0], 3)
        starts.append(T @ np.asarray(jmath3d.euler_to_matrix4(dt, ang)))
    jscans = []
    for k, (x, T) in enumerate(zip(locals_, starts)):
        s = TPUScan.from_points(x, f"{k:03d}", pose=T)
        s._reduced_local = x
        jscans.append(s)
    tscans = _carry(jscans)
    params = jpreg.PregParams(eps_hesse=25.0, iterations=50)
    hough = JHoughParams(rho_max=20000.0, n_rho=1000, min_inliers=20, max_planes=12, dist_tol=10.0)
    jpreg.preg6d(jscans, params=params, hough=hough)
    tpreg.preg6d(tscans, params=interop.preg_params_from(vars(params)),
                 hough=interop.hough_params_from(vars(hough)), device="cpu")
    for j, t in zip(jscans, tscans):
        assert np.abs(t.transMat[:3, 3] - j.transMat[:3, 3]).max() <= 0.05
        assert np.abs(t.transMat[:3, :3] - j.transMat[:3, :3]).max() <= 1e-4

    def err(scans):
        return np.array([np.linalg.norm(s.transMat[:3, 3] - T[:3, 3]) for s, T in zip(scans, truth)])

    e_j, e_t = err(jscans), err(tscans)
    print(f"\n{angle_deg} deg: scans 1-12 mean translation error 5.0000 -> JAX {e_j[1:].mean():.4f} "
          f"cm (max {e_j[1:].max():.2f}), port {e_t[1:].mean():.4f} (max {e_t[1:].max():.2f}); "
          f"scan 0 moved {e_j[0]:.2f} / {e_t[0]:.2f} cm")
    if angle_deg < 0.1:
        assert e_t[1:].mean() < 0.7 * 5.0
    else:
        assert e_j[1:].mean() > 5.0 and e_j.max() > 100.0


def test_preg_params_carry_across():
    p = jpreg.PregParams(eps_hesse=12.0, optimizer="adadelta", use_normals=True, iterations=9)
    assert dataclasses.asdict(interop.preg_params_from(vars(p))) == dataclasses.asdict(p)


def _tilted(planes, rng):
    out = []
    for p in planes:
        n = p.normal + rng.normal(0, 0.01, 3)
        out.append(JPlane(normal=n / np.linalg.norm(n), rho=p.rho + rng.normal(0, 3.0),
                          n_inliers=500, center=p.center + rng.normal(0, 5.0, 3)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_planes_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g = room_planes()
    loc = _tilted([g[i] for i in rng.permutation(6)[:4]], rng)
    loc.append(JPlane(normal=np.array([1.0, 1.0, 0.0]) / np.sqrt(2), rho=0.0, n_inliers=10,
                      center=np.zeros(3)))
    jp = jpreg.match_planes(loc, g, eps_hesse=20.0, eps_ppd=40.0)
    tp = tpreg.match_planes(
        interop.planes_from_numpy([vars(p) for p in loc]),
        interop.planes_from_numpy([vars(p) for p in g]), eps_hesse=20.0, eps_ppd=40.0,
    )
    assert tp == jp and len(tp) == 4


def test_planereg_cli_matches_jax(tmp_path):
    """A 3-scan room directory, registered poses perturbed in .frames:
    both CLIs detect the planes of the condensed cloud and register
    every scan against them (no reduction)."""
    from tpu3dtk_torch.synth import write_scan_dir

    rng = np.random.default_rng(5)
    world = make_room_cloud(rng, n=9000, size=800.0)
    true = [np.asarray(jmath3d.euler_to_matrix4(np.array([400.0 + 30 * k, 300.0, 400.0]),
                                                np.array([0.0, 0.3 * k, 0.0]))) for k in range(3)]
    locals_ = []
    for T in true:
        sel = rng.choice(len(world), 1500, replace=False)
        Ti = np.linalg.inv(T)
        locals_.append(world[sel] @ Ti[:3, :3].T + Ti[:3, 3] + rng.normal(0, 0.5, (1500, 3)))
    scan_dir = tmp_path / "scans"
    idents = write_scan_dir(str(scan_dir), locals_, true)
    for k, ident in enumerate(idents):
        P = np.asarray(jmath3d.euler_to_matrix4(rng.normal(0, 3.0, 3) * (k > 0),
                                                np.deg2rad(rng.normal(0, 0.5, 3)) * (k > 0)))
        jframes.write_frames(jframes.frames_path(str(scan_dir), ident), (P @ true[k])[None], [2])
    args = [str(scan_dir), "--min-inliers", "200", "--max-planes", "6", "-q"]
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
    assert jcli.main(args + ["--frames-out", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--frames-out", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    for k, ident in enumerate(idents):
        jm, jt = jframes.read_frames(jframes.frames_path(str(tmp_path / "jax"), ident))
        tm, tt = tframes.read_frames(tframes.frames_path(str(tmp_path / "torch"), ident))
        assert list(tt) == list(jt) == [int(tframes.AlgoType.ICP)]
        assert np.abs(tm[-1][:3, 3] - jm[-1][:3, 3]).max() <= 0.05
        assert np.abs(tm[-1][:3, :3] - jm[-1][:3, :3]).max() <= 1e-5
