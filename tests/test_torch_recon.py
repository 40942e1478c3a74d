"""The port's surface reconstruction (``ops.surfacenets``, ``models.tsdf``,
``models.mesh``, ``torchrecon``) against the JAX package's, on the same
numpy inputs made from a seed (the scenes of tests/test_tsdf_mesh.py), on
the CPU (``device="cpu"`` / ``--device cpu``).

Bounds:
- surface nets: faces identical, vertices within 1e-9;
- TSDF: tsdf / weight volumes within 1e-5 (the port rounds its
  product-sums once, as XLA's fused multiply-adds do: identical on these
  inputs), also after a JAX volume's state is carried across by
  ``interop.tsdf_volume_from_numpy``; meshes identical;
- IMLS field within 1e-4 cm, the valid mask identical (the JAX k-NN ranks
  on the |q|²+|m|²−2q·m expansion, the port on direct differences: the
  Gaussian weights differ in the last bits);
- Poisson: chi within 1e-4 of max |chi| (measured ~2e-7), occupancy
  identical;
- ``torchrecon`` against ``tpurecon``: the tsdf mesh identical (OBJ
  vertices within 1e-9, PLY f32 vertices equal); imls and poisson, whose
  normals are estimated by each package (the eigenvector solver rounds
  differently in XLA and torch, so a field value within ~1e-4 of zero can
  change sign), vertex and face counts within 1% and 99% of the port's
  vertices within 1e-3 voxel of a JAX vertex.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from tpu3dtk.models import mesh as jmesh
from tpu3dtk.models import tsdf as jtsdf
from tpu3dtk.ops.surfacenets import surface_nets as jnets
from tpu3dtk_torch import interop, synth
from tpu3dtk_torch.models import mesh as tmesh
from tpu3dtk_torch.models import tsdf as ttsdf
from tpu3dtk_torch.ops.surfacenets import surface_nets as tnets


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_surface_nets_match_jax(noise, masked):
    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(*[np.arange(28)] * 3, indexing="ij"), -1).astype(np.float64)
    f = np.linalg.norm(g - 13.3, axis=-1) - 9.7 + rng.normal(0, noise, g.shape[:3])
    valid = rng.uniform(size=f.shape) > 0.02 if masked else None
    want = jnets(f, valid, origin=(1.0, -2.0, 3.5), voxel=0.5)
    got = tnets(f, valid, origin=(1.0, -2.0, 3.5), voxel=0.5, device="cpu")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)
    assert got[1].dtype == np.int32 and len(got[1]) > 1000


def _sphere_views(rng, n_views=6, R=100.0):
    """(local points, pose) of a sphere seen from ``n_views`` sensors."""
    out = []
    for az in np.linspace(0, 2 * np.pi, n_views, endpoint=False):
        sensor = 400.0 * np.array([np.sin(az), 0.2, np.cos(az)])
        d = rng.normal(size=(3000, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts = R * d[(d @ sensor) > 0]
        T = np.eye(4)
        T[:3, 3] = sensor
        out.append((pts - sensor, T))
    return out


def test_tsdf_matches_jax():
    views = _sphere_views(np.random.default_rng(0))
    jp = jtsdf.TsdfParams(voxel=8.0, truncation=24.0)
    jv = jtsdf.TsdfVolume.for_bounds(np.full(3, -140.0), np.full(3, 140.0), jp)
    tv = ttsdf.TsdfVolume.for_bounds(np.full(3, -140.0), np.full(3, 140.0),
                                     interop.tsdf_params_from(vars(jp)), device="cpu")
    assert tv.dims == jv.dims and np.array_equal(tv.origin, jv.origin)
    for local, T in views[:3]:
        jv.integrate(local, T)
        tv.integrate(local, T)
    np.testing.assert_allclose(tv.tsdf.numpy(), np.asarray(jv.tsdf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.weight.numpy(), np.asarray(jv.weight), rtol=0, atol=1e-5)
    # carry the JAX volume across and fuse the other views in both
    cv = interop.tsdf_volume_from_numpy(dict(
        params=vars(jv.params), origin=jv.origin, dims=jv.dims,
        tsdf=np.asarray(jv.tsdf), weight=np.asarray(jv.weight)))
    for local, T in views[3:]:
        jv.integrate(local, T)
        cv.integrate(local, T)
    np.testing.assert_allclose(cv.tsdf.numpy(), np.asarray(jv.tsdf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cv.weight.numpy(), np.asarray(jv.weight), rtol=0, atol=1e-5)
    want, got = jv.extract_mesh(), cv.extract_mesh()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)
    assert abs(np.median(np.linalg.norm(got[0], axis=1)) - 100.0) < 8.0


def _sphere_cloud(seed=0, R=80.0):
    d = np.random.default_rng(seed).normal(size=(6000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return R * d + np.array([300.0, 50.0, -200.0]), d


def test_imls_field_matches_jax():
    pts, nrm = _sphere_cloud()
    kw = dict(voxel=10.0, k=12)
    jf, jvalid, jo, jvox = jmesh.imls_field(pts, nrm, jmesh.MeshParams(**kw))
    tf, tvalid, to, tvox = tmesh.imls_field(pts, nrm, interop.mesh_params_from(kw), device="cpu")
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    np.testing.assert_array_equal(to, jo)
    assert tvox == jvox and jvalid.sum() > 1000


def test_poisson_field_matches_jax():
    pts, nrm = _sphere_cloud(1)
    kw = dict(grid=64)
    jchi, jocc, jo, jvox = jmesh.poisson_field(pts, nrm, jmesh.PoissonParams(**kw))
    tchi, tocc, to, tvox = tmesh.poisson_field(pts, nrm, interop.poisson_params_from(kw),
                                               device="cpu")
    np.testing.assert_allclose(tchi.numpy(), jchi, rtol=0, atol=1e-4 * np.abs(jchi).max())
    np.testing.assert_array_equal(tocc.numpy(), jocc)
    np.testing.assert_array_equal(to, jo)
    assert tvox == jvox


def _read_obj(path):
    v, f = [], []
    with open(path) as fh:
        for line in fh:
            tag, *rest = line.split()
            (v if tag == "v" else f).append([float(x) if tag == "v" else int(x) for x in rest])
    return np.array(v), np.array(f) - 1


def _read_ply(path):
    data = open(path, "rb").read()
    head, body = data.split(b"end_header\n", 1)
    nv = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    nf = int(head.split(b"element face ")[1].split(b"\n")[0])
    v = np.frombuffer(body[: 12 * nv], "<f4").reshape(nv, 3)
    f = np.frombuffer(body[12 * nv:], np.dtype([("n", "u1"), ("i", "<i4", 3)]), count=nf)
    assert (f["n"] == 3).all()
    return v.astype(np.float64), f["i"]


@pytest.fixture(scope="module")
def recon_dir(tmp_path_factory):
    """Three scans of a 4 x 4 m bumpy terrain patch (y = 30 sin(x/70)
    cos(z/90) cm, 1 cm noise) from sensors 2 m above it, with their true
    poses as .frames.  Its normals face the viewpoint both packages
    orient them to (far above the cloud); on vertical surfaces that
    orientation is a coin toss in either package."""
    from tpu3dtk_torch.core import math3d
    from tpu3dtk_torch.io import frames as frames_io

    rng = np.random.default_rng(4)
    d = str(tmp_path_factory.mktemp("recon") / "scans")
    locals_, poses = [], []
    for k in range(3):
        xz = rng.uniform(-200, 200, (1500, 2))
        world = np.stack([xz[:, 0], 30 * np.sin(xz[:, 0] / 70) * np.cos(xz[:, 1] / 90),
                          xz[:, 1]], 1) + rng.normal(0, 1.0, (1500, 3))
        T = np.asarray(math3d.euler_to_matrix4(np.array([40.0 * k, 200.0, -30.0 * k]),
                                               np.array([0.0, 0.2 * k, 0.0]), xp=np))
        locals_.append(np.asarray(math3d.transform3(np.linalg.inv(T), world)).astype(np.float32))
        poses.append(T)
    idents = synth.write_scan_dir(d, locals_, poses)
    for i, T in zip(idents, poses):
        frames_io.write_frames(frames_io.frames_path(d, i), T[None], [1])
    return d


@pytest.mark.parametrize("ext", ["obj", "ply"])
@pytest.mark.parametrize("method,flags,voxel", [
    ("tsdf", ["--voxel", "20"], 20.0),
    ("imls", ["--voxel", "10", "-K", "8"], 10.0),
    ("poisson", [], None),
])
def test_cli_matches_jax_cli(recon_dir, tmp_path, method, flags, voxel, ext):
    from tpu3dtk.cli import recon as jcli
    from tpu3dtk_torch.cli import recon as tcli

    read = _read_obj if ext == "obj" else _read_ply
    meshes = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.{ext}")
        assert cli.main([recon_dir, "--method", method, *flags, "-q", "-o", out, *extra]) == 0
        meshes[name] = read(out)
    (tv, tf), (jv, jf) = meshes["torch"], meshes["jax"]
    if method == "tsdf":
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-9)
        return
    if voxel is None:  # poisson: the voxel of its 128^3 grid
        span = (jv.max(0) - jv.min(0)).max()
        voxel = span / 127.0
    assert abs(len(tv) - len(jv)) <= 0.01 * len(jv) and abs(len(tf) - len(jf)) <= 0.01 * len(jf)
    d, _ = cKDTree(jv).query(tv)
    assert (d <= 1e-3 * voxel).mean() >= 0.99, np.quantile(d, [0.5, 0.99, 1.0])
