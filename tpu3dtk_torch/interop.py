"""Carry scan, cell-list, correspondence-cache and parameter state
across from the JAX package as plain numpy.

:func:`scans_from_numpy` builds the port's :class:`~.core.scan.Scan`
objects from what a ``tpu3dtk`` ``TPUScan`` holds — identifier, raw xyz,
reduced local points and their normals, the three pose matrices and the
frames log — and
an :class:`~.models.icp.IcpParams` from the JAX ``IcpParams`` fields.
It imports neither ``jax`` nor ``tpu3dtk``: callers pass numpy arrays, e.g.
``{"identifier": s.identifier, "xyz": s.xyz, "reduced_local":
s.reduced_local(), "transMatOrg": s.transMatOrg, ...}``.  Feeding the
JAX package's reduced points lets both packages register the same
points (random reduction cannot match bit for bit across them).

With ``cell_list`` it also carries the chained NN engine's state: a
``tpu3dtk.ops.nn_pallas.CellListModel`` and a ``cell_list_spec`` dict,
their fields given as numpy arrays, become the port's
:class:`~.ops.nn_cell_list.CellListModel` and spec.

:func:`corr_cache_from_numpy` rebuilds a ``lum_device.CorrCache`` (slot
table, relative poses, the resident idx/found rows) so both packages can
start from one cache state; :func:`lum_params_from`,
:func:`elch_params_from`, :func:`graph_pipeline_from`,
:func:`subgraph_params_from`, :func:`srr_params_from`,
:func:`hough_params_from` and :func:`preg_params_from` map the JAX
dataclasses' fields (given as a dict, e.g. ``vars(p)``) onto the port's,
dropping the fields that only exist for XLA (shape buckets, hashed
grids, meshes, the segmented loop) and refusing unknown ones;
:func:`line_scan_set_from_numpy` rebuilds an ``srr.LineScanSet``;
:func:`planes_from_numpy` rebuilds ``shapes.Plane`` lists.

Slice 9's models: :func:`fh_params_from`, :func:`velo_params_from`
(``pad_multiple`` dropped: the port uploads clouds unpadded),
:func:`tracker_params_from`, :func:`tsdf_params_from`,
:func:`mesh_params_from`, :func:`poisson_params_from`,
:func:`people_remover_params_from` and :func:`collision_params_from`
(``chunk`` dropped) map the dataclasses; :func:`tracker_from_numpy` rebuilds a
``tracking.MultiObjectTracker`` with its tracks and
:func:`tsdf_volume_from_numpy` a ``tsdf.TsdfVolume`` with its volumes.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

import torch

from .core.scan import Scan
from .models.icp import IcpParams
from .ops.nn_cell_list import CellListModel

__all__ = [
    "camera_from_numpy", "collision_params_from", "corr_cache_from_numpy",
    "cylinder_params_from", "elch_params_from", "fbr_params_from", "fh_params_from",
    "floorplan_params_from", "fusion_params_from", "graph_pipeline_from",
    "grid2d_params_from", "hough_params_from", "occupancy_grid_from_numpy",
    "line_scan_set_from_numpy", "lum_params_from", "mesh_params_from",
    "people_remover_params_from", "planes_from_numpy", "poisson_params_from",
    "preg_params_from", "scans_from_numpy", "srr_params_from",
    "subgraph_params_from", "tracker_from_numpy", "tracker_params_from",
    "tsdf_params_from", "tsdf_volume_from_numpy", "velo_params_from",
]

# fields of the JAX dataclasses with no counterpart in the port
_LUM_DROPPED = (
    "pad_multiple", "link_chunk", "nns", "grid_min_points", "grid_max_cap",
    "mesh", "scan_cap", "point_cap", "link_cap_min",
    "grid", "device_points", "corr_cache", "device_max_scans",
)
_ELCH_DROPPED = ("pad_multiple", "scan_cap", "link_cap_min", "device_points", "corr_cache")
_PIPE_DROPPED = ("seq_mesh", "lum_mesh", "device_segments")


def _carried(fields: Mapping, dropped) -> dict:
    return {k: v for k, v in fields.items() if k not in dropped and not k.startswith("_")}


def lum_params_from(fields: Mapping, device="cpu"):
    """The port's ``LumParams`` from a JAX ``LumParams``' fields.  The
    resident tensors and the cache do not cross as fields: upload the
    points anew and use :func:`corr_cache_from_numpy`."""
    from .models.graphslam import LumParams

    return LumParams(device=device, **_carried(fields, _LUM_DROPPED))


def elch_params_from(fields: Mapping, device="cpu"):
    from .models.elch import ElchParams

    return ElchParams(device=device, **_carried(fields, _ELCH_DROPPED))


def graph_pipeline_from(fields: Mapping, device="cpu"):
    """The port's ``GraphPipeline`` from a JAX ``GraphPipeline``'s
    fields (``icp_params`` as the JAX ``IcpParams``' ``_asdict()``)."""
    from .models.graph_pipeline import GraphPipeline

    kw = _carried(fields, _PIPE_DROPPED)
    if "icp_params" in kw:
        icp = kw["icp_params"]
        kw["icp_params"] = IcpParams(**dict(icp._asdict() if hasattr(icp, "_asdict") else icp))
    return GraphPipeline(device=device, **kw)


def subgraph_params_from(fields: Mapping):
    """The port's ``subgraph.SubgraphParams`` from a JAX one's fields
    (every field has its counterpart)."""
    from .models.subgraph import SubgraphParams

    return SubgraphParams(**_carried(fields, ()))


def srr_params_from(fields: Mapping):
    """The port's ``srr.SrrParams`` from a JAX one's fields."""
    from .models.srr import SrrParams

    return SrrParams(**_carried(fields, ()))


def hough_params_from(fields: Mapping):
    """The port's ``shapes.HoughParams`` from a JAX one's fields."""
    from .models.shapes import HoughParams

    return HoughParams(**_carried(fields, ()))


def preg_params_from(fields: Mapping):
    """The port's ``preg6d.PregParams`` from a JAX one's fields."""
    from .models.preg6d import PregParams

    return PregParams(**_carried(fields, ()))


def fh_params_from(fields: Mapping):
    """The port's ``segmentation.FHParams`` from a JAX one's fields."""
    from .models.segmentation import FHParams

    return FHParams(**_carried(fields, ()))


def velo_params_from(fields: Mapping):
    """The port's ``veloslam.VeloParams`` from a JAX one's fields; the JAX
    package's ``pad_multiple`` has no counterpart (no padding here)."""
    from .models.veloslam import VeloParams

    return VeloParams(**_carried(fields, ("pad_multiple",)))


def tracker_params_from(fields: Mapping):
    """The port's ``tracking.TrackerParams`` from a JAX one's fields."""
    from .models.tracking import TrackerParams

    return TrackerParams(**_carried(fields, ()))


def tsdf_params_from(fields: Mapping):
    """The port's ``tsdf.TsdfParams`` from a JAX one's fields."""
    from .models.tsdf import TsdfParams

    return TsdfParams(**_carried(fields, ()))


def mesh_params_from(fields: Mapping):
    """The port's ``mesh.MeshParams`` from a JAX one's fields."""
    from .models.mesh import MeshParams

    return MeshParams(**_carried(fields, ()))


def poisson_params_from(fields: Mapping):
    """The port's ``mesh.PoissonParams`` from a JAX one's fields."""
    from .models.mesh import PoissonParams

    return PoissonParams(**_carried(fields, ()))


def people_remover_params_from(fields: Mapping):
    """The port's ``peopleremover.PeopleRemoverParams`` from a JAX one's
    fields."""
    from .models.peopleremover import PeopleRemoverParams

    return PeopleRemoverParams(**_carried(fields, ()))


def collision_params_from(fields: Mapping):
    """The port's ``collision.CollisionParams`` from a JAX one's fields; the
    JAX package's ``chunk`` (poses a ``lax.map`` step) has no counterpart:
    one K1 call a pose."""
    from .models.collision import CollisionParams

    return CollisionParams(**_carried(fields, ("chunk",)))


def grid2d_params_from(fields: Mapping):
    """The port's ``grid2d.Grid2DParams`` from a JAX one's fields."""
    from .models.grid2d import Grid2DParams

    return Grid2DParams(**_carried(fields, ()))


def occupancy_grid_from_numpy(state: Mapping):
    """A ``grid2d.OccupancyGrid`` from a JAX one's fields: ``origin`` [2]
    f64, ``resolution``, ``hits`` and ``visits`` [W,H] int32."""
    from .models.grid2d import OccupancyGrid

    return OccupancyGrid(
        origin=np.array(state["origin"], dtype=np.float64),
        resolution=float(state["resolution"]),
        hits=np.array(state["hits"], dtype=np.int32),
        visits=np.array(state["visits"], dtype=np.int32),
    )


def floorplan_params_from(fields: Mapping):
    """The port's ``floorplan.FloorplanParams`` from a JAX one's fields."""
    from .models.floorplan import FloorplanParams

    return FloorplanParams(**_carried(fields, ()))


def cylinder_params_from(fields: Mapping):
    """The port's ``cylinder.CylinderParams`` from a JAX one's fields."""
    from .models.cylinder import CylinderParams

    return CylinderParams(**_carried(fields, ()))


def fusion_params_from(fields: Mapping):
    """The port's ``curvefusion.FusionParams`` from a JAX one's fields."""
    from .models.curvefusion import FusionParams

    return FusionParams(**_carried(fields, ()))


def camera_from_numpy(state: Mapping):
    """A ``thermo.Camera`` from a JAX one's fields: the intrinsics,
    ``width``/``height``, ``dist`` (k1, k2, p1, p2, k3), ``R`` [3,3] and
    ``t`` [3] as numpy."""
    from .models.thermo import Camera

    return Camera(
        fx=float(state["fx"]), fy=float(state["fy"]), cx=float(state["cx"]),
        cy=float(state["cy"]), width=int(state["width"]), height=int(state["height"]),
        dist=tuple(float(v) for v in state.get("dist", (0.0,) * 5)),
        R=np.array(state.get("R", np.eye(3)), dtype=np.float64),
        t=np.array(state.get("t", np.zeros(3)), dtype=np.float64),
    )


def fbr_params_from(fields: Mapping):
    """The port's ``fbr.FbrParams`` from a JAX one's fields; ``panorama``
    (a JAX ``PanoramaParams`` or its fields) becomes the port's."""
    from .models.fbr import FbrParams
    from .ops.panorama import PanoramaParams

    kw = _carried(fields, ())
    if "panorama" in kw:
        pano = kw["panorama"]
        kw["panorama"] = PanoramaParams(**_carried(pano if isinstance(pano, Mapping) else vars(pano), ()))
    return FbrParams(**kw)


def tracker_from_numpy(state: Mapping, device="cpu"):
    """A ``tracking.MultiObjectTracker`` in the state of a JAX one:
    ``params`` (the ``TrackerParams`` fields), ``dt``, ``next_id`` and
    ``tracks``, a list of mappings of a ``Track``'s fields (``track_id``,
    ``x`` [6], ``P`` [6,6], ``hits``, ``misses``, ``start_pos`` [3],
    ``bbox``) as numpy."""
    from .models.tracking import MultiObjectTracker, Track

    trk = MultiObjectTracker(
        tracker_params_from(state["params"]), dt=float(state.get("dt", 1.0)), device=device
    )
    trk.tracks = [
        Track(
            track_id=int(t["track_id"]), x=np.array(t["x"], dtype=np.float64),
            P=np.array(t["P"], dtype=np.float64), hits=int(t["hits"]), misses=int(t["misses"]),
            start_pos=None if t.get("start_pos") is None
            else np.array(t["start_pos"], dtype=np.float64),
            bbox=t.get("bbox"),
        )
        for t in state["tracks"]
    ]
    trk._next_id = int(state["next_id"])
    return trk


def tsdf_volume_from_numpy(state: Mapping, device="cpu"):
    """A ``tsdf.TsdfVolume`` in the state of a JAX one: ``params`` (the
    ``TsdfParams`` fields), ``origin`` [3], ``dims`` and the ``tsdf`` /
    ``weight`` [X,Y,Z] f32 volumes as numpy, put on ``device``."""
    from .models.tsdf import TsdfVolume

    vol = TsdfVolume(state["origin"], state["dims"], tsdf_params_from(state["params"]),
                     device=device)
    vol.tsdf = torch.as_tensor(np.array(state["tsdf"], dtype=np.float32), device=vol.device)
    vol.weight = torch.as_tensor(np.array(state["weight"], dtype=np.float32), device=vol.device)
    return vol


def planes_from_numpy(planes: Iterable[Mapping]):
    """``shapes.Plane`` objects from mappings of a JAX ``Plane``'s fields
    (``normal`` [3], ``rho``, ``n_inliers``, ``center`` [3]), e.g.
    ``vars(p)``."""
    from .models.shapes import Plane

    return [
        Plane(
            normal=np.array(p["normal"], dtype=np.float64), rho=float(p["rho"]),
            n_inliers=int(p["n_inliers"]), center=np.array(p["center"], dtype=np.float64),
        )
        for p in planes
    ]


def line_scan_set_from_numpy(state: Mapping):
    """An ``srr.LineScanSet`` in the state of a JAX one: ``points`` [L,P,3],
    ``masks`` [L,P], ``poses`` and ``poses_org`` [L,4,4] and optionally
    ``frames`` (list of ([L,4,4], AlgoType int)), as numpy."""
    from .models.srr import LineScanSet

    return LineScanSet(
        points=np.array(state["points"], dtype=np.float32),
        masks=np.array(state["masks"], dtype=bool),
        poses=np.array(state["poses"], dtype=np.float64),
        poses_org=np.array(state["poses_org"], dtype=np.float64),
        frames=[(np.array(m, dtype=np.float64), int(t)) for m, t in state.get("frames", ())],
    )


def corr_cache_from_numpy(state: Mapping, device="cpu"):
    """A ``lum_device.CorrCache`` in the state of a JAX one.  ``state``:
    ``N``, ``tol_t``, ``tol_r``, ``slot_cap_min``, ``slots`` (link ->
    slot), ``L``, ``n_refresh``, ``n_reuse`` and, once L > 0, ``idx``
    [L,N] int32, ``found`` [L,N] bool, ``rel`` [L,4,4] f64 as numpy."""
    import heapq

    from .models.lum_device import CorrCache

    c = CorrCache(
        int(state["N"]), tol_t=state["tol_t"], tol_r=state["tol_r"],
        slot_cap_min=state["slot_cap_min"], device=device,
    )
    c.slots = {tuple(int(v) for v in k): int(sl) for k, sl in state["slots"].items()}
    c.L = int(state["L"])
    c.n_refresh, c.n_reuse = int(state["n_refresh"]), int(state["n_reuse"])
    if c.L:
        c.idx = torch.as_tensor(np.array(state["idx"], np.int32), device=device)
        c.found = torch.as_tensor(np.array(state["found"], bool), device=device)
        c.rel = np.array(state["rel"], np.float64)
    c._free = sorted(set(range(c.L)) - set(c.slots.values()))
    heapq.heapify(c._free)
    return c


def _cell_list_from_numpy(state: Mapping, device) -> tuple[CellListModel, dict]:
    """``state``: {"clm": the JAX CellListModel's fields as numpy
    (``model_sorted`` in its [8, Mpad] transposed layout), "spec": the
    JAX cell_list_spec dict}.  Returns the port's model on ``device``
    and spec: the sorted coordinates as [max(M, 1), 4], the rows
    ``build_cell_list_model`` makes (the JAX package's pad rows, which
    no range reaches, are dropped)."""
    c = state["clm"]
    ms = np.asarray(c["model_sorted"], np.float32)
    M = len(c["msrc"])
    ms4 = np.zeros((max(M, 1), 4), np.float32)
    ms4[:M, :3] = ms[:3, :M].T

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    clm = CellListModel(
        points=t(c["points"], np.float32),
        mmask=t(c["mmask"], bool),
        model_sorted=t(ms4, np.float32),
        msrc=t(c["msrc"], np.int32),
        cell_start=t(c["cell_start"], np.int32),
        origin=t(c["origin"], np.float32),
        cell=float(np.float32(c["cell"])),
    )
    spec = dict(state["spec"])
    spec["origin"] = np.asarray(spec["origin"], np.float32)
    spec["dims"] = tuple(int(d) for d in spec["dims"])
    spec["perm"] = tuple(int(p) for p in spec.get("perm", (0, 1, 2)))
    return clm, spec


def scans_from_numpy(
    scans: Iterable[Mapping], icp_params: Mapping | None = None,
    cell_list: Mapping | None = None, device="cpu",
):
    """Build Scans from mappings with keys ``identifier``, ``xyz``
    ([N,3]) and optionally ``reduced_local`` ([Nr,3]), ``transMatOrg``,
    ``transMat``, ``dalignxf`` ([4,4]), ``frames`` (list of (4x4,
    AlgoType int)), ``reduction_voxel``, ``reduction_nrpts``.  Missing
    poses default to the identity (``transMat`` to ``transMatOrg``).
    ``icp_params``: the JAX ``IcpParams`` fields as a dict; unknown
    fields raise.  Returns (scans, params), and with ``cell_list``
    ({"clm": ..., "spec": ...}, see the module docstring) (scans, params,
    clm, spec) with the cell-list model's tensors on ``device``."""
    out = []
    for d in scans:
        org = np.array(d.get("transMatOrg", np.eye(4)), dtype=np.float64)
        s = Scan(
            identifier=str(d["identifier"]),
            channels={"xyz": np.array(d["xyz"], dtype=np.float64)},
            transMatOrg=org,
            transMat=np.array(d.get("transMat", org), dtype=np.float64),
            dalignxf=np.array(d.get("dalignxf", np.eye(4)), dtype=np.float64),
            frames=[
                (np.array(m, dtype=np.float64), int(t))
                for m, t in d.get("frames", ())
            ],
            reduction_voxel=float(d.get("reduction_voxel", 0.0)),
            reduction_nrpts=int(d.get("reduction_nrpts", 0)),
        )
        if d.get("reduced_local") is not None:
            s._reduced_local = np.array(d["reduced_local"], dtype=np.float64)
        if d.get("normal reduced") is not None:
            s.channels["normal reduced"] = np.array(d["normal reduced"], dtype=np.float64)
        out.append(s)
    params = IcpParams(**dict(icp_params or {}))
    if cell_list is None:
        return out, params
    return (out, params, *_cell_list_from_numpy(cell_list, device))
