"""Carry scan, cell-list, correspondence-cache and parameter state
across from the JAX package as plain numpy.

:func:`scans_from_numpy` builds the port's :class:`~.core.scan.Scan`
objects from what a ``tpu3dtk`` ``TPUScan`` holds — identifier, raw xyz,
reduced local points, the three pose matrices and the frames log — and
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
:func:`elch_params_from` and :func:`graph_pipeline_from` map the JAX
dataclasses' fields (given as a dict, e.g. ``vars(p)``) onto the port's,
dropping the fields that only exist for XLA (shape buckets, hashed
grids, meshes, the segmented loop) and refusing unknown ones.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

import torch

from .core.scan import Scan
from .models.icp import IcpParams
from .ops.nn_cell_list import CellListModel

__all__ = [
    "corr_cache_from_numpy", "elch_params_from", "graph_pipeline_from",
    "lum_params_from", "scans_from_numpy",
]

# fields of the JAX dataclasses with no counterpart in the port
_LUM_DROPPED = (
    "pad_multiple", "link_chunk", "nns", "grid_min_points", "grid_max_cap",
    "dense_solver_max_scans", "mesh", "scan_cap", "point_cap", "link_cap_min",
    "grid", "device_points", "corr_cache",
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
    (sorted coordinates as [Mpad, 4]) and spec."""
    c = state["clm"]
    ms = np.asarray(c["model_sorted"], np.float32)
    ms4 = np.zeros((ms.shape[1], 4), np.float32)
    ms4[:, :3] = ms[:3].T

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
        out.append(s)
    params = IcpParams(**dict(icp_params or {}))
    if cell_list is None:
        return out, params
    return (out, params, *_cell_list_from_numpy(cell_list, device))
