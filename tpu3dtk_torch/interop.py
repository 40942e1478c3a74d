"""Carry scan state across from the JAX package as plain numpy.

:func:`scans_from_numpy` builds the port's :class:`~.core.scan.Scan`
objects from what a ``tpu3dtk`` ``TPUScan`` holds — identifier, raw xyz,
reduced local points, the three pose matrices and the frames log — and
an :class:`~.models.icp.IcpParams` from the JAX ``IcpParams`` fields.
It imports neither ``jax`` nor ``tpu3dtk``: callers pass numpy arrays, e.g.
``{"identifier": s.identifier, "xyz": s.xyz, "reduced_local":
s.reduced_local(), "transMatOrg": s.transMatOrg, ...}``.  Feeding the
JAX package's reduced points lets both packages register the same
points (random reduction cannot match bit for bit across them).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from .core.scan import Scan
from .models.icp import IcpParams

__all__ = ["scans_from_numpy"]


def scans_from_numpy(
    scans: Iterable[Mapping], icp_params: Mapping | None = None
) -> tuple[list[Scan], IcpParams]:
    """Build Scans from mappings with keys ``identifier``, ``xyz``
    ([N,3]) and optionally ``reduced_local`` ([Nr,3]), ``transMatOrg``,
    ``transMat``, ``dalignxf`` ([4,4]), ``frames`` (list of (4x4,
    AlgoType int)), ``reduction_voxel``, ``reduction_nrpts``.  Missing
    poses default to the identity (``transMat`` to ``transMatOrg``).
    ``icp_params``: the JAX ``IcpParams`` fields as a dict; unknown
    fields raise."""
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
    return out, params
