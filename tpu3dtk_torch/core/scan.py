"""Scan abstraction — the port of ``tpu3dtk.core.scan.TPUScan`` (the
reference's ``Scan``/``BasicScan``, include/slam6d/scan.h:124-531,
src/slam6d/scan.cc, basicScan.cc).

As in the JAX package, points are immutable: reduced points stay in the
scan's *local* frame and the global view is ``transMat @ local``.  Pose
state mirrors the reference: ``transMatOrg`` (initial pose from .pose),
``transMat`` (current), ``dalignxf`` (delta with transMat = dalignxf @
transMatOrg).  Pose math stays f64 numpy on the host; the frames log is
the append-only AlgoType-tagged pose history written to ``.frames``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..io.frames import AlgoType
from ..io.scandir import RawScan
from ..ops import reduction as red_ops
from ..utils.metrics import REDUCTION, metrics
from . import math3d

__all__ = ["Scan"]

NORMALS_TIME = "normals_time"  # metrics timer: reduced_normals_local, per scan


@dataclasses.dataclass
class Scan:
    identifier: str
    channels: dict[str, np.ndarray]  # local frame
    transMatOrg: np.ndarray  # [4,4] initial pose (from .pose)
    transMat: np.ndarray  # [4,4] current pose
    dalignxf: np.ndarray  # [4,4] delta: transMat = dalignxf @ transMatOrg
    frames: list[tuple[np.ndarray, int]] = dataclasses.field(default_factory=list)
    reduction_voxel: float = 0.0
    reduction_nrpts: int = 0
    # device the reduction runs on (None: the package default)
    device: Optional[str] = None
    _reduced_local: Optional[np.ndarray] = None
    # monotone content generation: bumped whenever the reduced point set
    # changes, so drivers can key resident-tensor caches on
    # (identifier, generation)
    generation: int = 0

    # -- construction -----------------------------------------------------
    @classmethod
    def from_raw(cls, raw: RawScan, device: Optional[str] = None) -> "Scan":
        T = np.asarray(math3d.pose_to_matrix(raw.pose_pos, np.rad2deg(raw.pose_theta)))
        return cls(
            identifier=raw.identifier,
            channels=dict(raw.channels),
            transMatOrg=T,
            transMat=T.copy(),
            dalignxf=np.eye(4),
            device=device,
        )

    @classmethod
    def from_points(
        cls, xyz: np.ndarray, identifier: str = "000", pose: np.ndarray | None = None
    ) -> "Scan":
        T = np.eye(4) if pose is None else np.asarray(pose, dtype=np.float64)
        return cls(
            identifier=identifier,
            channels={"xyz": np.asarray(xyz, dtype=np.float64)},
            transMatOrg=T,
            transMat=T.copy(),
            dalignxf=np.eye(4),
        )

    # -- pose state -------------------------------------------------------
    @property
    def rPos(self) -> np.ndarray:
        _, pos = math3d.matrix4_to_euler(self.transMat)
        return np.asarray(pos)

    @property
    def rPosTheta(self) -> np.ndarray:
        theta, _ = math3d.matrix4_to_euler(self.transMat)
        return np.asarray(theta)

    def set_reduction(self, voxel: float, nrpts: int) -> None:
        """Ref Scan::setReductionParameter (-r voxel, -O nrpts)."""
        if voxel != self.reduction_voxel or nrpts != self.reduction_nrpts:
            self._reduced_local = None
            self.channels.pop("normal reduced", None)
            self.generation += 1
        self.reduction_voxel = voxel
        self.reduction_nrpts = nrpts

    def load_reduced(self, points: np.ndarray) -> None:
        """Take ``points`` [N,3] (local frame) as the reduced points, as
        ``--loadOct`` does with a saved octree: ``reduced_local()``
        returns them and never reduces the raw points, and callers see a
        new ``generation`` and upload them anew to their device."""
        self._reduced_local = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        self.channels.pop("normal reduced", None)
        self.generation += 1

    # -- channels ---------------------------------------------------------
    @property
    def xyz(self) -> np.ndarray:
        return self.channels["xyz"]

    @property
    def size(self) -> int:
        return len(self.channels["xyz"])

    def reduced_local(self, seed: int = 0) -> np.ndarray:
        """Reduced points in the scan's local frame, f64 numpy (ref
        calcReducedPoints, scan.cc:432-687: reduction runs on
        untransformed points; the global transform is deferred).  The
        reduction itself is timed as ``on_demand_reduction_time``; it
        ends in a host array, so the timer ends synced."""
        if self._reduced_local is None:
            with metrics.time(REDUCTION):
                self._reduced_local = red_ops.reduce_scan(
                    self.xyz.astype(np.float32),
                    self.reduction_voxel,
                    self.reduction_nrpts,
                    seed=seed,
                    device=self.device,
                ).astype(np.float64)
        return self._reduced_local

    def reduced_normals_local(self, k: int = 20) -> np.ndarray:
        """Unit normals of the reduced points in the local frame, facing
        the scanner origin (ref calculateNormalsKNN, normals.cc:220-440;
        the 'normal reduced' channel), computed on the scan's device and
        cached as f64 numpy."""
        if "normal reduced" not in self.channels:
            from ..ops import normals as normals_ops

            r = self.reduced_local().astype(np.float32)
            with metrics.time(NORMALS_TIME):
                n = normals_ops.estimate_normals_knn(
                    r, np.ones(len(r), bool), np.zeros(3, np.float32), k=k,
                    device=self.device,
                )
                self.channels["normal reduced"] = n.cpu().numpy().astype(np.float64)
        return self.channels["normal reduced"]

    def reduced_normals_padded(self, cap: int) -> np.ndarray:
        """:meth:`reduced_normals_local` zero-padded to [cap, 3] f32."""
        n = self.reduced_normals_local()
        out = np.zeros((cap, 3), dtype=np.float32)
        out[: len(n)] = n
        return out

    # -- transforms & frames ---------------------------------------------
    def transform(self, align: np.ndarray, algo: AlgoType, record: bool = True) -> None:
        """Left-apply an alignment (ref Scan::transformMatrix,
        scan.cc:878-898): transMat <- align @ transMat, dalignxf <- align
        @ dalignxf."""
        align = np.asarray(align, dtype=np.float64)
        self.transMat = align @ self.transMat
        self.dalignxf = align @ self.dalignxf
        if record:
            self.add_frame(algo)

    def set_pose(self, T: np.ndarray, algo: AlgoType, record: bool = True) -> None:
        """Set absolute pose (equivalent to transform with T @ inv(transMat))."""
        T = np.asarray(T, dtype=np.float64)
        self.dalignxf = T @ np.asarray(math3d.m4inv(self.transMat)) @ self.dalignxf
        self.transMat = T
        if record:
            self.add_frame(algo)

    def add_frame(self, algo: AlgoType) -> None:
        self.frames.append((self.transMat.copy(), int(algo)))

    # -- global views -----------------------------------------------------
    def points_global(self) -> np.ndarray:
        return np.asarray(math3d.transform3(self.transMat, self.xyz))

    def reduced_global(self) -> np.ndarray:
        return np.asarray(math3d.transform3(self.transMat, self.reduced_local()))
