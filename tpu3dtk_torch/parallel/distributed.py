"""Multi-process execution — the port of ``tpu3dtk.parallel.distributed``
on ``torch.distributed`` (SURVEY §2.8 "Distributed communication
backend").

The reference has no multi-node path at all (its only cross-process
channel is the scanserver's shared memory, include/scanserver/
clientInterface.h:15-84).  The model is the JAX package's:

- Every process runs the same program and calls :func:`initialize`
  first; it reads the JAX package's launch environment (JAX_COORDINATOR,
  NPROC, PROC_ID), so a launch recipe carries over, and joins the
  process group at ``tcp://<coordinator>``.
- Scan ingest is split by process: each reads and reduces only its
  contiguous range of the sequence (:func:`host_scan_range`,
  :func:`distributed_ingest`), and the reduced points are exchanged.
- The sums of a sharded path (the LUM link statistics, the ICP pair
  statistics) are taken by ``all_reduce`` over the group
  (:func:`host_device_mesh`).

The backend follows from the device, and :func:`initialize` prints it:
``nccl`` when every process on a host has a card of its own; ``gloo`` on
the CPU and when processes share a card (NCCL refuses two ranks on one
card; gloo's ``all_reduce`` takes CUDA tensors).  Under either backend a
process computes on its host's card ``local rank`` modulo the cards
there.  The processes on a host and a process's rank among them are
LOCAL_WORLD_SIZE and LOCAL_RANK where the launcher sets them (torchrun
does), else one host runs all NPROC processes (:func:`local_layout`).  A
failed initialisation raises; no other backend is tried.

Launch recipe (2 processes):

    JAX_COORDINATOR=localhost:8476 NPROC=2 PROC_ID=0 torchslam --distributed ... &
    JAX_COORDINATOR=localhost:8476 NPROC=2 PROC_ID=1 torchslam --distributed ...

Without NPROC (or with NPROC=1) :func:`initialize` does nothing and every
helper behaves as a world of one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import allsum, comm_device, default_points_mesh, rank_range

__all__ = [
    "allsum_hosts",
    "backend_for",
    "distributed_ingest",
    "global_scan_array",
    "host_device_mesh",
    "host_scan_range",
    "initialize",
    "is_distributed",
    "local_layout",
    "rank_device",
]


def local_layout(num_processes: int, process_id: int) -> tuple[int, int]:
    """(this process's rank among the processes on its host, their
    number): LOCAL_RANK and LOCAL_WORLD_SIZE where set, else one host
    holding all ``num_processes``."""
    size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return int(os.environ.get("LOCAL_RANK", process_id % size)), size


def backend_for(device, local_processes: int, n_cards: int | None = None) -> str:
    """``nccl`` when ``device`` is a CUDA device and the host has a card
    (``n_cards``, default: the cards present) for each of its
    ``local_processes``, else ``gloo``."""
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    if torch.device(device).type == "cuda" and n_cards >= local_processes:
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cpu",
) -> bool:
    """Join the multi-process job (``torch.distributed.init_process_group``
    on ``tcp://<coordinator>``).

    Arguments default to the environment variables JAX_COORDINATOR
    (localhost:8476), NPROC (1) and PROC_ID (0).  ``device`` is where
    this process computes and, with :func:`local_layout`, decides the
    backend (:func:`backend_for`); on a card it sets this process's
    card.  Returns True when running distributed, False for the
    one-process no-op.  Safe to call more than once."""
    import torch.distributed as dist

    num_processes = num_processes or int(os.environ.get("NPROC", "1"))
    if num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR", "localhost:8476"
    )
    if process_id is None:
        process_id = int(os.environ.get("PROC_ID", "0"))
    local_rank, local_size = local_layout(num_processes, process_id)
    backend = backend_for(device, local_size)
    card = ""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        card = f", card {torch.cuda.current_device()}"
    print(
        f"torch.distributed: process {process_id} of {num_processes}, backend "
        f"{backend}{card}, coordinator {coordinator_address}", flush=True,
    )
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return True


def rank_device(device) -> torch.device:
    """The device this process computes on: ``device``, with a CUDA
    device narrowed to the card :func:`initialize` set for this process."""
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def is_distributed() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_scan_range(n_scans: int, n_hosts: int | None = None,
                    host_id: int | None = None) -> tuple[int, int]:
    """This process's contiguous ingest range [lo, hi) of the scan
    sequence (processes own scan ranges; the scanserver role)."""
    size, rank = _world()
    n_hosts = n_hosts or size
    host_id = host_id if host_id is not None else rank
    return rank_range(n_scans, n_hosts, host_id)


def host_device_mesh():
    """The process group the sharded paths sum over: every process of
    the job, or None in a world of one (the unsharded path).  One process
    drives one card (or a share of one), so the JAX package's hosts x
    devices mesh is one axis here."""
    return default_points_mesh()


def allsum_hosts(mesh, local_block: np.ndarray) -> np.ndarray:
    """Sum each process's contribution into an array every process gets
    (one ``all_reduce``, ``parallel.mesh.allsum``).  ``mesh``: the group
    (None: this process alone, the identity); ``local_block``: this
    process's numpy block, the same shape on every process."""
    if mesh is None:
        return np.asarray(local_block)
    t = torch.as_tensor(np.ascontiguousarray(local_block), device=comm_device(mesh))
    return allsum(mesh, t)[0].cpu().numpy()


def distributed_ingest(
    directory: str,
    format: str = "uos",
    start: int = 0,
    end: int = -1,
    point_filter=None,
    reduce_voxel: float = -1.0,
    octree_n: int = 1,
    mesh=None,
    device=None,
):
    """Process-split scan ingest (the scanserver role, SURVEY §2.8): each
    process reads and reduces ONLY its contiguous range of the sequence
    on ``device``, then the reduced point sets are exchanged with one
    collective (``all_gather_object``) so every process ends with the
    whole sequence.  Each scan's random reduction (``-O 1``) is seeded as
    in the one-process path, so it draws the same on whichever process
    reads it.

    Returns list[Scan].  Scans read elsewhere carry their pose (from the
    cheap .pose files) and the exchanged reduced points, but not the raw
    channels — operations needing full-resolution points (e.g.
    --exportAllPoints) only see this process's own range.  ``mesh``: the
    group (None: :func:`host_device_mesh`)."""
    import torch.distributed as dist

    from ..core import math3d
    from ..core.scan import Scan
    from ..io.scandir import _POSE_READERS, get_format, list_identifiers, read_scan

    spec = get_format(format)
    idents = list(list_identifiers(directory, spec, start, end))
    mesh = mesh if mesh is not None else host_device_mesh()
    if mesh is None:
        lo, hi = 0, len(idents)
    else:
        lo, hi = rank_range(len(idents), dist.get_world_size(mesh), dist.get_rank(mesh))
    dev = None if device is None else str(device)

    scans: list[Scan] = []
    own = {}
    for k, ident in enumerate(idents):
        if lo <= k < hi:
            s = Scan.from_raw(read_scan(directory, ident, spec, point_filter), device=dev)
            s.set_reduction(reduce_voxel, octree_n if reduce_voxel > 0 else 0)
            own[k] = s.reduced_local()
        else:
            pose_path = os.path.join(directory, f"{spec.pose_prefix}{ident}{spec.pose_suffix}")
            if os.path.exists(pose_path):
                pos, theta = _POSE_READERS[spec.pose_reader](pose_path)
            else:
                pos, theta = np.zeros(3), np.zeros(3)
            T = np.asarray(math3d.pose_to_matrix(pos, np.rad2deg(theta)))
            s = Scan.from_points(np.zeros((0, 3)), ident, pose=T)
            s.device = dev
        scans.append(s)
    if mesh is not None:
        parts = [None] * dist.get_world_size(mesh)
        dist.all_gather_object(parts, own, group=mesh)
        for part in parts:
            for k, pts in part.items():
                if not lo <= k < hi:
                    scans[k].load_reduced(pts)
    return scans


def global_scan_array(mesh, local_block, axis: int = 0) -> torch.Tensor:
    """The whole array from each process's block of it along ``axis``
    (rank order; one ``all_gather``), on every process.  ``mesh``: the
    group (None: the block itself).  Blocks must have equal shapes."""
    t = torch.as_tensor(local_block)
    if mesh is None:
        return t
    import torch.distributed as dist

    t = t.to(comm_device(mesh)).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(mesh))]
    dist.all_gather(parts, t, group=mesh)
    return torch.cat(parts, dim=axis)
