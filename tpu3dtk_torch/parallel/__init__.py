"""Multi-process execution on ``torch.distributed``: process groups as
meshes (``mesh``), ICP with the target split over the ranks
(``icp_shard``), LUM with the links split over the ranks
(``lum_shard``), and the multi-host job (``distributed``: the launch
environment, host-ranged scan ingest)."""
