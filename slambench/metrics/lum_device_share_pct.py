"""``models.lum_device``: ``lum_cov_time`` + ``lum_solve_time`` over the
jobs' wall time, where the configuration relaxes on the device (on that
path the solve's host read waits for the covariance kernels, so only the
sum is sound)."""

from . import share_pct


def read(ctx):
    if ctx["cfg"].get("lum", {}).get("path") != "device":
        return None
    return share_pct(ctx, ("lum_cov_time", "lum_solve_time"))
