"""``models.graphslam`` (the host LUM): ``lum_cov_time`` +
``lum_solve_time`` over the jobs' wall time, where the configuration
relaxes on the host path."""

from . import share_pct


def read(ctx):
    if ctx["cfg"].get("lum", {}).get("path") != "host":
        return None
    return share_pct(ctx, ("lum_cov_time", "lum_solve_time"))
