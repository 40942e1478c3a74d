"""``models.graphslam.do_graph_slam`` (the whole relax): the program's
``lum_relax_time`` over the jobs' wall time.  It holds what the LUM
timers leave out: padding, upload, the cell-list spec, the Euler set-up
and the frames; the device path's closure relaxes and final relax as
much as the host path's net relax."""

from . import share_pct


def read(ctx):
    return share_pct(ctx, ("lum_relax_time",))
