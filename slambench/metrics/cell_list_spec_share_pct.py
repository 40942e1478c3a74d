"""``ops.nn_cell_list.cell_list_spec`` (host): the program's
``cell_list_spec_time`` over the jobs' wall time.  The spec sizes the
chained engine's cell list in host numpy, once for a sequence's upload
and once for each host LUM (again when a guard fires)."""

from . import share_pct


def read(ctx):
    return share_pct(ctx, ("cell_list_spec_time",))
