"""``models.elch``: the program's ``elch_time`` over the jobs' wall time."""

from . import share_pct


def read(ctx):
    return share_pct(ctx, ("elch_time",))
