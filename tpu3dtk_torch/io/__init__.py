from . import formats, frames, scandir, writer  # noqa: F401
from .frames import AlgoType, read_frames, write_frames, final_pose  # noqa: F401
from .scandir import PointFilter, RawScan, read_scan_dir  # noqa: F401
