"""Run one cell of the benchmark once and print its result line.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the
comparison with the plain reference reads, beside its limit, which the
last lines of standard error repeat).  Without the cards, or if the JAX
package, ``jax``, ``jaxlib`` or ``flax`` is loaded once the window has
closed, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
# every build and kernel cache at a fixed path inside the checkout, so
# that only a checkout's first run builds (the program's own nvcc builds
# go to build/tpu3dtk_torch beside its package)
CACHES = {
    "TORCH_EXTENSIONS_DIR": "build/slambench/torch_extensions",
    "TRITON_CACHE_DIR": "build/slambench/triton",
    "CUDA_CACHE_PATH": "build/slambench/cuda_cache",
}
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3dtk")


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)

    import torch

    from slambench import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, log=_log)

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        _log(f"modules loaded that the benchmark may not load: {', '.join(found)}")
        return 3
    if args.trace:
        try:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30,
            ).stdout.strip()
        except (OSError, subprocess.TimeoutExpired) as exc:
            card = f"nvidia-smi failed: {exc}"
        _log(f"card: {card} (rooflines against the published peaks at 700 W)")
    for name, c in result["checks"].items():
        _log(f"check {name} {c['value']} limit {c['limit']}")
    _log(f"correct {result['correct']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
