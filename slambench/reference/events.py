"""The steps of one registration job, read back from its scans' frames.

Every scan keeps an append-only log of (pose, algorithm tag) frames, the
``.frames`` history 3DTK writes: a match records a frame for every scan
of the sequence (ICP for the scan matched, ICPINACTIVE before it,
INVALID after it); an ELCH closure and a LUM iteration record one for
every scan of the prefix they act on, scan 0 always among them.  So scan
0's log is the job's clock, and a scan takes part in an ELCH or LUM step
exactly where its next frame carries that step's tag.  Replaying the
logs gives, for every step, the poses before and after it: the program's
own state, from which the reference recomputes each step.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# 3DTK's AlgoType tags (scan.h:126), as the frames files store them
INVALID, ICP, ICPINACTIVE, LUM, ELCH = 0, 1, 2, 3, 4


@dataclasses.dataclass
class Step:
    kind: str  # "match" | "elch" | "lum"
    participants: list[int]
    before: np.ndarray  # [S, 4, 4] poses of every scan before the step
    after: dict[int, np.ndarray]  # pose of each participant after it
    target: int | None = None  # the scan matched (a match step)
    run_start: bool = False  # a LUM step that starts a relaxation


def replay(frames: list[list[tuple[np.ndarray, int]]], origin: list[np.ndarray]) -> list[Step]:
    """Steps of a job from each scan's frames (``origin``: the poses the
    scans were made with)."""
    S = len(frames)
    cur = np.stack([np.asarray(T, np.float64) for T in origin])
    ptr = [0] * S
    steps: list[Step] = []
    for _T0, tag0 in frames[0]:
        if tag0 in (ELCH, LUM):
            part = [k for k in range(S) if ptr[k] < len(frames[k]) and frames[k][ptr[k]][1] == tag0]
        else:
            part = list(range(S))
        after = {k: np.asarray(frames[k][ptr[k]][0], np.float64) for k in part}
        target = None
        if tag0 not in (ELCH, LUM):
            hits = [k for k in part if frames[k][ptr[k]][1] == ICP]
            if len(hits) != 1:
                raise ValueError(f"a match step with {len(hits)} matched scans")
            target = hits[0]
        kind = {ELCH: "elch", LUM: "lum"}.get(tag0, "match")
        prev = steps[-1] if steps else None
        # a relaxation starts after any other step, and after a closure's
        # one-iteration relax (which follows its ELCH step)
        run_start = kind == "lum" and (
            prev is None or prev.kind != "lum" or (len(steps) >= 2 and steps[-2].kind == "elch")
        )
        steps.append(Step(kind, part, cur.copy(), after, target, run_start))
        for k in part:
            cur[k] = after[k]
            ptr[k] += 1
    return steps
