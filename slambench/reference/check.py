"""The comparison that decides ``correct``.

After the window, a sample of each job's steps, drawn from the seed, is
recomputed by the plain reference (``plain.py``) from the program's own
state before the step (``events.replay``), and the program's poses after
it are compared with the reference's:

- ``reduce_rows_differ``: reduced points of every scan the sampled
  steps read that differ from the reference's reduction (exact: 0);
- ``icp_gap_cm``: the widest gap, over the sampled matches, between the
  matched scan's pose and the reference ICP's, measured as the largest
  distance by which the two poses place a corner of the scan's extent;
- ``elch_gap_cm``: the same over every scan a sampled ELCH closure moved;
- ``lum_gap_cm``: the same over every scan of a sampled LUM relaxation,
  after its last iteration: the reference runs the whole relaxation from
  the poses it started from, with its own stop test (``lum_relax``).
  Kinds ``lum`` (a closure's relax, right after its ELCH step) and
  ``relax`` (every other relaxation: the final relax, a net's relax) are
  drawn apart.  Where the program's number of iterations is not a stop
  the reference's mean shifts allow (within ``STOP_TOL`` of epsilon),
  its poses are compared with the reference's at the reference's stop.
  A relaxation of two iterations or more leaves out the scans that start
  it in Matrix4ToEuler's gimbal branch (``GIMBAL_COS``): there Ha⁻¹
  amplifies every difference at least 200 times an iteration, and the
  reference itself does not settle them.

A traffic file's ``limits`` names the numbers its cell is judged by.

The reference reduces the raw scans itself and computes every pairing
itself; the program's state enters only as the poses before each step.
In the control (``plain.CONTROL``) the reference in lower precision
takes the program's place.
"""

from __future__ import annotations

import numpy as np

from . import events, plain
from . import math3d as m3

class _Job:
    """One job's steps and the reference's reduction of its scans."""

    def __init__(self, rec, raw, cfg):
        self.rec, self.raw, self.cfg = rec, raw, cfg
        self.steps = events.replay(rec["frames"], rec["origin"])
        self._red = {}

    def closure_pairings(self) -> dict:
        """For each closure relax (a LUM step right after an ELCH step):
        its links and the relative pose each is paired at, by the cache
        rule replayed over the job's closures in order."""
        if not hasattr(self, "_closure_pairings"):
            cfg, g = self.cfg, self.cfg["graph"]
            cache, out = plain.PairingCache(), {}
            for si, st in enumerate(self.steps):
                if st.kind == "lum" and si and self.steps[si - 1].kind == "elch":
                    mats = st.before[: len(st.participants)]
                    if cfg["lum"].get("path") == "device":
                        mats = _euler_state(mats)
                    links = plain.proximity_links(mats[:, :3, 3], g["cldist_cm"] ** 2, g["loopsize"])
                    out[si] = (links, cache.prepare(links, mats))
            self._closure_pairings = out
        return self._closure_pairings

    def reduced(self, k):
        if k not in self._red:
            red = self.cfg["reduction"]
            self._red[k] = plain.reduce_scan(self.raw[k], red["voxel_cm"], red["nrpts"])
        return self._red[k]

    def box(self, k):
        r = self.reduced(k)
        return r.min(0), r.max(0)


def _euler_state(mats):
    """The poses a device relax starts from: it holds each pose as 3DTK
    Euler angles (Matrix4ToEuler) and moves the points by those, and at a
    quarter turn (the gimbal branch) that does not give the matrix back."""
    theta, pos = m3.matrix4_to_euler(mats)
    return m3.euler_to_matrix4(pos, theta)


def _gap(job, k, Ta, Tb):
    lo, hi = job.box(k)
    return m3.box_gap(Ta, Tb, lo, hi)


def _match(job, st, cfg, prec, device):
    i = st.target
    B, org = st.before, job.rec["origin"]
    T0 = B[i - 1] @ m3.m4inv(org[i - 1]) @ B[i]
    icp = cfg["icp"]
    model = job.reduced(i - 1).astype(np.float64) @ B[i - 1][:3, :3].T + B[i - 1][:3, 3]
    T, _ = plain.icp(model, job.reduced(i), T0, icp["max_dist_cm"] ** 2, icp["epsilon"],
                     icp["max_iterations"], prec, device)
    return {i: T}


def _elch(job, st, cfg, prec, device, closure_no):
    first, last, upto = job.rec["closures"][closure_no]
    edges = []
    for i in range(1, upto + 1):
        edges.append((i - 1, i))
        edges += [(f, l) for f, l, u in job.rec["closures"][:closure_no] if u == i]
    n = upto + 1
    icp = cfg["icp"]
    new = plain.elch_slerp(
        [job.reduced(k) for k in range(n)], st.before[:n], first, last, edges,
        icp["max_dist_cm"] ** 2, icp["epsilon"], icp["max_iterations"], prec, device,
    )
    return {k: new[k] for k in st.participants}


STOP_TOL = 0.25  # a mean shift this close to epsilon may stop on either side
GIMBAL_COS = 0.005  # |cos(theta_y)| at or below it: Matrix4ToEuler's gimbal branch
NAMES = {"match": "icp_gap_cm", "elch": "elch_gap_cm", "lum": "lum_gap_cm", "relax": "lum_gap_cm"}


def _runs(steps) -> list[list[int]]:
    """The job's LUM relaxations, each the indices of its iterations."""
    runs = []
    for si, st in enumerate(steps):
        if st.kind == "lum" and (st.run_start or not runs or runs[-1][-1] != si - 1):
            runs.append([si])
        elif st.kind == "lum":
            runs[-1].append(si)
    return runs


def _relax(job, run, cfg, prec, device, at_least=0):
    """The reference's relaxation from the poses before ``run``: (poses
    after each iteration, mean shift of each, iterations it may run)."""
    si = run[0]
    st = job.steps[si]
    n = len(st.participants)
    mats = st.before[:n]
    lum = cfg["lum"]
    paired_at = None
    closure = si > 0 and job.steps[si - 1].kind == "elch"
    if job.rec.get("links") is not None:
        links = [tuple(map(int, lk)) for lk in job.rec["links"]]
    elif closure:
        links, paired_at = job.closure_pairings()[si]
    else:
        g = cfg["graph"]
        links = plain.proximity_links(mats[:, :3, 3], g["cldist_cm"] ** 2, g["loopsize"])
    iters = cfg["graph"]["closure_lum_iterations"] if closure else lum["iterations"]
    poses, rets = plain.lum_relax([job.reduced(k) for k in range(n)], mats, links, lum["max_dist_cm"] ** 2,
                                  int(iters), lum["epsilon"], prec, device, lum.get("path") == "device",
                                  paired_at, at_least)
    return poses, rets, int(iters)


def _stop_at(k_got, rets, iterations, eps) -> int:
    """The iteration after which the reference's poses are compared with
    a relaxation that ran ``k_got`` iterations: ``k_got`` where the
    reference's mean shifts allow that stop, else the reference's own."""
    k_ref = next((k + 1 for k, r in enumerate(rets) if r <= eps), len(rets))
    ok = (k_got <= len(rets)
          and all(r > eps * (1 - STOP_TOL) for r in rets[: k_got - 1])
          and (k_got == iterations or rets[k_got - 1] <= eps * (1 + STOP_TOL)))
    return k_got if ok else k_ref


def compare(records, raw_sets, cfg, sample, seed, device, control=False, log=None):
    """Numbers of the comparison: {name: value} over a sample of the
    steps of ``records`` (each with ``frames``, ``origin``, ``reduced``,
    ``set``, ``scans`` and, where the entry makes them, ``closures`` and
    ``links``); ``raw_sets[set][k]`` are the raw scans the job was made
    from, ``sample`` the number of steps of each kind to draw."""
    jobs = [_Job(r, [raw_sets[r["set"]][k] for k in r["scans"]], cfg) for r in records]
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    cands = {"match": [], "elch": [], "lum": [], "relax": []}
    for ji, job in enumerate(jobs):
        n_elch = 0
        for si, st in enumerate(job.steps):
            if st.kind == "elch":
                cands["elch"].append((ji, si, n_elch))
                n_elch += 1
            elif st.kind == "match":
                cands["match"].append((ji, si, None))
        for run in _runs(job.steps):
            after_elch = run[0] > 0 and job.steps[run[0] - 1].kind == "elch"
            cands["lum" if after_elch else "relax"].append((ji, run[-1], run))
    widest = {}
    for kind in ("match", "elch", "lum", "relax"):
        want = int(sample.get(kind, 0))
        if want == 0 or not cands[kind]:
            continue
        picks = rng.choice(len(cands[kind]), size=min(want, len(cands[kind])), replace=False)
        for p in sorted(picks):
            ji, si, extra = cands[kind][p]
            job, st = jobs[ji], jobs[ji].steps[si]
            note = ""
            if kind == "match":
                ref = _match(job, st, cfg, plain.REFERENCE, device)
                got = _match(job, st, cfg, plain.CONTROL, device) if control else st.after
            elif kind == "elch":
                ref = _elch(job, st, cfg, plain.REFERENCE, device, extra)
                got = _elch(job, st, cfg, plain.CONTROL, device, extra) if control else st.after
            else:
                if control:
                    poses, _, _ = _relax(job, extra, cfg, plain.CONTROL, device)
                    got, k_got = dict(enumerate(poses[-1])), len(poses)
                else:
                    got, k_got = st.after, len(extra)
                poses, rets, iters = _relax(job, extra, cfg, plain.REFERENCE, device, at_least=k_got)
                k = _stop_at(k_got, rets, iters, cfg["lum"]["epsilon"])
                ref = {j: poses[k - 1][j] for j in st.participants}
                note = (f", {k_got} iterations, the reference's mean shifts "
                        f"{', '.join(f'{r:.4g}' for r in rets)}, compared after {k}; after each: "
                        + ", ".join(f"{max(_gap(job, j, got[j], p[j]) for j in st.participants):.4g}" for p in poses))
                if k >= 2:
                    # Ha of the Euler LUM has the determinant -cos(theta_y): in
                    # Matrix4ToEuler's gimbal branch it amplifies any difference
                    # in the system hundreds of times, iteration on iteration
                    theta, _ = m3.matrix4_to_euler(job.steps[extra[0]].before[sorted(ref)])
                    gimbal = [j for j, th in zip(sorted(ref), theta) if abs(np.cos(th[1])) <= GIMBAL_COS]
                    note += ("; left out, in the gimbal branch at the start (gap): "
                             + (", ".join(f"{j}: {_gap(job, j, got[j], ref[j]):.4g}" for j in gimbal) or "none"))
                    for j in gimbal:
                        del ref[j]
            gaps = {k: _gap(job, k, got[k], ref[k]) for k in ref}
            k = max(gaps, key=gaps.get)
            widest.setdefault(NAMES[kind], []).append(gaps[k])
            if log is not None:
                first = extra[0] if kind in ("lum", "relax") else si
                log(f"  {kind} job {ji} step {first} ({len(gaps)} scans, after a {job.steps[first - 1].kind}): "
                    f"widest gap {gaps[k]:.6g} cm at scan {k}, median {float(np.median(list(gaps.values()))):.6g}"
                    + note)
    out = {name: max(w) for name, w in widest.items()}
    differ = 0
    for job in jobs:
        for k in sorted(job._red):
            a, b = job.rec["reduced"][k], job.reduced(k)
            if a.shape != b.shape:
                differ += max(len(a), len(b))
            else:
                differ += int((a != b).any(1).sum())
    out["reduce_rows_differ"] = float(differ)
    return out
