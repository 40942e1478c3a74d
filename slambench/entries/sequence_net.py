"""``SequenceRegistration.run`` and then ``graphslam.do_graph_slam``
over the chain and the closing link (``torchslam -n bremen.net``): on
city-scale scans the chained cell-list engine (K2) matches and the host
LUM relaxes.

Traced, the matches run one by one through ``run_single`` (which is
what ``run`` does on the chained engine) inside ``record_function``
ranges, and the K2 calls of each match are counted by the program's
loop-trip counter, so that each call's sizes are known."""

from __future__ import annotations

import numpy as np
import torch

from tpu3dtk_torch.models.graphslam import LumParams, do_graph_slam
from tpu3dtk_torch.models.icp import IcpParams
from tpu3dtk_torch.models.sequence import SequenceRegistration
from tpu3dtk_torch.utils.metrics import metrics

TRIPS = "chained_icp_loop_trips"
LUM_CALLS = "chained_lum_link_calls"


def registration(cfg, device):
    icp = cfg["icp"]
    kw = {"chained_min": icp["chained_min"]} if "chained_min" in icp else {}
    return SequenceRegistration(
        params=IcpParams(
            max_dist_match2=icp["max_dist_cm"] ** 2, max_iterations=icp["max_iterations"],
            epsilon=icp["epsilon"], minimizer=icp["minimizer"],
        ),
        device=device,
        **kw,
    )


def run(scans, cfg, device, trace=False):
    reg = registration(cfg, device)
    calls = []
    if trace:
        infos = []
        for i in range(1, len(scans)):
            before = metrics.counters[TRIPS].total
            with torch.profiler.record_function(f"match {i}"):
                infos.append(reg.run_single(scans, i))
            calls.append((len(scans[i].reduced_local()), len(scans[i - 1].reduced_local()),
                          int(metrics.counters[TRIPS].total - before)))
    else:
        infos = reg.run(scans)
    n = len(scans)
    links = np.array([(i, i + 1) for i in range(n - 1)] + [(0, n - 1)], np.int64)
    lum = cfg["lum"]
    before = metrics.counters[LUM_CALLS].total
    with torch.profiler.record_function("lum"):
        do_graph_slam(scans, links, LumParams(
            max_dist_match2=lum["max_dist_cm"] ** 2, iterations=lum["iterations"],
            epsilon=lum["epsilon"], device=device,
            **({"chained_min": lum["chained_min"]} if "chained_min" in lum else {}),
        ))
    lum_calls = int(metrics.counters[LUM_CALLS].total - before)
    if trace and lum_calls:
        per_link = lum_calls // len(links)
        calls += [(len(scans[j].reduced_local()), len(scans[i].reduced_local()), per_link) for i, j in links]
    return {"infos": infos, "links": links.tolist(), "k2_calls": calls}
