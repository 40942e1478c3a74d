"""``GraphPipeline.run``: sequential ICP, loop detection, an ELCH
closure with a one-iteration LUM at each loop, and the final LUM relax
(``torchslam -L 4 -G 1``, the main path)."""

from __future__ import annotations

from tpu3dtk_torch.models.graph_pipeline import GraphPipeline
from tpu3dtk_torch.models.icp import IcpParams


def run(scans, cfg, device, trace=False):
    icp, g, lum = cfg["icp"], cfg["graph"], cfg["lum"]
    pipe = GraphPipeline(
        icp_params=IcpParams(
            max_dist_match2=icp["max_dist_cm"] ** 2, max_iterations=icp["max_iterations"],
            epsilon=icp["epsilon"], minimizer=icp["minimizer"],
        ),
        lum_max_dist2=lum["max_dist_cm"] ** 2,
        lum_iterations=lum["iterations"],
        lum_epsilon=lum["epsilon"],
        closure_lum_iterations=g["closure_lum_iterations"],
        elch=True,
        elch_algo=g["elch_algo"],
        cldist=g["cldist_cm"],
        loopsize=g["loopsize"],
        slam_algo=lum["algo"],
        device=device,
    )
    infos = pipe.run(scans)
    return {"infos": infos, "closures": [tuple(c) for c in pipe.closures]}
