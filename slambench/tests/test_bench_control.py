"""The control, the plain reference in the next lower precision (its
nearest-neighbour ranking a TF32 product) put in the program's place,
comes out not correct: at a tiny size on the CPU here, and on the card
with the cuda marker.  ``python3 -m slambench.calibrate`` reads it at
each cell's own size on the card."""

from __future__ import annotations

import importlib

import pytest
import torch
from conftest import tiny_cell

from slambench import harness
from slambench.reference import check


def _control_numbers(name, device, seed=2**31 + 33, sample=None):
    cell = tiny_cell(name)
    cfg, traffic = cell.cfg, cell.traffic
    traffic["sample"] = sample or traffic["sample"]
    gen = importlib.import_module(f"slambench.gen.{cfg['generator']}")
    entry = importlib.import_module(f"slambench.entries.{traffic['entry']}")
    sets = gen.generate(cfg["scene"], 1, seed, device)
    si, idx = harness.job_plan(traffic, int(cfg["scene"]["n_scans"]))[0]
    rec = harness.run_job(entry, sets[si], idx, cfg, device, False)
    rec["set"] = si
    raw = [s["locals"] for s in sets]
    prog = check.compare([rec], raw, cfg, traffic["sample"], seed, device)
    ctrl = check.compare([rec], raw, cfg, traffic["sample"], seed, device, control=True)
    return traffic["limits"], prog, ctrl


def _fails(limits, numbers):
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("name", ["ring-graph"])
def test_control_fails_where_the_program_passes(name):
    # on the CPU the matches alone: the brute TF32 ranking of the ELCH
    # windows and LUM links would take minutes here
    limits, prog, ctrl = _control_numbers(name, "cpu", sample={"match": 4})
    assert not _fails(limits, prog), prog
    assert _fails(limits, ctrl), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ring-graph", "city-seq"])
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits, prog, ctrl = _control_numbers(name, "cuda")
    assert not _fails(limits, prog), prog
    assert _fails(limits, ctrl), ctrl
