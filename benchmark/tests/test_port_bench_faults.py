"""A run with the timed path broken underneath comes out not correct: the
whole of a run but the look for a card, on the CPU at a small size,
against the cells' own limits, once for each fault its entry can have
(`FAULTS`: an answer altered where it is produced; a step that returns
its state unchanged; half of the batch left out). A sound run at the
same size, in fp32 (the program's plain versions against the reference),
comes out correct."""
import pytest

import run
import tiny
from harness.cell import load_cell

CELLS = ["pe_l14.embed_b64", "clip_l14.embed_b64", "pe_l14.search_q256", "pe_l14.train_b16"]
CASES = [(w, f) for w in CELLS for f in sorted(load_cell(w, 1, 1.0).entry.FAULTS)]


def measure(c):
    return run.measure(c, c.entry, False, t0=run.time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    r = measure(tiny.cell(workload))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_is_caught(workload, fault):
    c = tiny.cell(workload)
    with c.entry.FAULTS[fault]():
        r = measure(c)
    assert not r["correct"], (fault, r["checks"])
    assert any(float(v["value"]) > v["limit"] for v in r["checks"].values())
