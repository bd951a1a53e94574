"""What decides ``correct``: the control fails the limits, and so does a run
whose timed path is broken underneath.

The control is the reference with every product's operands rounded to fp8
(``perfbench/reference/control.py``), one precision below the configurations'
bf16; it runs at the cell's own size on the card. The faults
(``perfbench/faults.py``) break the port where the timed path produces its
answer, and a whole run of the cell (the harness's look for a card skipped)
must come out not correct: at tiny64 on the CPU with the program in float32,
where a sound run reads nothing but float32 rounding, and at the cell's own
size on the card. There is one card on a cell's machine, so no cell
exchanges anything between chips.
"""

import time

import pytest

from perfbench import common, faults, harness
from perfbench.tests.conftest import tiny_context

CONTROL_SEEDS = [4300000001, 4300000002, 4300000003]


def _kinds():
    """{cell: its traffic's kind} for every cell of BENCHMARK.json."""
    bench = harness.benchmark()
    return {w["name"]: harness.load_json(harness.BENCH / "traffic" / f"{w['traffic']}.json")["kind"]
            for w in bench["workloads"]}


KINDS = _kinds()
CELLS = sorted(KINDS)
CASES = [(cell, fault) for cell in CELLS for fault in sorted(faults.FAULTS) if faults.applies(fault, KINDS[cell])]


@pytest.mark.card
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell, seed):
    ctx = harness.context(cell, seed, 1.0, False, card, time.perf_counter())
    run = harness.Run()
    common.compare(run, ctx.limits, *harness.driver(ctx.traffic["kind"]).control(ctx))
    assert not harness.judge(run), run.checks


def _run_with(monkeypatch, cell, fault, ctx):
    if fault:
        faults.FAULTS[fault](monkeypatch, cell)
    return harness.driver(ctx.traffic["kind"]).run(ctx)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    run = _run_with(monkeypatch, cell, fault, tiny_context(cell, dtype="float32"))
    assert not harness.judge(run), run.checks


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, monkeypatch):
    run = _run_with(monkeypatch, cell, None, tiny_context(cell, dtype="float32"))
    assert harness.judge(run), run.checks


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct_at_the_cells_size(card, cell, fault, monkeypatch):
    ctx = harness.context(cell, 4600000001, 1.0, False, card, time.perf_counter())
    run = _run_with(monkeypatch, cell, fault, ctx)
    assert not harness.judge(run), run.checks
