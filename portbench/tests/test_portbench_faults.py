"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
toy sizes against each cell's own limits, once for each fault the cell
can have (one chip: no exchange between chips to leave out); and the
control, the reference in the precision below the configuration's, put
in the program's place, fails too: for the train cells at toy sizes, for
the serving cells at their own widths on two slices, and on a card at
the cell's own size."""

import pytest

from harness import faults
from harness.cell import Run, run_cell
from harness.check import judge
from harness.registry import Registry
from toy import toy_cell

CELLS = ["serve_f32_b8", "serve_bf16_b16", "train_mixed_f32_b4", "train_mixed_bf16_b16"]
CASES = [(c, f) for c in CELLS for f in faults.FAULTS["serve" if "serve" in c else "train"]]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault):
    kind = "serve" if "serve" in name else "train"
    out = run_cell(toy_cell(name), 2 ** 35 + 1, 0.2, False, "cpu",
                   plant=faults.FAULTS[kind][fault])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", ["serve_f32_b8", "serve_bf16_b16"])
def test_the_serving_control_is_not_correct_at_full_width(name):
    """The control of a serving cell at the cell's widths and shape, two
    slices: the reference alone, on the CPU (about 10 s)."""
    import torch

    from harness import check, phantoms, weights
    from reference.model import Reference

    cell = Registry().cell(name)
    cfg = cell["config"]["model"]
    state = weights.draw(cfg, 2 ** 35 + 4, "cpu")
    full, aux = phantoms.phantoms(torch.Generator().manual_seed(5), 2, cfg["shape"], "cpu")
    want = Reference(cfg, state, 9, "cpu").serve(full, aux).numpy()
    got = Reference(cfg, state, 9, "cpu", cell["config"]["control"]).serve(full, aux)
    stick = cell["workload"].get("yardstick")
    yard = [(0, Reference(cfg, state, 9, "cpu", stick).serve(full, aux).numpy())] if stick else None
    ok, rows = judge(check.serve_numbers([(0, got.numpy())], {0: want}, yard),
                     cell["workload"]["limits"])
    assert ok is False, rows


@pytest.mark.parametrize("name", ["train_mixed_f32_b4", "train_mixed_bf16_b16"])
def test_the_train_control_is_not_correct(name):
    cell = toy_cell(name)
    run = Run(cell, 2 ** 35 + 2, "cpu")
    loop = Registry().loop(run.traffic["loop"])(run)
    loop.setup()
    loop.free()
    got = loop.reference_record(cell["config"]["control"])
    ok, rows = judge(loop.check(got=got), cell["workload"]["limits"])
    assert ok is False, rows


@pytest.mark.card
@pytest.mark.parametrize("name", ["serve_f32_b8", "serve_bf16_b16"])
def test_the_control_fails_at_the_cells_own_size(card, name):
    cell = Registry().cell(name)
    run = Run(cell, 2 ** 35 + 3, card)
    loop = Registry().loop(run.traffic["loop"])(run)
    loop.setup()
    loop.window(3.0)
    loop.free()
    want = loop.reference_outputs()
    ok, _ = judge(loop.check(want=want), cell["workload"]["limits"])
    assert ok
    got = loop.reference_outputs(cell["config"]["control"])
    ok, rows = judge(loop.check(got=got, want=want), cell["workload"]["limits"])
    assert ok is False, rows
