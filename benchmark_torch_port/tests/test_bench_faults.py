"""A run with the timed path broken underneath comes out not correct:
each fault that a cell can have, planted in the port (``faults.py``), at a
small size on the CPU (the harness's look for a card skipped), judged by
the cell's own limits; and the control, the reference in fp8 put in the
program's place, reads far above a sound run."""

import functools

import pytest

import faults
import harness
from conftest import small_ctx

TRAIN_CELLS = ["train-321-fold30", "train-513-b6x5", "train-321-b6x5"]
CASES = ([(cell, f) for cell in TRAIN_CELLS for f in faults.TRAIN]
         + [("eval-513-voc-crf", f) for f in faults.EVAL])


@functools.lru_cache(maxsize=None)
def sound_readings(cell: str) -> dict:
    ctx = small_ctx(cell)
    return harness.load_module(f"drivers/{ctx.spec['driver']}.py").run(ctx)["readings"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_comes_out_not_correct(cell, fault):
    """The run with the fault is not correct, by a number that reads above
    its limit and ten times what the same run reads without the fault
    (three times for a state left unchanged); a gradient's fault by its
    leaf's gap, the worst of which is the number compared (at this size a
    sound run may read above limits set at the cell's own)."""
    ctx = small_ctx(cell)
    driver = harness.load_module(f"drivers/{ctx.spec['driver']}.py")
    undo = faults.plant(fault)
    try:
        out = driver.run(ctx)
    finally:
        undo()
    assert not harness.checks_correct(out["checks"]), out["readings"]
    sound = sound_readings(cell)
    times = 3 if fault == "unchanged" else 10
    caught = [name for name, value, limit in out["checks"]
              if value > limit and value > times * sound[name]]
    limit = ctx.limits.get("data_grad_gap")
    caught += [leaf for leaf, gap in out["readings"].get("data_grad_gaps", {}).items()
               if gap > limit and gap > times * sound["data_grad_gaps"][leaf]]
    assert caught, (out["readings"], sound)


@pytest.mark.parametrize("cell", TRAIN_CELLS + ["eval-513-voc-crf"])
def test_the_control_reads_far_above_a_sound_run(cell):
    ctx = small_ctx(cell)
    sound = sound_readings(cell)
    control = harness.load_module(f"drivers/{ctx.spec['driver']}.py").control_readings(ctx)
    assert control["logits_gap"] > 3 * sound["logits_gap"], (control, sound)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TRAIN_CELLS + ["eval-513-voc-crf"])
def test_the_control_fails_the_limits_at_the_cells_size(card, cell):
    """On the card, at the cell's own size, on three seeds: the control
    fails one of the cell's numbers."""
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctx = harness.Context(workload=cell, seed=seed, seconds=0.5, trace=False, device=card)
        driver = harness.load_module(f"drivers/{ctx.spec['driver']}.py")
        control = driver.control_readings(ctx)
        checks = [(n, control[n], lim) for n, lim in ctx.limits.items() if n in control]
        assert checks and not harness.checks_correct(checks), control
