"""The check catches what it must: the control (the reference in bfloat16
in the program's place) and every fault that a cell can have, planted
under a run's timed path, come out as not correct. At a tiny size on the
CPU; on the card at the cells' own size: `python3 hopper_bench/calibrate.py`
(and `test_control_on_the_card`, which skips without a card)."""

import time

import pytest

from hopper_bench.harness.control import control_readings, faults
from hopper_bench.harness.runner import make_driver, run_cell
from hopper_bench.tests.tiny import EVAL, TRAIN, tiny_cell

SEED = 2**31 + 23


def exceeds(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", [EVAL, TRAIN])
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    numbers = control_readings(cell, SEED, "cpu")
    assert exceeds(numbers, cell.limits), numbers


@pytest.mark.parametrize("name, fault", [(EVAL, "altered_answer"), (EVAL, "nms_skipped"),
                                         (EVAL, "nms_loose"), (TRAIN, "state_unchanged"),
                                         (TRAIN, "weights_unwritten"), (TRAIN, "half_batch")])
def test_a_run_with_a_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    driver = make_driver(cell, SEED, "cpu")
    faults(cell.traffic["kind"])[fault](driver)
    result = run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter(), driver=driver)
    assert not result.correct, result.checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", [EVAL, TRAIN])
def test_control_on_the_card(name, card):
    from hopper_bench.harness import spec

    cell = spec.Cell(spec.load_benchmark(), name)
    numbers = control_readings(cell, SEED, card)
    assert exceeds(numbers, cell.limits), numbers
