"""On the card, at each one-card cell's own size: the control (the plain
reference in the program's place in TF32, or with the training fault) fails
at least one of the cell's numbers, and the program passes them all."""

import pytest

from portbench import calibrate, harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
SEED = 2**31 + 77


def _fails(reading, cell) -> bool:
    limits = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")["limits"]
    return any(v > limits[n] for n, v in reading["checks"].items())


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_fails_and_program_passes(card, cell):
    control = calibrate.readings(cell, SEED, 1.0, True, [card])
    assert _fails(control, cell), control
    program = calibrate.readings(cell, SEED + 1, 1.0, False, [card])
    assert not _fails(program, cell), program


@pytest.mark.card
def test_half_batch_fault_fails_the_training_cell(card):
    cell = "m2track_kitti_car.train_b100"
    if cell not in ONE_CARD:
        pytest.skip("no training cell in BENCHMARK.json")
    assert _fails(calibrate.readings(cell, SEED, 1.0, True, [card], fault="half"), cell)
