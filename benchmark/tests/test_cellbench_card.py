"""On the card, at each cell's own size: the control (the reference in
the program's place, at the precision below the cell's) and each fault
planted in the program come out not correct against the cell's limits,
on three seeds.  ``python3 -m pytest benchmark/tests -m card``."""

import pytest

from benchcore import checks
from benchcore.spec import Spec

SEEDS = "2147483989,3000000019,4294967311"
TRAIN = ("speech_train_f32_b64", "god_train_b64", "speech_train_exact_b256")


def _readings(cell, whats, dev):
    import calibrate
    from benchcore import port

    spec = Spec()
    c = spec.cell(cell)
    cfg, mix, limits = spec.config(c), spec.traffic(c), spec.limits(c)
    dev = port.device(dev)
    port.build_kernels()
    for seed in (int(s) for s in SEEDS.split(",")):
        if cell in TRAIN:
            rows = calibrate.train_readings(cfg, mix, seed, whats, dev)
        else:
            rows = calibrate.serve_readings(cfg, mix, seed, whats, dev, 72)
        for what, numbers, _ in rows:
            # the readings have no window: its replay count is not among them
            held = {k: v for k, v in limits.items() if k in numbers}
            assert set(limits) - set(held) <= {"eager_steps",
                                                "eager_requests"}
            yield seed, what, checks.judge(numbers, held)


@pytest.mark.card
@pytest.mark.parametrize("cell", [*TRAIN, "speech_serve_b1"])
def test_control_is_not_correct(cell, card):
    for seed, what, (ok, rows) in _readings(cell, ["control"], card):
        assert not ok, (seed, rows)


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN)
def test_faults_are_not_correct(cell, card):
    whats = ["state_unchanged", "half_batch", "answer_altered"]
    for seed, what, (ok, rows) in _readings(cell, whats, card):
        assert not ok, (seed, what, rows)
