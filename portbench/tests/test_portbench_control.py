"""On the card, at each cell's own size: the program's sampled steps are
within the cell's limits on three seeds, and the control (the plain
reference in bfloat16 storage in the program's place) and each fault the
cell can have, planted in the program's records, are not.  Marked ``slow`` and skipped without a card (decided in the
``cuda`` fixture); on a machine with one it runs as

    python -m pytest --noconftest -p no:cacheprovider -m slow portbench/tests
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check as ck  # noqa: E402
from portbench import drivers, run, spec  # noqa: E402

pytestmark = pytest.mark.slow
SEEDS = (2 ** 31 + 11, 2 ** 33 + 12, 13)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def over(numbers, limits):
    return [name for name, limit in limits.items() if numbers[name] > limit]


@pytest.mark.parametrize("workload", ["melbourne.rollout", "45_intersections.env"])
def test_control_and_faults_fail_the_program_passes(workload, cuda):
    cell = spec.load_cell(workload)
    driver = drivers.make_driver(cell.config, cell.traffic, cuda)
    run.warm_up(driver, cell.traffic, SEEDS[0], False)
    reference = drivers.make_reference(cell.config, cell.traffic, cuda)
    for seed in SEEDS:
        driver.begin(seed)
        w = run.Window(driver, np.random.default_rng(seed), cell.traffic["check_rows"],
                       checks=4)
        while not (w.episode == 0 and w.ep_step == driver.horizon):
            w.step()
        run.sync(cuda)
        driver.release()
        assert not over(ck.run_checks(reference, w.records).numbers(), cell.limits)
        assert over(ck.run_checks(reference, w.records, control=True).numbers(), cell.limits)
        for fault in reference.faults:
            assert over(ck.run_checks(reference, w.records, fault=fault).numbers(),
                        cell.limits), fault
