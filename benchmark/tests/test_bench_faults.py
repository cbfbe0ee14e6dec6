"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped, the rest of a run is driven at a
tiny size on the CPU, once for each fault the cell can have (its driver's
faults()). And the control (the reference computed one precision step
below the configuration, in the program's place) fails one of each cell's
limits."""
import pytest

from benchmark.harness import registry
from benchmark.reference import precision
from benchmark.tests import tiny

FAULTS = [(cell, name) for cell in sorted(tiny.CELLS)
          for name in sorted(registry.driver(registry.traffic(
              registry.workload(cell)["traffic"])["driver"]).faults())]


def _correct(cell) -> bool:
    return tiny.execute(tiny.tiny_run(cell))["correct"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_cell_is_correct(cell):
    assert _correct(cell)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    run = tiny.tiny_run(cell)
    with run.driver.faults()[fault]():
        assert not tiny.execute(run)["correct"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_fails_a_limit(cell):
    run = tiny.tiny_run(cell)
    run.reference = precision.configured(run.config)
    low = run.reference.lowered()
    gaps = run.driver.control(run, low)
    limits = run.cell["limits"]
    assert any(gaps[k] > limits[k] for k in gaps if k in limits), \
        (gaps, limits)
