"""The readings that a cell's limits are set from, and the control that
must come out as not correct, for any traffic kind: each comes from the
kind's driver module (harness/drivers/<kind>.py).

- `program_readings`: the program at the cell's own size, set up from a
  seed (with a fault of the kind's FAULTS planted, if one is named), judged
  over the requests or first steps a run could check.
- `control_readings`: the reference computed in bfloat16 put in the
  program's place, judged by the same check.
"""

from __future__ import annotations

from . import drivers


def faults(kind):
    """{name: plant(driver)} of a traffic kind."""
    return drivers.load(kind).FAULTS


def program_readings(cell, seed, device, fault=None):
    """The check's numbers of one seed's sound (or, with `fault`, broken)
    program."""
    module = drivers.load(cell.traffic["kind"])
    driver = module.Driver(cell.config, cell.traffic, cell.limits, seed, device)
    if fault is not None:
        module.FAULTS[fault](driver)
    driver.setup()
    return module.program_numbers(driver)


def control_readings(cell, seed, device):
    """The check's numbers of the reference in bfloat16 in the program's
    place."""
    module = drivers.load(cell.traffic["kind"])
    return module.control_numbers(cell.config, cell.traffic, seed, device)
