"""The drivers of the traffic kinds: a traffic file's "kind" names the module
`drivers/<kind>.py`, found by name, so that a new kind of traffic adds a
file and edits none. Each module provides:

  Driver(config, traffic, limits, seed, device)
    setup()                  build the program and the inputs, warm up
    request(i)               the i-th timed request or step; its output
    first                    the index of the window's first request
    trace_count              requests in a traced window
    images_per_request
    model                    the Os2dModel, for the harness's ranges
    setup_phases             {phase: seconds} of the set-up
    end_to_end(records, start, end) -> {metric: value}
    release()                free the program's state
    check(records) -> (correct, {name: (value, limit)})
  program_numbers(driver)    after setup(): the numbers of the check over
                             every request a run could judge (calibration)
  control_numbers(config, traffic, seed, device)
                             the same numbers of the control: the reference
                             in bfloat16 in the program's place
  FAULTS                     {name: plant(driver)}: faults planted under the
                             timed path, before setup(), that the check has
                             to catch
"""

from __future__ import annotations

import importlib


def load(kind: str):
    """The driver module of a traffic kind."""
    if not kind.isidentifier():
        raise ValueError(f"traffic kind {kind!r} is not a module name")
    try:
        return importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        if e.name == f"{__name__}.{kind}":
            raise ValueError(f"no driver for traffic kind {kind!r}") from e
        raise
