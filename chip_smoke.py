#!/usr/bin/env python3
"""Smoke run of the PyTorch port (os2d_torch) on one NVIDIA card: the kernel
table and the card tests in one command.

    python3 chip_smoke.py                  # every card module; non-zero on any failure
    python3 chip_smoke.py -k first_step tests/test_torch_train_card.py
                                           # the card tests that pytest's arguments choose

First the kernel table (`tools/bench_torch_kernels.py --kernels table`: its
build line and one JSON line per row, CUDA-event ms beside the plain
version, the library call and the bound from hopper_bench/counts), then
the card tests (tests/test_torch_*_card.py under `pytest --noconftest`, or
the modules and options given: each kernel against its plain version, the
card against the CPU). The main path is one eval dispatch at the
benchmark's protocol (`Os2dConfig()`, the `default` tier) and the first
TrainStep at the default recipe; the tests that run them count each
kernel's launches from a reset just before their own run and record them
(`record_property("launches", ...)`). Then one {"kernels": [...]} line,
each CUDA kernel of the port with its source, the TPU code it replaces,
its launches where the main path (or, for GroupNorm, a GroupNorm model's
first step; for the gather and int8 kernels, their tier's dispatch; for
RoIAlign, a CoAE request) runs it, and its table row; and the last line
{"ok": ..., "device": {...}}. Without a card it prints no result and exits
1.
"""

import glob
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EVAL = "test_bench_dispatch_launches_its_kernels_once_a_level"
# name, the table's row, source, what it replaces, the test whose launches
# it reports, the key of tests/torch_card_scenes.py: kernels()
KERNELS = (
    ("resample_correlation", "gather", "os2d_torch/csrc/resample.cu",
     "os2d_tpu/ops/pallas_resample.py:24", f"{EVAL}[highest-gather]", "gather"),
    ("hat_resample_correlation", "hat", "os2d_torch/csrc/hat_resample.cu",
     "os2d_tpu/ops/pallas_hat_resample.py:42", f"{EVAL}[default-hat]", "hat"),
    ("int8_hat_resample_correlation", "int8", "os2d_torch/csrc/int8_hat_resample.cu",
     "os2d_tpu/ops/sampling.py:198", f"{EVAL}[int8-int8]", "int8"),
    ("resample_correlation_backward", "backward", "os2d_torch/csrc/resample_backward.cu",
     "os2d_tpu/ops/sampling.py:147", "test_first_step_matches_the_cpu", "backward"),
    ("group_norm_forward", "group_norm_forward", "os2d_torch/csrc/group_norm_nhwc.cu",
     "os2d_tpu/models/resnet.py:70",
     "test_first_step_of_a_model_option_matches_the_cpu[group_norm]", "gn_forward"),
    ("group_norm_backward", "group_norm_backward", "os2d_torch/csrc/group_norm_nhwc.cu",
     "os2d_tpu/models/resnet.py:70",
     "test_first_step_of_a_model_option_matches_the_cpu[group_norm]", "gn_backward"),
    ("frozen_bn_act", "frozen_bn_act", "os2d_torch/csrc/frozen_bn_act_nhwc.cu",
     "os2d_tpu/models/resnet.py:57", f"{EVAL}[default-hat]", "frozen_bn"),
    ("roi_align", "roi_align", "os2d_torch/csrc/roi_align_nhwc.cu", "(none: no two-stage model)",
     "test_coae_request_launches_its_kernels", "roi_align"),
)


class RecordedLaunches:
    """pytest plugin: `by_test`, test name -> the launches its call recorded."""

    def __init__(self):
        self.by_test = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call":
            for key, value in report.user_properties:
                if key == "launches":
                    self.by_test[report.nodeid.split("::")[-1]] = value


def kernels_line(rows, launches):
    """One entry per kernel: the fields of its first table row (the largest
    level, the scene stem's slot) as the tool printed them, then its
    source, what it replaces and its launches (None where its test did not
    run)."""
    first = {}
    for row in rows:
        first.setdefault(row["row"], row)
    return {"kernels": [
        {"name": name, "route": "cuda",
         **{k: v for k, v in first.get(row, {}).items() if k != "row"},
         "source": source, "replaces": replaces, "launches": launches.get(test, {}).get(key)}
        for name, row, source, replaces, test, key in KERNELS]}


def main(argv):
    import pytest
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: needs an NVIDIA card", file=sys.stderr)
        return 1
    rows = []
    table = subprocess.Popen([sys.executable, str(ROOT / "tools" / "bench_torch_kernels.py"),
                              "--kernels", "table"], stdout=subprocess.PIPE, text=True)
    for line in table.stdout:
        print(line, end="", flush=True)
        if line.startswith("{") and "row" in (record := json.loads(line)):
            rows.append(record)
    table_rc = table.wait()
    launches = RecordedLaunches()
    tests_rc = pytest.main(["--noconftest", "-q", "-p", "no:cacheprovider",
                            *(argv or sorted(glob.glob(str(ROOT / "tests" / "test_torch_*_card.py"))))],
                           plugins=[launches])
    print(json.dumps(kernels_line(rows, launches.by_test)), flush=True)
    ok = table_rc == 0 and tests_rc == 0
    print(json.dumps({"ok": ok, "table_rc": table_rc, "tests_rc": int(tests_rc),
                      "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
