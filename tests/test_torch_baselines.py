"""The baselines interface's twins (baselines/*_torch.py) against the JAX
package's (baselines/export_dataset.py, run_external_baseline.py) on the CPU.

The exporter writes the same COCO JSON and the same query JPEGs, byte for
byte, from each package's dataset of one tree; its command line does the same
from a tree in the GroZi layout. The external-baseline demo (the same NCC
template matcher on each package's export, scored by each package's VOC
evaluator) gives the same metrics.
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "baselines"))
sys.path.insert(0, os.path.dirname(__file__))


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_export_twin_writes_jax_files(tmp_path):
    import export_dataset
    import export_dataset_torch
    from test_main_cli import write_grozi_tree

    from os2d_tpu.data.dataset import build_dataset_by_name as jax_build
    from os2d_torch.data.dataset import build_dataset_by_name as port_build

    data_path = str(tmp_path / "data")
    write_grozi_tree(data_path)
    want = export_dataset.export(jax_build(data_path, "grozi-val-all", eval_scale=480),
                                 str(tmp_path / "jax"))
    got = export_dataset_torch.export(port_build(data_path, "grozi-val-all", eval_scale=480),
                                      str(tmp_path / "port"))
    assert got[1:] == want[1:] and os.path.basename(got[0]) == os.path.basename(want[0])
    want_files = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == want_files
    assert len(want_files) == 3  # the JSON and two queries

    # the command line
    export_dataset_torch.main(["--dataset", "grozi-val-new-cl", "--data-path", data_path,
                               "--output", str(tmp_path / "cli")])
    export_dataset.export(jax_build(data_path, "grozi-val-new-cl", eval_scale=None),
                          str(tmp_path / "cli_jax"))
    assert _files(tmp_path / "cli") == _files(tmp_path / "cli_jax")


def test_external_baseline_twin_matches_jax(tmp_path):
    import run_external_baseline
    import run_external_baseline_torch

    want = run_external_baseline.run_demo(str(tmp_path / "jax_data"), str(tmp_path / "jax"))
    got = run_external_baseline_torch.run_demo(str(tmp_path / "data"), str(tmp_path / "port"))
    assert _files(tmp_path / "data") == _files(tmp_path / "jax_data")
    for g, w in zip(got[:2], want[:2]):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read().replace(str(tmp_path / "jax_data").encode(),
                                                  str(tmp_path / "data").encode())
    metrics, want_metrics = got[2], want[2]
    assert metrics["map"] == want_metrics["map"] >= 0.5
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        for a, b in zip(*((x if isinstance(x, (list, tuple)) else [x]) for x in (metrics[k], v))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_external_baseline_twin_exit_code(tmp_path, monkeypatch, capsys):
    import run_external_baseline_torch

    with pytest.raises(SystemExit) as e:
        run_external_baseline_torch.main(["--root", str(tmp_path / "d"),
                                          "--output", str(tmp_path / "o")])
    assert e.value.code == 0
    assert "mAP@0.5 = " in capsys.readouterr().out
