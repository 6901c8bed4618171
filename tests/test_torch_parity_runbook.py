"""The release-parity runbook's twin (tools/parity_release_torch.py) on the
CPU, against the JAX runbook (tools/parity_release.py).

The released checkpoints and GroZi-3.2k are not in the repo, so, as
tests/test_parity_runbook.py does for the JAX runbook, the twin runs end to
end on a synthetic tree in the GroZi layout (tests/test_main_cli.py:
write_grozi_tree) and a checkpoint in the reference's layout
(tests/test_torch_checkpoint.py: reference_net), with SCALE and ROWS shrunk
to the tree: the checkpoint cascade, the dataset build, the eval protocol,
the JSON lines and the exit codes. One eval runs; given its mAP, the JAX
runbook prints the same lines, and the twin at a strict tolerance FAILs;
--mesh outside torchrun raises.
"""

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
sys.path.insert(0, os.path.dirname(__file__))

from test_main_cli import IMG_W, write_grozi_tree
from test_torch_checkpoint import reference_net

from tools import parity_release, parity_release_torch

# the protocol shrunk to the tree: half its width, one pyramid level
SHRUNK_SCALE = IMG_W // 2
SHRUNK_ROWS = {"v2-train": ("os2d_v2-train.pth", 90.65, {}, {"scales_of_image_pyramid": [1.0]})}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("runbook")
    data_path = str(root / "data")
    write_grozi_tree(data_path)
    ckpt_path = str(root / "os2d_v2-train.pth")
    torch.save({"net": reference_net(merge=True)}, ckpt_path)
    return str(root), data_path, ckpt_path


def run(module, argv, monkeypatch, capsys):
    """(exit code, the JSON lines printed) of module.main with argv."""
    monkeypatch.setattr(module, "SCALE", SHRUNK_SCALE)
    monkeypatch.setattr(module, "ROWS", SHRUNK_ROWS)
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    with pytest.raises(SystemExit) as e:
        module.main()
    out = capsys.readouterr().out.strip().splitlines()
    return e.value.code, [json.loads(line) for line in out if line.startswith("{")]


def test_runbook_twin_end_to_end(artifacts, monkeypatch, capsys):
    import os2d_tpu.engine.train as jax_train

    from os2d_torch.engine import train as port_train

    root, data_path, ckpt_path = artifacts
    single = ["--row", "v2-train", "--checkpoint", ckpt_path, "--data-path", data_path,
              "--device", "cpu"]
    # a generous tolerance: PASS, exit 0 (one thread: the eval's matmuls
    # crawl when the test workers' threads oversubscribe the cores)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc, lines = run(parity_release_torch, single + ["--tol", "100"], monkeypatch, capsys)
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    row_line, gate_line = lines[-2], lines[-1]
    assert row_line["row"] == "v2-train" and row_line["pass"] is True
    assert row_line["pyramid"] == [1.0] and row_line["scale"] == SHRUNK_SCALE
    assert 0.0 <= row_line["mAP@0.50"] <= 100.0
    assert gate_line["parity_gate"] == "PASS"

    # each runbook with that eval's mAP (the eval itself ran above): the JAX
    # runbook prints the same lines; at the real target and a strict
    # tolerance the twin says FAIL and exits 1, with the checkpoint found in
    # --models-dir by its release file name
    measured = row_line["mAP@0.50"] / 100.0

    def same_eval(loaders, *args, **kwargs):
        assert [loader.get_name() for loader in loaders] == ["grozi-val-new-cl"]
        return {"grozi-val-new-cl": {"mAP@0.50": measured}}

    monkeypatch.setattr(jax_train, "evaluate_model", same_eval)
    jax_rc, jax_lines = run(parity_release, single[:-2] + ["--tol", "100"], monkeypatch,
                            capsys)
    assert (jax_rc, jax_lines) == (rc, lines)
    monkeypatch.setattr(port_train, "evaluate_model", same_eval)
    rc, lines = run(parity_release_torch, ["--rows", "v2-train", "--models-dir", root,
                                           "--data-path", data_path, "--tol", "0",
                                           "--device", "cpu"], monkeypatch, capsys)
    assert rc == 1 and lines[-1]["parity_gate"] == "FAIL" and lines[-2]["pass"] is False
    assert lines[-2]["checkpoint"] == ckpt_path
    assert lines[-2]["mAP@0.50"] == row_line["mAP@0.50"]


def test_runbook_twin_mesh_needs_torchrun(artifacts, monkeypatch):
    root, data_path, ckpt_path = artifacts
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "argv", ["parity_release_torch", "--row", "v2-train",
                                      "--checkpoint", ckpt_path, "--data-path", data_path,
                                      "--device", "cpu", "--mesh", "2"])
    with pytest.raises(SystemExit, match="torchrun"):
        parity_release_torch.main()


def test_runbook_twin_keeps_the_jax_rows():
    assert parity_release_torch.ROWS == parity_release.ROWS
    assert (parity_release_torch.DATASET, parity_release_torch.SCALE) == (
        parity_release.DATASET, parity_release.SCALE)
