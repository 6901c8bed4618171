"""tools/map_sensitivity_torch.py, the port's twin of tools/map_sensitivity.py:
the same planted dataset (files and dataframe equal to the JAX tool's), the
same detection matching on hand-built arrays, and the whole gate (train,
evaluate every config, compare) at a small size on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from tools import map_sensitivity as jax_tool
from tools import map_sensitivity_torch as tool


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small torch ops: with one intra-op thread they do not wait on
    OpenMP barriers when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_dataset_matches_jax_tool(tmp_path):
    got = tool.make_dataset(str(tmp_path / "torch"), np.random.RandomState(0))
    want = jax_tool.make_dataset(str(tmp_path / "jax"), np.random.RandomState(0))
    assert got.equals(want)
    for sub in ("classes/images", "src"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "torch" / sub)) == names
        for name in names:
            assert ((tmp_path / "torch" / sub / name).read_bytes()
                    == (tmp_path / "jax" / sub / name).read_bytes()), name


def _dets(boxes, scores, labels):
    return (np.asarray(boxes, np.float32), np.asarray(scores, np.float32),
            np.asarray(labels, np.int64))


def test_match_detections_on_hand_built_arrays():
    ref = [_dets([[0, 0, 10, 10], [20, 20, 30, 30], [0, 0, 10, 10]], [0.9, 0.8, 0.7], [0, 0, 1]),
           _dets([[5, 5, 15, 15]], [0.6], [2])]
    cur = [_dets([[0, 0, 10, 11], [40, 40, 50, 50]], [0.85, 0.5], [0, 0]),
           _dets([[5, 5, 15, 15]], [0.65], [2])]
    deltas, ious, unmatched = tool.match_detections(ref, cur)
    # image 0: class 0 matches the first box (IoU 10/11), the second finds
    # no box above 0.5; class 1 has no current detection; image 1 matches
    np.testing.assert_allclose(deltas, [0.05, 0.05], atol=1e-6)
    np.testing.assert_allclose(ious, [10 / 11, 1.0], rtol=1e-6)
    assert unmatched == 2
    for got, want in zip((deltas, ious, unmatched), jax_tool.match_detections(ref, cur)):
        np.testing.assert_array_equal(got, want)


def test_gate_small_on_cpu(tmp_path):
    rows = tool.main(["--device", "cpu", "--train-steps", "1", "--batch-size", "1",
                      "--train-patch", "192", "--image-size", "320", "240",
                      "--num-images", "2", "--scales", "1", "--root", str(tmp_path)])
    assert set(rows) == set(tool.CONFIGS) - {"fp32_high"}
    for name, r in rows.items():
        assert np.isfinite([r["dmAP"], r["score_delta_mean"], r["score_delta_max"]]).all(), name
        assert 0 <= r["unmatched"] <= r["reference_detections"], name
    # folding is exact up to fp32 rounding: the folded fp32 config matches as
    # the unfolded one does
    fold, plain = rows["fp32_fold_default"], rows["fp32_default"]
    assert fold["dmAP"] == plain["dmAP"] and fold["unmatched"] == plain["unmatched"]
    assert abs(fold["score_delta_mean"] - plain["score_delta_mean"]) < 1e-4
