"""The judge of the eval check on detections worked out by hand: what a
greedy NMS keeps reads 0, a list that keeps what NMS drops reads its
overlap above the threshold, and the plain NMS keeps what the judge
expects."""

import pytest
import torch

from hopper_bench.reference.decode import box_iou, judge, nms_topk

# three candidates of one row: A and B overlap by IoU 1/3 (B is A moved by
# half its width), C lies apart
BOXES = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [5.0, 0.0, 15.0, 10.0],
                       [40.0, 40.0, 50.0, 50.0]]])
SCORES = torch.tensor([[0.9, 0.8, 0.7]])


def run(picks, threshold=0.3):
    """judge() on the program's list that picks these candidates, in order."""
    k = 3
    boxes = torch.zeros(1, k, 4)
    scores = torch.full((1, k), float("-inf"))
    valid = torch.zeros(1, k, dtype=torch.bool)
    for r, j in enumerate(picks):
        boxes[0, r], scores[0, r], valid[0, r] = BOXES[0, j], SCORES[0, j], True
    return judge(BOXES, SCORES, boxes, scores, valid, threshold, 3)


def test_the_overlap_of_a_and_b():
    assert box_iou(BOXES[0, 0], BOXES[0, 1]).item() == pytest.approx(1 / 3)


def test_what_nms_keeps_reads_zero():
    got = run([0, 2])
    assert got == {"score_gap": 0.0, "box_gap_px": 0.0, "rank_gap": 0.0, "iou_excess": 0.0}


def test_keeping_what_nms_drops_reads_its_overlap():
    got = run([0, 1, 2])
    assert got["iou_excess"] == pytest.approx(1 / 3 - 0.3)
    # its scores are the best available ones: rank_gap cannot see it
    assert got["rank_gap"] == 0.0
    # at a threshold above the overlap, B is kept by NMS and reads 0
    assert run([0, 1, 2], threshold=0.5)["iou_excess"] == 0.0


def test_skipping_a_kept_candidate_reads_in_rank_gap():
    got = run([2])
    assert got["rank_gap"] == pytest.approx(0.2)
    assert got["iou_excess"] == 0.0


def test_the_plain_nms_keeps_a_and_c():
    b, s, v = nms_topk(BOXES, SCORES, 0.3, 3, 3)
    assert v.tolist() == [[True, True, False]]
    assert s[0, :2].tolist() == pytest.approx([0.9, 0.7])
    assert torch.equal(b[0, 1], BOXES[0, 2])
