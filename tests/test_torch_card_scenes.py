"""What the card tests read, checked on the CPU in seconds:

- tests/torch_card_scenes.py's writers: the planted eval set reads back
  through `os2d_torch.data` with its planted boxes, at both scales the card
  tests write it; the planted training set holds its TRAIN_CLASSES classes
  as 240-px class images and four planted boxes a scene.
- tools/bench_torch_kernels.py's yardsticks: the gather's, the int8
  kernel's and the frozen BatchNorm's bytes (which the benchmark does not
  count) equal a hand count on one small shape; the hat, backward and
  GroupNorm bounds equal hopper_bench/counts' at the shapes of the kernel
  table in PERF.md, and follow peaks.json's rates (the tool defines no peak
  of its own).
- chip_smoke.py's kernels line: an entry for every kernel that the card
  tests count, its row one that the tool prints, its launches from a test
  of the card modules that records them.

The file imports no JAX.
"""

import pathlib

import numpy as np
import pytest

import chip_smoke
from hopper_bench.counts import flops
from hopper_bench.counts.group_norm import slot_bytes
from tools import bench_torch_kernels as tool
from torch_card_scenes import (
    PATCH,
    PLANTED,
    TRAIN_CLASSES,
    TRAIN_IMAGES,
    TRAIN_SIZE,
    dataset,
    kernels,
    train_dataset,
    write_planted_dataset,
)


@pytest.mark.parametrize("scale", [1, 2])
def test_planted_set_reads_back_with_its_planted_boxes(scale, tmp_path):
    root = str(tmp_path)
    data = dataset(root, write_planted_dataset(root, scale), "planted", 640 * scale)
    assert data.image_ids == sorted(PLANTED)
    for image_id, plants in PLANTED.items():
        size = data.get_image_size_for_image_id(image_id)
        assert (size.w, size.h) == (640 * scale, 480 * scale)
        boxes = data.get_image_annotation_for_imageid(image_id)
        want = [[scale * x0, scale * y0, scale * (x0 + PATCH), scale * (y0 + PATCH)]
                for x0, y0, _ in plants]
        np.testing.assert_allclose(boxes.bbox_xyxy, want, atol=1e-3)
        assert list(boxes.get_field("labels")) == [cid for _, _, cid in plants]
    assert sorted(data.gt_images_per_classid) == [0, 1]
    for image in data.gt_images_per_classid.values():
        assert image.size == (PATCH, PATCH)


def test_planted_train_set_has_its_classes_and_240_px_class_images(tmp_path):
    data = train_dataset(str(tmp_path))
    assert data.num_images == TRAIN_IMAGES
    assert sorted(data.gt_images_per_classid) == list(range(TRAIN_CLASSES))
    assert {image.size for image in data.gt_images_per_classid.values()} == {(PATCH, PATCH)}
    for image_id in data.image_ids:
        boxes = data.get_image_annotation_for_imageid(image_id)
        assert len(boxes) == 4
        sides = boxes.bbox_xyxy[:, 2:] - boxes.bbox_xyxy[:, :2]
        np.testing.assert_allclose(sides, PATCH, atol=1e-3)
        assert (boxes.bbox_xyxy >= 0).all() and (boxes.bbox_xyxy <= TRAIN_SIZE).all()


def test_tool_counts_the_gather_int8_and_frozen_bn_bytes_by_hand():
    """B=1, C=2, A=3 anchors, T=4 template points, a lattice of 5 a side;
    a frozen BatchNorm slot of N=1, C=2, 3x4 in each form."""
    b, c, a, t, side = 1, 2, 3, 4, 5
    # corr prefix, px and py (b*c*t*a floats each); mask (c*t); out (b*c*a)
    assert tool.gather_bytes_ops(b, c, a, t) == (4 * (3 * 24 + 8 + 6), 20 * 24)
    # corr prefix (24), theta (6 an anchor of each (b, c): 36), boxes (4 an
    # anchor: 12), lattice (2 rows of 5: 10), mask (8), out (6)
    assert tool.int8_bytes_ops(b, c, a, t, side) == (4 * (24 + 36 + 12 + 10 + 8 + 6),
                                                     (49 + 28) * 24)
    # x and y (24 floats each), the identity in a tail, the four parameter
    # vectors of each BatchNorm (2 channels)
    assert tool.frozen_bn_bytes(0, 1, 2, 3, 4) == 4 * (2 * 24 + 4 * 2)
    assert tool.frozen_bn_bytes(1, 1, 2, 3, 4) == 4 * (3 * 24 + 4 * 2)
    assert tool.frozen_bn_bytes(2, 1, 2, 3, 4) == 4 * (3 * 24 + 8 * 2)


# the shapes of PERF.md's kernel table: the forward kernels at the eval
# protocol's largest level, the backward at a first train step's, the
# GroupNorm slots of exp2's scene stem and class layer3
TABLE_SHAPES = [("hat", (2, 16, 96 * 128, 121)), ("backward", (4, 16, 38 * 38, 121, 225)),
                ("group_norm", (4, 64, 300, 300)), ("group_norm", (16, 1024, 15, 15))]


@pytest.mark.parametrize("kernel,shape", TABLE_SHAPES)
def test_tool_bounds_are_the_benchmarks(kernel, shape, monkeypatch):
    """The tool's bound equals hopper_bench/counts' bound_s of the
    benchmark's own counts at the table's shapes, and moves with
    peaks.json's rates."""
    def counts():
        if kernel == "group_norm":
            return [(flops.bound_s(b, 0) * 1e3, "bytes") for b in slot_bytes(*shape)]
        bytes_ops = (flops.hat_bytes_ops if kernel == "hat" else flops.backward_bytes_ops)(*shape)
        return flops.bound_s(*bytes_ops) * 1e3, "bytes"

    assert tool.bounds(kernel, *shape) == counts()
    monkeypatch.setitem(flops.PEAKS, "hbm_bytes_per_s", flops.PEAKS["hbm_bytes_per_s"] / 1000)
    monkeypatch.setitem(flops.PEAKS, "float32_flops", flops.PEAKS["float32_flops"] / 7)
    assert tool.bounds(kernel, *shape) == counts()
    assert tool.bound(0, 7e12) == (1e3 * 7e12 / flops.PEAKS["float32_flops"], "operations")


def test_chip_smokes_kernels_line_names_every_kernel_and_its_launches():
    """Every kernel that Launches counts has an entry; each entry's row is
    one the tool prints and its test one that records its launches; an
    entry takes its first row and its test's count, None without it."""
    assert {key for *_, key in chip_smoke.KERNELS} == set(kernels())
    tool_source = pathlib.Path(tool.__file__).read_text()
    card_sources = "".join(path.read_text() for path in
                           sorted(pathlib.Path(__file__).parent.glob("test_torch_*_card.py")))
    for _, row, _, _, test, _ in chip_smoke.KERNELS:
        assert f'_row("{row}"' in tool_source, row
        name = test.split("[")[0]
        assert f"def {name}(" in card_sources, test
        body = card_sources.split(f"def {name}(")[1].split("\ndef ")[0]
        assert 'record_property("launches"' in body, test
    line = chip_smoke.kernels_line(
        [{"row": "hat", "ms": 1.0}, {"row": "hat", "ms": 2.0}, {"row": "main_path_level"},
         {"row": "int8", "ms": 3.0, "source": "theta"}],
        {f"{chip_smoke.EVAL}[default-hat]": {"hat": 7, "frozen_bn": 280}})
    entries = {entry["name"]: entry for entry in line["kernels"]}
    assert len(entries) == len(chip_smoke.KERNELS)
    assert entries["hat_resample_correlation"]["ms"] == 1.0
    assert entries["hat_resample_correlation"]["launches"] == 7
    assert entries["frozen_bn_act"]["launches"] == 280
    assert entries["int8_hat_resample_correlation"]["source"].endswith("int8_hat_resample.cu")
    assert entries["resample_correlation"]["launches"] is None
    assert "ms" not in entries["resample_correlation"]
