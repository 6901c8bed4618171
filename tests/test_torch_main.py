"""The port's launch path against the JAX package's, on the CPU.

- The dataset builders by name (`os2d_torch.data.dataset`) against
  `os2d_tpu.data.dataset` on synthetic trees in each dataset's published
  layout: GroZi-3.2k (tests/test_main_cli.py's tree), the retail sets dairy
  and paste, INSTRE (converted from gnd_instre.mat), the ImageNet-RepMet test
  episodes (from their pickles) and the ImageNet train and val sets (from
  their XML): equal dataframes, image ids, class ids, image sizes and boxes.
- `build_eval_dataloaders_from_cfg` and the by-name
  `build_train_dataloader_from_config` give the JAX builders' datasets and
  pyramids.
- `python -m os2d_torch.main` on the GroZi tree at a small size, in one
  process and as 2 gloo ranks under torchrun (`tpu.distributed_init True`):
  the train-loss trajectory and the final mAP agree within
  tests/test_main_cli.py's tolerances (rtol 1e-3, atol 1e-4; mAP atol
  2e-3), and only rank 0 writes the log and checkpoint files.
- cfg.tpu.mesh_data_axis means what it means to the JAX package's main.py.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.io as sio
from PIL import Image

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data import dataloader as jax_loader
from os2d_tpu.data import dataset as jax_dataset
from os2d_torch.config import get_default_cfg
from os2d_torch.data import dataloader as port_loader
from os2d_torch.data import dataset as port_dataset
from os2d_torch.main import requested_mesh_size
from os2d_torch.parallel.spawn import free_port
from os2d_torch.utils import logger as port_logger
from test_main_cli import IMG_W, write_grozi_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 300


def _save_img(path, rng, w=120, h=90):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(path)


def write_retail_trees(data_path):
    """dairy and paste: classes/<name>.csv (with imagefilename and
    classfilename left to their defaults in paste) and src/original."""
    rng = np.random.RandomState(3)
    for name in ("dairy", "paste"):
        root = os.path.join(data_path, name)
        rows = []
        for image_id in range(3):
            _save_img(os.path.join(root, "src", "original", f"{image_id}.jpg"), rng, 160, 120)
            for k in range(2):
                cid = (image_id + k) % 3
                rows.append(dict(imageid=image_id, classid=cid, gtbboxid=len(rows),
                                 difficult=int(k == 1), lx=0.1 * k, ty=0.2, rx=0.5 + 0.1 * k,
                                 by=0.7))
        for cid in range(3):
            _save_img(os.path.join(root, "classes", "images", f"{cid}.jpg"), rng, 40, 40)
        df = pd.DataFrame(rows)
        if name == "dairy":
            df["imagefilename"] = [f"{i}.jpg" for i in df["imageid"]]
            df["classfilename"] = [f"{c}.jpg" for c in df["classid"]]
        df.to_csv(os.path.join(root, "classes", f"{name}.csv"), index=False)


def write_instre_tree(data_path):
    """gnd_instre.mat with S1 and S2 queries (and one INSTRE-M query, which
    the converter skips) over images with xywh boxes in .txt files."""
    rng = np.random.RandomState(4)
    root = os.path.join(data_path, "instre")
    qim, im, gnd = [], [], []
    # 20 classes of a set give 15 train, 1 val and 4 test classes
    for ci, tag in enumerate(["INSTRE-S1"] * 20 + ["INSTRE-S2"] * 20 + ["INSTRE-M"]):
        qrel = f"{tag}/{ci:02d}a_class/query.jpg"
        _save_img(os.path.join(root, qrel), rng)
        dbrel = f"{tag}/{ci:02d}a_class/db{ci}.jpg"
        _save_img(os.path.join(root, dbrel), rng)
        with open(os.path.join(root, dbrel).replace(".jpg", ".txt"), "w") as f:
            f.write(f"{10 + ci} 20 50 40\n")
        qim.append(np.array([qrel], dtype=object))
        im.append(np.array([dbrel], dtype=object))
        gnd.append((np.array([[len(im)]]), np.array([[5, 5, 40 + ci, 60]])))
    sio.savemat(os.path.join(root, "gnd_instre.mat"), {
        "qimlist": np.array(qim, dtype=object).reshape(1, -1),
        "imlist": np.array(im, dtype=object).reshape(1, -1),
        "gnd": np.array(gnd, dtype=[("ok", "O"), ("bbx", "O")]).reshape(1, -1)})


def write_imagenet_tree(data_path):
    """ImageNet-RepMet: a test episode (roidb and episode pickles) and the
    ILSVRC train/val XML annotations with one excluded class."""
    rng = np.random.RandomState(5)
    root = os.path.join(data_path, "ImageNet-RepMet")
    ilsvrc = os.path.join(root, "ILSVRC")
    swap = "/dccstor/leonidka1/data/imagenet/ILSVRC/"
    _save_img(os.path.join(ilsvrc, "q0.jpg"), rng)
    _save_img(os.path.join(ilsvrc, "img0.jpg"), rng, 200, 150)
    roidb = {"roidb": [{"image": swap + "img0.jpg", "flipped": False, "width": 200,
                        "height": 150, "boxes": np.array([[10, 10, 100, 100], [5, 5, 50, 60]]),
                        "gt_classes": np.array([7, 9])}]}
    episode = {"epi_cats": [7], "epi_cats_names": ["class7"],
               "query_images": [swap + "img0.jpg"],
               "train_boxes": [(7, None, swap + "q0.jpg", np.array([5, 5, 80, 60]))]}
    data_dir = os.path.join(root, "RepMet_CVPR2019_data", "data", "Imagenet_LOC")
    os.makedirs(os.path.join(data_dir, "episodes"), exist_ok=True)
    with open(os.path.join(data_dir, "voc_inloc_roidb.pkl"), "wb") as f:
        pickle.dump(roidb, f)
    with open(os.path.join(data_dir, "episodes", "epi_inloc_in_domain_1_5_10_500.pkl"),
              "wb") as f:
        pickle.dump([episode], f)

    with open(os.path.join(root, "repmet_test_classes.txt"), "w") as f:
        f.write("n00000002\n")
    ann = os.path.join(ilsvrc, "Annotations", "CLS-LOC")
    images = os.path.join(ilsvrc, "Data", "CLS-LOC")
    for split, cls, idx in [("train", "n00000001", 0), ("train", "n00000001", 1),
                            ("train", "n00000002", 0), ("val", "n00000001", 0),
                            ("val", "n00000002", 1), ("val", "n00000003", 2)]:
        stem = f"{cls}_{idx}" if split == "train" else f"ILSVRC2012_val_{cls[-1]}{idx}"
        folder = os.path.join(ann, "train", cls) if split == "train" else os.path.join(ann, "val")
        img_dir = os.path.join(images, "train", cls) if split == "train" else os.path.join(
            images, "val")
        _save_img(os.path.join(img_dir, stem + ".JPEG"), rng, 100, 80)
        objs = "".join(
            f"<object><name>{name}</name><difficult>{d}</difficult><bndbox><xmin>{x}</xmin>"
            f"<ymin>10</ymin><xmax>{x + 30}</xmax><ymax>60</ymax></bndbox></object>"
            for name, d, x in [(cls, 0, 5), ("n00000002", 1, 40)])
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, stem + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{stem}</filename><size><width>100</width>"
                    f"<height>80</height></size>{objs}</annotation>")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree per package: the INSTRE and RepMet builders convert their
    sources on first use and write next to them."""
    paths = {}
    for package in ("jax", "port"):
        data_path = str(tmp_path_factory.mktemp(f"data_{package}"))
        write_grozi_tree(data_path)
        write_retail_trees(data_path)
        write_instre_tree(data_path)
        write_imagenet_tree(data_path)
        paths[package] = data_path
    return paths


DATASETS = ["grozi-train", "grozi-train-mini", "grozi-val-new-cl", "grozi-val-old-cl",
            "grozi-val-all", "dairy", "paste-v", "paste-f", "instre-all", "instre-s1-train",
            "instre-s1-val", "instre-s1-test", "instre-s2-train", "instre-s2-val",
            "instre-s2-test",
            "imagenet-repmet-test-episode-0", "imagenet-repmet-train",
            "imagenet-repmet-val-2"]


def assert_same_dataset(got, want):
    pd.testing.assert_frame_equal(got.gtboxframe, want.gtboxframe)
    assert list(got.image_ids) == list(want.image_ids)
    assert list(got.image_file_names) == list(want.image_file_names)
    np.testing.assert_array_equal(got.get_class_ids(), want.get_class_ids())
    assert (got.name, got.image_size, got.eval_scale) == (want.name, want.image_size,
                                                          want.eval_scale)
    assert got.gt_path == want.gt_path and got.image_path == want.image_path


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_builder_matches_jax(trees, name):
    want = jax_dataset.build_dataset_by_name(trees["jax"], name, eval_scale=300)
    got = port_dataset.build_dataset_by_name(trees["port"], name, eval_scale=300)
    want.gt_path = want.gt_path and want.gt_path.replace(trees["jax"], trees["port"])
    want.image_path = want.image_path.replace(trees["jax"], trees["port"])
    assert_same_dataset(got, want)
    assert got.num_images > 0 and got.num_boxes > 0
    assert {i: tuple(s) for i, s in got.image_size_per_image_id.items()} == {
        i: tuple(s) for i, s in want.image_size_per_image_id.items()}
    assert list(got.gt_images_per_classid) == list(want.gt_images_per_classid)
    for image_id in got.image_ids:
        a = got.get_image_annotation_for_imageid(image_id)
        b = want.get_image_annotation_for_imageid(image_id)
        np.testing.assert_array_equal(a.bbox_xyxy, b.bbox_xyxy)
        for field in ("labels", "difficult"):
            np.testing.assert_array_equal(a.get_field(field), b.get_field(field))


def test_dataset_builder_without_reading_images(trees):
    got = port_dataset.build_dataset_by_name(trees["port"], "grozi-train", eval_scale=300,
                                             no_image_reading=True)
    want = jax_dataset.build_dataset_by_name(trees["jax"], "grozi-train", eval_scale=300,
                                             no_image_reading=True)
    pd.testing.assert_frame_equal(got.gtboxframe, want.gtboxframe)
    assert not hasattr(got, "image_size_per_image_id")
    with pytest.raises(RuntimeError, match="Unknown dataset"):
        port_dataset.build_dataset_by_name(trees["port"], "coco", eval_scale=300)


def _eval_cfgs(names, scales):
    out = []
    for cfg in (jax_default_cfg(), get_default_cfg()):
        cfg.eval.dataset_names = names
        cfg.eval.dataset_scales = scales
        cfg.eval.scales_of_image_pyramid = [0.5, 1.0]
        cfg.eval.batch_size = 2
        out.append(cfg)
    return out


@pytest.mark.parametrize("names,scales", [(["grozi-val-new-cl", "dairy"], [240]),
                                          (["paste-f"], [200, 300])])
def test_eval_dataloaders_match_jax(trees, names, scales):
    jcfg, cfg = _eval_cfgs(names, scales)
    extra_j = jax_dataset.build_dataset_by_name(trees["jax"], "grozi-train-mini", eval_scale=320)
    extra_p = port_dataset.build_dataset_by_name(trees["port"], "grozi-train-mini",
                                                 eval_scale=320)
    want = jax_loader.build_eval_dataloaders_from_cfg(jcfg, datasets_for_eval=[extra_j],
                                                      data_path=trees["jax"])
    got = port_loader.build_eval_dataloaders_from_cfg(cfg, datasets_for_eval=[extra_p],
                                                      data_path=trees["port"])
    assert len(got) == len(want) == max(len(names), len(scales)) + 1
    for g, w in zip(got, want):
        assert g.get_name() == w.get_name()
        pd.testing.assert_frame_equal(g.dataset.gtboxframe, w.dataset.gtboxframe)
        assert g.dataset.eval_scale == w.dataset.eval_scale
        np.testing.assert_allclose(g.pyramid_scales_eval, w.pyramid_scales_eval, rtol=1e-12)
        assert g.batch_size == w.batch_size
        assert g.class_shape_palette == w.class_shape_palette


def test_train_dataloader_by_name_matches_jax(trees):
    jcfg, cfg = jax_default_cfg(), get_default_cfg()
    for c in (jcfg, cfg):
        c.train.dataset_name = "grozi-train"
        c.train.dataset_scale = IMG_W
        c.eval.train_subset_for_eval_size = 3
    want, want_subsets = jax_loader.build_train_dataloader_from_config(
        jcfg, data_path=trees["jax"])
    got, got_subsets = port_loader.build_train_dataloader_from_config(
        cfg, None, data_path=trees["port"], seed=0)
    pd.testing.assert_frame_equal(got.dataset.gtboxframe, want.dataset.gtboxframe)
    np.testing.assert_allclose(got.pyramid_scales_eval, want.pyramid_scales_eval, rtol=1e-12)
    assert [s.name for s in got_subsets] == [s.name for s in want_subsets]
    assert list(got_subsets[0].image_ids) == list(want_subsets[0].image_ids)
    # the port's earlier form, a dataset in the second place, is the same loader
    again, _ = port_loader.build_train_dataloader_from_config(cfg, got.dataset, seed=0)
    assert again.dataset is got.dataset
    with pytest.raises(ValueError, match="data_path"):
        port_loader.build_train_dataloader_from_config(cfg)


MAIN_OPTS = [
    "train.do_training", "True",
    "train.dataset_name", "grozi-train",
    "train.dataset_scale", str(IMG_W),
    "train.batch_size", "2",
    "train.class_batch_size", "2",
    "train.augment.train_patch_width", "192",
    "train.augment.train_patch_height", "192",
    "train.optim.max_iter", "4",
    "train.cache_images", "True",
    "model.class_image_size", "128",
    "eval.dataset_names", '["grozi-val-new-cl"]',
    "eval.dataset_scales", f"[{IMG_W}]",
    "eval.scales_of_image_pyramid", "[1.0]",
    "eval.iter", "2",
    "eval.cache_images", "True",
    "output.save_log_to_file", "True",
]


def _launch(data_path, out_path, ranks):
    env = dict(os.environ, OS2D_DEVICE="cpu", DATA_PATH=data_path, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    opts = MAIN_OPTS + ["output.path", out_path]
    if ranks == 1:
        cmd = [sys.executable, "-m", "os2d_torch.main"] + opts
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={ranks}",
               "--master_addr=localhost", f"--master_port={free_port()}", "-m",
               "os2d_torch.main"] + opts + ["tpu.distributed_init", "True"]
    return subprocess.Popen(cmd, env=env, cwd=out_path, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def main_runs(trees, tmp_path_factory):
    """The CLI in one process and as 2 ranks, at once."""
    data_path = str(tmp_path_factory.mktemp("main_data"))
    write_grozi_tree(data_path)
    outs = {ranks: str(tmp_path_factory.mktemp(f"main_out{ranks}")) for ranks in (1, 2)}
    procs = {ranks: _launch(data_path, out, ranks) for ranks, out in outs.items()}
    logs = {}
    try:
        for ranks, proc in procs.items():
            logs[ranks] = proc.communicate(timeout=RUN_TIMEOUT_S)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for ranks, proc in procs.items():
        assert proc.returncode == 0, logs[ranks][-4000:]
    return {ranks: (out, logs[ranks]) for ranks, out in outs.items()}


def test_main_two_ranks_match_one_process(main_runs):
    logs = {}
    for ranks, (out, _) in main_runs.items():
        with open(os.path.join(out, "train_log.pkl"), "rb") as f:
            logs[ranks] = pickle.load(f)
    one, two = (np.asarray(logs[r]["train_loss"], np.float64) for r in (1, 2))
    assert one.shape == two.shape
    finite = np.isfinite(one)
    assert (finite == np.isfinite(two)).all() and finite.sum() >= 2, (one, two)
    np.testing.assert_allclose(two[finite], one[finite], rtol=1e-3, atol=1e-4)
    keys = [k for k in logs[1] if k.startswith("mAP@")]
    assert keys
    for k in keys:
        assert np.isclose(logs[1][k][-1], logs[2][k][-1], atol=2e-3, equal_nan=True), k
    assert "Data-parallel training over 2 ranks (1 images/rank)" in main_runs[2][1]


def test_main_only_rank_zero_writes(main_runs):
    for ranks, (out, _) in main_runs.items():
        assert sorted(os.listdir(out)) == ["checkpoint_iter_0.pth", "checkpoint_iter_4.pth",
                                           "log.txt", "train_log.pkl"]
        with open(os.path.join(out, "log.txt")) as f:
            assert f.read().count("Start training") == 1, ranks


def test_logger_writes_nothing_off_rank_zero(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(port_logger, "primary_host", lambda: False)
    model = torch.nn.Linear(2, 2)
    path = port_logger.checkpoint_model(model, None, str(tmp_path / "ckpt"), i_iter=3)
    assert path.endswith("checkpoint_iter_3.pth") and not os.path.exists(path)
    port_logger.log_meters({}, 0.0, 0, str(tmp_path / "log"), meters_running={"loss": 1.0})
    logger = port_logger.setup_logger("OS2D.test_rank1", str(tmp_path / "txt"))
    logger.info("not in a file")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("axis,world,want", [(-1, 1, 1), (0, 1, 1), (1, 4, 1), (-1, 4, 4),
                                             (2, 4, 2), (8, 4, 1)])
def test_mesh_data_axis_means_what_jax_main_means(axis, world, want, caplog):
    cfg = get_default_cfg()
    cfg.tpu.mesh_data_axis = axis
    import logging

    logger = logging.getLogger("OS2D.test_mesh_axis")
    with caplog.at_level(logging.WARNING, logger="OS2D.test_mesh_axis"):
        assert requested_mesh_size(cfg, world, logger) == want
    assert ("running single-device" in caplog.text) == (axis > world)
