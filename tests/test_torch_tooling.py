"""The port's tooling twins on the CPU:

- log mining (`os2d_torch.utils.logger`) on the log.txt and train_log.pkl
  that the port's `trainval_loop` writes at the recipe of
  tests/test_torch_train_loop.py (one step, evaluations of one image before
  and after it and a final one): `extract_map_value_from_os2d_log` gives the final
  evaluation's mAP, `extract_pattern_after_marked_line` and `mine_log_value`
  equal the JAX package's on the same files;
- the launcher (`os2d_torch.utils.launcher`): the local and SLURM scripts of
  `python -m os2d_torch.main` jobs, a local job that runs, and --xpk refused;
- tools/get_dataset_scales_torch.py against tools/get_dataset_scales.py on
  the synthetic dataset trees of tests/test_torch_main.py: equal object-size
  statistics and eval scales;
- `os2d_torch.utils.profiling`: `trace` writes a trace with the `annotate`d
  region, `StageTimer` sums its stages (the port's own spans:
  tests/test_torch_spans.py).
"""

import json
import math
import os
import pickle
import random

import numpy as np
import pytest
import torch

from os2d_tpu.utils import logger as jlogger
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import DataloaderOneShotDetection, build_train_dataloader_from_config
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import trainable_parameters, trainval_loop
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.utils import launcher, logger, profiling
from test_torch_main import write_grozi_tree, write_instre_tree, write_retail_trees
from test_torch_train_data import port_dataset, train_cfg
from test_train import make_dataset
from tools import get_dataset_scales as jscales
from tools import get_dataset_scales_torch as tscales


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (as tests/test_torch_evaluate.py): under the
    suite's workers sharing the cores, torch's OpenMP teams otherwise wait on
    each other's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_log_mining_on_a_log_of_the_port(tmp_path):
    jds = make_dataset(str(tmp_path / "data"), np.random.RandomState(0))
    tds = port_dataset(jds)
    cfg = train_cfg(get_default_cfg(), augment=False)
    cfg.train.optim.max_iter = 1
    cfg.eval.iter = 1
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.tpu.eval_pre_top_k = 64
    cfg.tpu.eval_top_k = 16
    cfg.tpu.device_class_cache = "off"
    out = str(tmp_path / "out")
    cfg.output.path = out
    log = logger.setup_logger("OS2D", out)
    try:
        loader, _ = build_train_dataloader_from_config(cfg, tds, seed=0)
        eval_loader = DataloaderOneShotDetection(tds.copy_subset(1), batch_size=1,
                                                 gt_image_size=128, pyramid_scales_eval=[1.0])
        model = Os2dModel(Os2dConfig(class_image_size=128), device="cpu", seed=0)
        full_log, meters = trainval_loop(
            loader, model, cfg, ObjectiveConfig(),
            create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train)),
            dataloaders_eval=[eval_loader])
    finally:
        for handler in list(log.handlers):
            handler.close()
            log.removeHandler(handler)
    name = eval_loader.get_name()
    log_txt = os.path.join(out, "log.txt")
    final = meters[name]["mAP@0.50"]
    assert logger.extract_map_value_from_os2d_log(log_txt, name) == pytest.approx(final,
                                                                                   abs=1e-4)
    assert logger.extract_map_value_from_os2d_log(log_txt, "no-such-dataset") is None
    marker, pattern = f"Starting evaluation on {name}", r"mAP@0.50\D*([-+]?\d*\.?\d+)"
    got = logger.extract_pattern_after_marked_line(log_txt, marker, pattern)
    assert len(got) == 3
    assert got == jlogger.extract_pattern_after_marked_line(log_txt, marker, pattern)

    with open(os.path.join(out, "train_log.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert saved.keys() == full_log.keys()
    saved["train_loss"][0] = float("nan")  # a NaN-padded entry
    for series in (f"mAP@0.50_{name}", "train_loss", "no-such-series"):
        for mode in ("max", "min", "first", "last"):
            got = logger.mine_log_value(saved, series, mode)
            want = jlogger.mine_log_value(saved, series, mode)
            assert got == want or (got is not None and math.isnan(got) and math.isnan(want))
    with pytest.raises(ValueError):
        logger.mine_log_value(saved, f"mAP@0.50_{name}", "median")


def test_launcher_scripts(tmp_path, capsys):
    queue = launcher.JobQueue()
    cmd1 = launcher.main_command("exp/config.yml", {"output.path": "out/a", "train.optim.lr": 0.01})
    cmd2 = launcher.main_command(overrides="tpu.eval_class_chunk 32", num_gpus=4)
    assert cmd1 == ("python -m os2d_torch.main --config-file exp/config.yml "
                    "output.path out/a train.optim.lr 0.01")
    assert cmd2 == ("torchrun --standalone --nproc_per_node=4 -m os2d_torch.main "
                    "tpu.eval_class_chunk 32 tpu.distributed_init True")
    queue.add_job("a", str(tmp_path / "a"), [cmd1])
    queue.add_job("b", str(tmp_path / "b"), [cmd2, "echo done"], log_file_prefix="p_")

    args = launcher.parse_arguments(argv=["--slurm", "--no-launch", "--num-gpus", "4",
                                          "-p", "gpu", "--timeout", "2", "--job-indices", "1"])
    assert queue.launch_all_jobs(args) == [f"sbatch {tmp_path / 'b' / 'p_launch.sh'}"]
    script = (tmp_path / "b" / "p_launch.sh").read_text()
    for line in ("#SBATCH --gres=gpu:4", "#SBATCH --partition gpu", "#SBATCH --time=120",
                 "#SBATCH --job-name=b", "nvidia-smi", cmd2, "echo done",
                 "export OMP_NUM_THREADS=${EXP_NUM_CPU_THREADS}"):
        assert line in script, line
    assert not (tmp_path / "a").exists()

    args = launcher.parse_arguments(argv=["--no-launch", "--job-names", "a"])
    (cmd,) = queue.launch_all_jobs(args)
    assert cmd.startswith(f"bash {tmp_path / 'a' / 'launch.sh'}")
    script = (tmp_path / "a" / "launch.sh").read_text()
    assert cmd1 in script and "nvidia-smi" in script and "#SBATCH" not in script

    run = launcher.JobQueue()
    run.add_job("hello", str(tmp_path / "run"), ["echo hello-from-the-job"])
    run.launch_all_jobs(launcher.parse_arguments(argv=[]))
    assert "hello-from-the-job" in (tmp_path / "run" / "out.txt").read_text()
    assert "hello-from-the-job" in capsys.readouterr().out

    with pytest.raises(ValueError, match="TPU"):
        queue.launch_all_jobs(launcher.parse_arguments(argv=["--xpk"]))


SCALE_DATASETS = ["grozi-val-new-cl", "paste-f", "instre-s2-val"]


def test_dataset_scales_match_the_jax_tool(tmp_path):
    data_path = str(tmp_path)
    write_grozi_tree(data_path)
    write_retail_trees(data_path)
    write_instre_tree(data_path)
    got = tscales.main(["--data-path", data_path, "--datasets", *SCALE_DATASETS])
    assert list(got) == SCALE_DATASETS
    for name in SCALE_DATASETS:
        dataset = jscales.build_dataset_by_name(data_path, name, eval_scale=None)
        stats = jscales.compute_object_size_stats(dataset.gtboxframe,
                                                  jscales.get_image_sizes(dataset))
        r = got[name]
        assert (r["avg"], r["median"], r["q10"], r["q90"]) == stats, name
        assert r["image_size"] == dataset.image_size
        assert r["eval_scale"] == int(dataset.image_size * 240 / stats[1])


def test_trace_annotate_and_stage_timer(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("os2d_region"):
            (x @ x).sum()
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any(e.get("name") == "os2d_region" for e in trace["traceEvents"])

    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("matmul", sync_value=x):
            x @ x
    with timer.stage("host"):
        random.random()
    summary = timer.summary()
    assert summary["matmul"]["count"] == 3 and summary["host"]["count"] == 1
    assert summary["matmul"]["total_s"] > 0
    assert summary["matmul"]["mean_s"] == pytest.approx(summary["matmul"]["total_s"] / 3)
