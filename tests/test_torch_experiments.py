"""The experiment launchers' twins (experiments/*_torch.py) against the JAX
package's launchers (experiments/*.py) on the CPU.

Both scripts of each pair are copied, with experiments/config_training.yml,
into a temporary experiments/ folder, so that their jobs' log folders (under
../output) land there, and run as `__main__` with --no-launch: each writes a
job script per job and prints it. The twin's jobs have the JAX launcher's
names, log folders and log prefixes, and its commands are JAX's with
`python main.py` replaced by the port's entry point (`python -m
os2d_torch.main`); every command parses through `os2d_torch.main.parse_opts`
as a shell would split it. The two collect scripts print the same table as
JAX's from the same synthetic logs.
"""

import os
import pickle
import runpy
import shlex
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = os.path.join(ROOT, "experiments")
JAX_MAIN = "python main.py"
PORT_MAIN = "python -m os2d_torch.main"


@pytest.fixture
def workdir(tmp_path):
    """A copy of experiments/ (scripts and config) under tmp_path."""
    exp = tmp_path / "experiments"
    exp.mkdir()
    for name in os.listdir(EXPERIMENTS):
        if name.endswith((".py", ".yml")):
            shutil.copy(os.path.join(EXPERIMENTS, name), exp / name)
    return tmp_path


def run_script(path, argv, monkeypatch, capsys):
    """Run `path` as __main__ with `argv`; returns its stdout."""
    monkeypatch.setattr(sys, "argv", [str(path)] + list(argv))
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out


def prepared_jobs(out, workdir):
    """[(job line, job script, its command line)] of a --no-launch run: the
    line after the thread-count exports in each launch.sh the run printed."""
    jobs = []
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if line.startswith("Preparing job #"):
            launch = lines[i + 1].split()[1]  # "bash <launch.sh> 2>... | tee ..."
            assert launch.startswith(str(workdir))
            with open(launch) as f:
                body = f.read().splitlines()
            start = body.index("export NUMEXPR_NUM_THREADS=${EXP_NUM_CPU_THREADS}") + 2
            jobs.append((line, os.path.relpath(launch, workdir), body[start]))
    return jobs


LAUNCHERS = [
    ("launcher_grozi_eval", []),
    ("launcher_grozi_eval", ["--v1", "--backbone-arch", "ResNet101",
                             "--model-path", "some/model.pkl"]),
    ("launcher_exp1", []),
    ("launcher_exp2", []),
    ("launcher_instre_eval", []),
    ("launcher_instre_eval", ["--train", "--backbone-arch", "ResNet101"]),
    ("launcher_imagenet_eval", ["--episodes", "0", "7", "--model-path", "m.pth",
                                "--eval-scale", "300"]),
    ("launcher_exp1", ["--job-indices", "3", "9"]),
]


@pytest.mark.parametrize("name,argv", LAUNCHERS,
                         ids=[f"{n}{'_' + a[0].strip('-') if a else ''}" for n, a in LAUNCHERS])
def test_launcher_twin_prepares_jax_jobs(name, argv, workdir, monkeypatch, capsys):
    from os2d_tpu.utils import launcher as jax_launcher
    from os2d_torch.main import parse_opts

    for queue in ("JOB_QUEUE_NAMES", "JOB_QUEUE_PATHS", "JOB_QUEUE_COMMANDS",
                  "JOB_QUEUE_LOG_FILE_PREFIX"):
        monkeypatch.setattr(jax_launcher, queue, [])
    exp = workdir / "experiments"
    want = prepared_jobs(run_script(exp / f"{name}.py", ["--no-launch"] + argv, monkeypatch,
                                    capsys), workdir)
    got = prepared_jobs(run_script(exp / f"{name}_torch.py", ["--no-launch"] + argv,
                                   monkeypatch, capsys), workdir)
    assert want and len(got) == len(want)
    for (got_line, got_script, got_cmd), (want_line, want_script, want_cmd) in zip(got, want):
        assert (got_line, got_script) == (want_line, want_script)
        assert want_cmd.startswith(JAX_MAIN + " ")
        assert got_cmd == PORT_MAIN + want_cmd[len(JAX_MAIN):]
        tokens = shlex.split(got_cmd)[len(PORT_MAIN.split()):]
        cfg, config_file = parse_opts(tokens)
        assert config_file == str(exp / "config_training.yml")
        opts = dict(zip(tokens[2::2], tokens[3::2]))
        assert cfg.output.path == opts["output.path"]
        if "eval.dataset_names" in opts:
            assert list(cfg.eval.dataset_names) == [opts["eval.dataset_names"][2:-2]]


def test_launcher_twin_on_several_cards(workdir, monkeypatch, capsys):
    """--num-gpus N: each job runs under torchrun, its overrides before
    tpu.distributed_init, and parses."""
    from os2d_torch.main import parse_opts

    out = run_script(workdir / "experiments" / "launcher_grozi_eval_torch.py",
                     ["--no-launch", "--num-gpus", "4", "--job-indices", "4"],
                     monkeypatch, capsys)
    (_, _, cmd), = prepared_jobs(out, workdir)
    head = "torchrun --standalone --nproc_per_node=4 -m os2d_torch.main "
    assert cmd.startswith(head) and cmd.endswith(" tpu.distributed_init True")
    cfg, _ = parse_opts(shlex.split(cmd[len(head):]))
    assert cfg.tpu.distributed_init and cfg.eval.class_image_augmentation == "rotation90"
    assert list(cfg.eval.dataset_names) == ["paste-f"]


def test_grozi_eval_twin_takes_the_ports_checkpoint(tmp_path):
    """In a training job's folder the JAX trainer's .pkl is the default; the
    port's .pth of the same name is taken where only it exists."""
    from os2d_torch.utils.launcher import resolve_checkpoint

    name = "checkpoint_best_model_grozi-val-new-cl_mAP@0.50"
    assert resolve_checkpoint(str(tmp_path), name + ".pkl") == str(tmp_path / (name + ".pkl"))
    (tmp_path / (name + ".pth")).write_bytes(b"")
    assert resolve_checkpoint(str(tmp_path), name + ".pkl") == str(tmp_path / (name + ".pth"))
    (tmp_path / (name + ".pkl")).write_bytes(b"")
    assert resolve_checkpoint(str(tmp_path), name + ".pkl") == str(tmp_path / (name + ".pkl"))
    assert resolve_checkpoint(str(tmp_path / (name + ".pth")), "x") == str(
        tmp_path / (name + ".pth"))


def test_exp3_twin_calls_the_instre_twin(workdir, monkeypatch):
    import subprocess

    calls = []
    monkeypatch.setattr(subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    exp = workdir / "experiments"
    for name in ("launcher_exp3_instre.py", "launcher_exp3_instre_torch.py"):
        monkeypatch.setattr(sys, "argv", [name, "--no-launch", "--slurm"])
        with pytest.raises(SystemExit) as e:
            runpy.run_path(str(exp / name), run_name="__main__")
        assert e.value.code == 0
    (jax_cmd, port_cmd) = calls
    assert jax_cmd[1] == str(exp / "launcher_instre_eval.py")
    assert port_cmd[1] == str(exp / "launcher_instre_eval_torch.py")
    assert jax_cmd[0] == port_cmd[0] and jax_cmd[2:] == port_cmd[2:] == [
        "--train", "--no-launch", "--slurm"]


EVAL_LOG = """2026-01-01 00:00:00 OS2D.eval INFO: Evaluating on {name}
2026-01-01 00:00:00 OS2D.eval INFO: Starting evaluation on {name}
2026-01-01 00:00:09 OS2D.eval INFO: {name}: mAP@0.50 {v1} recall@0.50 0.5
2026-01-01 00:00:10 OS2D.eval INFO: Evaluating on {name}
2026-01-01 00:00:10 OS2D.eval INFO: Starting evaluation on {name}
2026-01-01 00:00:19 OS2D.eval INFO: {name}: loss 0.1, mAP@0.50 = {v2}, mAP@0.70 {v3}
"""


def test_eval_collect_twin_prints_jax_table(workdir, monkeypatch, capsys):
    """Eval logs that carry both packages' markers (the reference's
    "Evaluating on", which the JAX script looks for, and the port's
    "Starting evaluation on"), one log without a value, one other file."""
    root = workdir / "output" / "eval"
    for name, body in (("grozi-val-new-cl", EVAL_LOG.format(name="grozi-val-new-cl", v1=0.25,
                                                           v2=0.9065, v3=0.5)),
                       ("paste-f", EVAL_LOG.format(name="paste-f", v1=1e-3, v2="8.5e-1",
                                                  v3=0.1)),
                       ("dairy", "Evaluating on dairy\nStarting evaluation on dairy\n")):
        (root / name).mkdir(parents=True)
        (root / name / f"eval_{name}_out.txt").write_text(body)
    (root / "dairy" / "eval_dairy_err.txt").write_text("mAP@0.50 0.1\n")
    exp = workdir / "experiments"
    tables = {}
    for metric in ("mAP@0.50", "mAP@0.70"):
        argv = ["--log-root", str(root), "--metric", metric]
        want = run_script(exp / "launcher_eval_collect.py", argv, monkeypatch, capsys)
        got = run_script(exp / "launcher_eval_collect_torch.py", argv, monkeypatch, capsys)
        assert got == want and len(want.splitlines()) == 4
        tables[metric] = want
    assert "0.9065" in tables["mAP@0.50"] and "0.85" in tables["mAP@0.50"]
    assert "n/a" in tables["mAP@0.50"] and "0.1" in tables["mAP@0.70"]


def test_exp1_collect_twin_prints_jax_table(workdir, monkeypatch, capsys):
    nan = float("nan")
    logs = {"exp1.0.lossCL_seed0_ResNet50_init_imageNetCaffe2": [0.5, nan, 0.75, 0.625],
            "exp1.8.lossRLL_remap_invFullAffine_seed0_ResNet50_init_imageNetCaffe2": [nan],
            "exp1.2.lossRLL_remap_seed0_ResNet50_init_imageNetCaffe2": [0.9065]}
    root = workdir / "output" / "exp1"
    for job, series in logs.items():
        (root / job).mkdir(parents=True)
        with open(root / job / "train_log.pkl", "wb") as f:
            pickle.dump({"mAP@0.50_grozi-val-new-cl": series, "loss": [1.0]}, f)
    (root / "no_log_here").mkdir()
    exp = workdir / "experiments"
    want = run_script(exp / "launcher_exp1_collect.py", [], monkeypatch, capsys)
    got = run_script(exp / "launcher_exp1_collect_torch.py", [], monkeypatch, capsys)
    assert got == want
    assert len(want.splitlines()) == 4 and "0.75" in want and "n/a" in want
