"""Experiment job launcher for the port: local bash scripts or SLURM batch
scripts that run `python -m os2d_torch.main`.

The twin of `os2d_tpu/utils/launcher.py` (the reference's
os2d/utils/launcher.py:1-291): an experiment script queues jobs on a
`JobQueue` (`add_job`) and launches them locally (bash script + tee) or as
sbatch scripts with `--gres=gpu:N`. A job on several cards of one node runs
under `torchrun` (`main_command`). Each job script prints the node, the git
commit and the cards (`nvidia-smi`) before and after its commands. XPK (TPU
pods) is the JAX package's alone: `--xpk` is parsed, so that the same
command lines parse, and refused.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess


def create_args_parser():
    parser = argparse.ArgumentParser(description="Launching experiments locally or with SLURM")
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--job-names", default=None, nargs="+", type=str,
                       help="Launch only jobs with these names")
    group.add_argument("--job-indices", default=None, nargs="+", type=int,
                       help="Launch only jobs with these indices")
    parser.add_argument("--venv", type=str, default=None,
                        help="Activate this virtualenv in the job")
    parser.add_argument("--slurm", action="store_true",
                        help="Prepare sbatch scripts and submit them")
    parser.add_argument("--xpk", action="store_true",
                        help="TPU pods (os2d_tpu only; refused here)")
    parser.add_argument("--no-launch", action="store_true",
                        help="Only generate commands, do not run")
    parser.add_argument("-p", "--partition", type=str, default=None, help="SLURM partition")
    parser.add_argument("--num-gpus", type=int, default=1,
                        help="cards per job (SLURM --gres=gpu:N)")
    parser.add_argument("--num-cpus", type=int, default=4,
                        help="CPUs per job (SLURM) / host threads pinned")
    parser.add_argument("--timeout", type=float, default=None, help="Job timeout in hours")
    parser.add_argument("--exclusive-node", action="store_true")
    parser.add_argument("--exclude-nodes", type=str, nargs="+", default=None)
    parser.add_argument("--nodelist", type=str, default=None)
    parser.add_argument("--stdout-file", type=str, default="out.txt")
    parser.add_argument("--stderr-file", type=str, default="err.txt")
    return parser


def parse_arguments(parser=None, argv=None):
    return (parser or create_args_parser()).parse_args(argv)


def parameters_to_str(d):
    """OrderedDict of CLI params -> 'k1 v1 k2 v2 ...' (reference launcher)."""
    return " ".join(f"{k} {v}" for k, v in d.items())


def main_command(config_file=None, overrides="", num_gpus=1):
    """The command of one training or eval run of the port: `python -m
    os2d_torch.main`, or on several cards of one node `torchrun
    --standalone --nproc_per_node=N -m os2d_torch.main ... tpu.distributed_init
    True` (one process per card, nccl). `overrides` are dotted config keys
    and values, a string or a dict (`parameters_to_str`)."""
    if isinstance(overrides, dict):
        overrides = parameters_to_str(overrides)
    args = f" --config-file {shlex.quote(config_file)}" if config_file else ""
    args += f" {overrides}" if overrides else ""
    if num_gpus > 1:
        return (f"torchrun --standalone --nproc_per_node={num_gpus} -m os2d_torch.main{args}"
                " tpu.distributed_init True")
    return f"python -m os2d_torch.main{args}"


def _echo_and_execute(out_f, command):
    out_f.write(f'echo "{command}"\n{command}\necho\n')


def _echo_system_info(out_f):
    out_f.write('echo "Working on node `hostname`"\n')
    _echo_and_execute(out_f, "git show -s --pretty=format:'%H' || true")
    _echo_and_execute(out_f, "nvidia-smi || true")


def _set_num_cpu_threads(out_f, num_cpus):
    out_f.write(f"export EXP_NUM_CPU_THREADS={num_cpus}\n")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        out_f.write(f"export {var}=${{EXP_NUM_CPU_THREADS}}\n")
    out_f.write("\n")


def run_job_locally(job_command, log_path, args, no_launch=False, log_file_prefix=""):
    cmd_file = os.path.join(log_path, log_file_prefix + "launch.sh")
    with open(cmd_file, "w") as out_f:
        if args.venv:
            out_f.write(f"source {args.venv}/bin/activate\n")
        _echo_system_info(out_f)
        _set_num_cpu_threads(out_f, args.num_cpus)
        out_f.write(job_command + "\n")
        _echo_system_info(out_f)
    stdout_path = os.path.join(log_path, log_file_prefix + args.stdout_file)
    stderr_path = os.path.join(log_path, log_file_prefix + args.stderr_file)
    return _run_cmd(f"bash {cmd_file} 2>{stderr_path} | tee -a {stdout_path}", no_launch)


def run_job_slurm(job_command, log_path, args, job_name=None, no_launch=False,
                  log_file_prefix=""):
    launcher_file = os.path.join(log_path, log_file_prefix + "launch.sh")
    with open(launcher_file, "w") as out_f:
        out_f.write("#!/bin/bash\n")
        if args.exclusive_node:
            out_f.write("#SBATCH --exclusive=user\n")
        if args.partition:
            out_f.write(f"#SBATCH --partition {args.partition}\n")
        out_f.write(f"#SBATCH --gres=gpu:{args.num_gpus}\n")
        out_f.write(f"#SBATCH --cpus-per-task={args.num_cpus}\n")
        if job_name:
            out_f.write(f"#SBATCH --job-name={job_name}\n")
        out_f.write(f"#SBATCH --output={os.path.join(log_path, log_file_prefix + args.stdout_file)}\n")
        out_f.write(f"#SBATCH --error={os.path.join(log_path, log_file_prefix + args.stderr_file)}\n")
        if args.exclude_nodes:
            out_f.write(f"#SBATCH --exclude={','.join(args.exclude_nodes)}\n")
        if args.nodelist:
            out_f.write(f"#SBATCH --nodelist={args.nodelist}\n")
        if args.timeout:
            out_f.write(f"#SBATCH --time={int(args.timeout * 60)}\n")
        out_f.write("\n")
        if args.venv:
            _echo_and_execute(out_f, f"source {args.venv}/bin/activate")
        _echo_system_info(out_f)
        _set_num_cpu_threads(out_f, args.num_cpus)
        out_f.write(f"{job_command}\n\n")
        _echo_system_info(out_f)
    return _run_cmd(f"sbatch {launcher_file}", no_launch)


class JobQueue:
    """The jobs of one experiment script, launched in order by
    `launch_all_jobs` (the JAX package keeps them in module lists)."""

    def __init__(self):
        self.jobs = []

    def add_job(self, job_name="", log_path="", commands=(), log_file_prefix=""):
        self.jobs.append((job_name, log_path, list(commands), log_file_prefix))

    def launch_all_jobs(self, args):
        """Write and run (or, with --no-launch, print) each selected job's
        script; returns the commands that ran them."""
        if args.xpk:
            raise ValueError("--xpk submits TPU pod workloads and belongs to os2d_tpu's "
                             "launcher; os2d_torch runs jobs locally or under SLURM")
        launched = []
        for i_job, (job_name, log_path, commands, prefix) in enumerate(self.jobs):
            selected = ((args.job_names is None and args.job_indices is None)
                        or (args.job_names is not None and job_name in args.job_names)
                        or (args.job_indices is not None and i_job in args.job_indices))
            if not selected:
                continue
            print(f"{'Launching' if not args.no_launch else 'Preparing'} job #{i_job}: {job_name}")
            if log_path:
                os.makedirs(log_path, exist_ok=True)
            job_command = "\n\n".join(commands)
            if args.slurm:
                launched.append(run_job_slurm(job_command, log_path, args, job_name=job_name,
                                              no_launch=args.no_launch, log_file_prefix=prefix))
            else:
                launched.append(run_job_locally(job_command, log_path, args,
                                                no_launch=args.no_launch, log_file_prefix=prefix))
            print("success", flush=True)
        return launched


def _run_cmd(cmd, no_launch=False):
    if no_launch:
        print(cmd)
        return cmd
    p = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for line in p.stdout:
        print(line.decode("utf-8"), end="")
    p.wait()
    return cmd
