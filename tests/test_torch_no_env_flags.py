"""The port carries no environment-variable switches: the twin of
tests/test_no_env_flags.py, over every module of os2d_torch/.

What changes the numerics or the schedule of a hot path is an argument or a
config key (`Os2dConfig`, cfg.tpu.*); environment overrides live in the
tools and the tests, which pass explicit values in.

Allowlist (each entry says why it is no such switch):
- parallel/mesh.py RANK, WORLD_SIZE, LOCAL_RANK (and MASTER_ADDR /
  MASTER_PORT through init_method="env://"): the rendezvous that torchrun
  describes; parallel/spawn.py writes the same variables for the ranks it
  starts.
- api/app.py OS2D_*: the app's deployment settings (device, checkpoint,
  pyramid, TTA, batching window), read where uvicorn imports it.
- main.py DATA_PATH and OS2D_DEVICE: where the datasets are and which
  device the entry point runs on, as the app's.
- ops/cuda.py CUDA_HOME: where the CUDA toolkit's nvcc is installed.
The launcher (utils/launcher.py) reads no variable: the scheduler's appear
only in the job scripts it writes.
"""

import pathlib
import re

PKG = pathlib.Path(__file__).resolve().parent.parent / "os2d_torch"

# (path relative to os2d_torch/, variable-name regex) pairs that may touch env
ALLOWLIST = [
    ("parallel/mesh.py", r"RANK|WORLD_SIZE|LOCAL_RANK|MASTER_"),
    ("parallel/spawn.py", r"RANK=.*WORLD_SIZE=.*LOCAL_RANK="),
    ("api/app.py", r"OS2D_"),
    ("main.py", r"DATA_PATH|OS2D_DEVICE"),
    ("ops/cuda.py", r"CUDA_HOME"),
]

_ENV_ACCESS = re.compile(r"\bos\.environ\b|\benviron\s*(\[|\.(get|setdefault|pop|update))|"
                         r"\bos\.getenv\b")


def _allowed(rel, line):
    return any(rel == path and re.search(pat, line) for path, pat in ALLOWLIST)


def test_port_has_no_env_reads():
    hits = []
    for py in sorted(PKG.rglob("*.py")):
        rel = str(py.relative_to(PKG))
        lines = py.read_text().splitlines()
        for i, line in enumerate(lines, 1):
            if _ENV_ACCESS.search(line) and not line.lstrip().startswith("#"):
                # a read whose variable name is on the next line
                if not (_allowed(rel, line) or _allowed(rel, line + " " + lines[min(i, len(lines) - 1)])):
                    hits.append(f"{py.relative_to(PKG.parent)}:{i}: {line.strip()}")
    assert not hits, "env switches in the port:\n" + "\n".join(hits)


def test_allowlist_entries_are_used():
    """Every entry matches a line of its file: none outlives its read."""
    for path, pat in ALLOWLIST:
        text = (PKG / path).read_text()
        assert any(_ENV_ACCESS.search(line) and re.search(pat, line + " " + nxt)
                   for line, nxt in zip(text.splitlines(), text.splitlines()[1:] + [""])), path
