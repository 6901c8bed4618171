"""What every run checks around the program: the cards it needs, the JAX
modules that may not be loaded, and the card's name and power limit."""

from __future__ import annotations

import subprocess
import sys

# top-level module names that no run may load: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "os2d_tpu")


def banned_modules(modules=None):
    """The banned top-level names among the loaded modules' (the part of
    each name before the first dot, compared whole)."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(BANNED))


def require_cards(count: int) -> str:
    """The card's name; raises SystemExit(2) without `count` CUDA cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"hopper_bench: the cell needs {count} CUDA card(s), found {found}",
              file=sys.stderr)
        raise SystemExit(2)
    return torch.cuda.get_device_name(0)


def power_limit_line() -> str:
    """nvidia-smi's name and power limit of each card, one line."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: not read ({e})"
    return "nvidia-smi: " + "; ".join(line.strip() for line in out.splitlines() if line.strip())
