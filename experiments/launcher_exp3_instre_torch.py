"""Experiment 3 with the PyTorch port: INSTRE training (twin of
launcher_exp3_instre.py).

Calls launcher_instre_eval_torch.py --train, which queues the INSTRE-S1/S2
training jobs (dataset scales 700/600, validation on the held-out class
splits), with the remaining arguments passed on.
Run: python experiments/launcher_exp3_instre_torch.py [--no-launch|--slurm ...]
"""

import os
import subprocess
import sys

if __name__ == "__main__":
    script = os.path.join(os.path.dirname(__file__), "launcher_instre_eval_torch.py")
    sys.exit(subprocess.call([sys.executable, script, "--train"] + sys.argv[1:]))
