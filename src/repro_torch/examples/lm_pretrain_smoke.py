"""LM pretraining example: reduced-config training through the port's
production launcher (``repro_torch.launch.train``: AdamW, per-layer
checkpointing).  The port of the reference's
``examples/lm_pretrain_smoke.py``; any of the decoder archs::

    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain_smoke \\
        --arch zamba2-7b
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    args = ap.parse_args(argv)
    return train_main(["--arch", args.arch, "--smoke",
                       "--steps", str(args.steps), "--batch", "8",
                       "--seq", "128", "--device", args.device])


if __name__ == "__main__":
    sys.exit(main())
