"""Demo pipeline, the port of the JAX package's ``demo.py`` (reference
demo.py:1-9): trains one model for 5 epochs on the bundled demo dataset
through ``glam_tpu_torch.run``, then runs a 5-config AutoML search with
2-model blending through ``glam_tpu_torch.glam``, on the CUDA card.

    python -m glam_tpu_torch.demo [--dataset_root ./datasets/demo]
"""
from __future__ import annotations

import argparse
import subprocess
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", default="./datasets/demo")
    p.add_argument("--work_dir", default="./demo_runs")
    p.add_argument("--epochs", default=5, type=int)
    args = p.parse_args(argv)

    print("A single training demo: ")
    subprocess.run([sys.executable, "-m", "glam_tpu_torch.run",
                    "--dataset", "demo", "--dataset_root",
                    args.dataset_root, "--epochs", str(args.epochs),
                    "--loss", "bcel", "--work_dir", args.work_dir],
                   check=True)

    print("A demo solution of glam: ")
    subprocess.run([sys.executable, "-m", "glam_tpu_torch.glam",
                    "--dataset", "demo", "--dataset_root",
                    args.dataset_root, "--n_init_configs", "5",
                    "--n_low_fidelity_seed", "1", "--n_top_blend", "2",
                    "--n_high_fidelity_seed", "2",
                    "--work_dir", args.work_dir],
                   check=True)


if __name__ == "__main__":
    main()
