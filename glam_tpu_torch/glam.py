"""AutoML solver CLI, the port of the JAX package's ``glam.py``
(reference glam.py:123-145), with its flags:

    python -m glam_tpu_torch.glam --dataset demo \
        --dataset_root ./datasets/demo --n_init_configs 5 \
        --n_top_blend 2 --n_high_fidelity_seed 2

Trials and the blend run on the CUDA cards; ``--platform cpu`` runs both
on the host CPU.  ``GLAM_TPU_TRIAL_SLOTS`` sets how many trials run at
once (default: one per card); slot s trains on card s % cards.
``--probe_compile`` is passed on to the trials, whose CLI ignores it;
``--pro_shards N`` (with ``--halo`` and ``--pair_batch``) trains every
trial with its protein tower sharded over N ranks, and the sampled
configurations are resampled to the sharded path's subset.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default="esol")
    p.add_argument("--dataset_root", type=str, default="./dataset")
    p.add_argument("--n_init_configs", default=200, type=int,
                   help="n initialized configurations")
    p.add_argument("--n_low_fidelity_seed", default=3, type=int,
                   help="runs per configuration in the search phase")
    p.add_argument("--n_top_blend", default=3, type=int,
                   help="auto blend n models")
    p.add_argument("--n_high_fidelity_seed", default=5, type=int,
                   help="full-epoch runs per top config")
    p.add_argument("--seed", default=1234, type=int)
    p.add_argument("--split_seed", default=1234, type=int)
    p.add_argument("--work_dir", default=".", type=str)
    p.add_argument("--high_fidelity_epochs", default=2000, type=int)
    p.add_argument("--low_fidelity_epochs", default=None, type=int,
                   help="override the sampled 30-epoch search budget")
    p.add_argument("--platform", default=None, type=str,
                   help="'cpu' runs the trials and the blend on the "
                        "host CPU; default the CUDA cards")
    p.add_argument("--probe_compile", default=0.0, type=float,
                   help="passed on to every trial; accepted for the "
                        "JAX package's commands, no effect")
    p.add_argument("--pro_shards", default=1, type=int,
                   help="sharded DTI protein tower; only 1 is ported")
    p.add_argument("--halo", default="a2a", type=str,
                   help="halo plan for --pro_shards trials: 'a2a', "
                        "'ring', or 'auto' (see run.py --halo)")
    p.add_argument("--pair_batch", default=1, type=int,
                   help="pairs per optimizer step in --pro_shards "
                        "trials (see run.py --pair_batch)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .automl.solver import GLAM

    solver = GLAM(
        dataset=args.dataset, dataset_root=args.dataset_root,
        n_init_configs=args.n_init_configs,
        n_low_fidelity_seed=args.n_low_fidelity_seed,
        n_top_blend=args.n_top_blend,
        n_high_fidelity_seed=args.n_high_fidelity_seed,
        seed=args.seed, split_seed=args.split_seed,
        work_dir=args.work_dir,
        high_fidelity_epochs=args.high_fidelity_epochs,
        low_fidelity_epochs=args.low_fidelity_epochs,
        platform=args.platform, probe_compile=args.probe_compile,
        pro_shards=args.pro_shards, halo=args.halo,
        pair_batch=args.pair_batch)
    solver.low_fidelity_training()
    solver.auto_blend()
    return solver


if __name__ == "__main__":
    main()
