"""Single-trial training CLI, with the JAX package's flags
(``glam_tpu/run.py``), so that AutoML-generated commands parse:

    python -m glam_tpu_torch.run --dataset demo --dataset_root datasets/demo \\
        --epochs 2 --loss bcel --mol_block _TripletMessage
    python -m glam_tpu_torch.run --dataset drugbank_caster \\
        --dataset_root datasets/ddi_demo --mol_block _TripletMessage
    python -m glam_tpu_torch.run --dataset bindingdb_c \\
        --dataset_root datasets/dti_demo --mol_block _TripletMessage \\
        --pro_block _GATConv
    python -m glam_tpu_torch.run --dataset ALDH1 \\
        --dataset_root datasets/scr_demo --mol_block _TripletMessage

Property datasets train the single-graph model; the pair datasets (DDI
``drugbank_caster``, DTI ``bindingdb_c``, LIT-PCBA screening targets)
the two-tower pair model, dispatched by ``make_auto_trainer``.  Every
conv, norm and readout name of the JAX package is taken; with no
``--mol_block`` it trains ``_NNConv``, the JAX CLI's default.  It trains
on the CUDA card ``--gpu`` (default 0); ``--platform cpu`` trains on the
host CPU instead.  ``--scan_steps S`` (default 8) is the JAX CLI's: S
batches of one shape are one dispatch, on the card the replay of a CUDA
graph of S optimizer steps (``train/step_graph.py``), any other group one
dispatch a batch (the one-step graph), and evaluation likewise; 1 or
less gives one-step graphs only.  With ``--n_devices`` a rank replays
graphs that hold its all-reduce under nccl (one card a rank) and two
graphs a step around an eager all-reduce under gloo (ranks sharing a
card); with ``--pro_shards`` a rank replays one graph a step under nccl
and runs eagerly under gloo (``parallel/distributed.py``).  On the CPU
the steps run eagerly in the same groups.
``--pallas``, ``--probe_compile`` and ``--compile_cache`` are accepted
and do nothing: the kernels always run on the card.
``physprop_perturb`` trains the regression model on its Label-column
splits (``data/perturb.py``).  ``--dtype bfloat16`` (or ``float16``)
trains in that compute dtype over float32 master parameters
(``train/trainer.py``).  The AutoML solver (``glam_tpu_torch.glam``)
launches this CLI for every trial.

``--n_devices D`` > 1 trains data-parallel over D ranks, one process
each (``parallel/distributed.py``, ``train/trainer.py``).
``--pro_shards N`` > 1 trains a DTI dataset (BindingDB, LIT-PCBA) with
its protein tower node-sharded over N ranks
(``train/sharded_pair_trainer.py``), ``--halo`` its halo plan (a2a, ring
or auto), ``--pair_batch B`` pairs a step; the two options exclude each
other, and ``--pair_batch > 1`` needs ``--pro_shards``.  Where
``GLAM_COORDINATOR``, ``GLAM_NUM_PROCESSES`` and ``GLAM_PROCESS_ID`` are
unset, this process is the launcher: it checks the options, builds the
kernels once (on the card), starts the rank processes of the same
command on a free local port with the variables set, waits for all of
them and exits non-zero if any rank does (stopping the others).  Where
they are set, it runs as that rank, so a multi-host launch sets them on
each host.  On the card the ranks use ``cuda:(rank % cards)`` (gloo where
ranks share a card, nccl where each has its own); ``--platform cpu``
runs gloo ranks on the CPU.  Rank 0 alone writes the log, checkpoints
and the final line.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", default="./dataset", type=str)
    p.add_argument("--dataset", type=str, default="esol")
    p.add_argument("--split", type=str, default="random",
                   help="random, scaffold")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--split_seed", type=int, default=1234)
    p.add_argument("--gpu", default=0, type=int, help="CUDA device index")
    p.add_argument("--note", default="None2", type=str)

    p.add_argument("--hid_dim_alpha", default=4, type=int)
    p.add_argument("--mol_block", type=str, default="_NNConv")
    p.add_argument("--pro_block", type=str, default="_GCNConv",
                   help="protein-tower conv for DTI datasets")
    p.add_argument("--e_dim", default=1024, type=int)
    p.add_argument("--out_dim", default=1, type=int)
    p.add_argument("--message_steps", default=3, type=int)
    p.add_argument("--mol_readout", default="GlobalPool5", type=str)
    p.add_argument("--pro_readout", default="GlobalPool5", type=str,
                   help="protein-tower readout for DTI datasets")

    p.add_argument("--pre_norm", default="_None", type=str)
    p.add_argument("--graph_norm", default="_PairNorm", type=str)
    p.add_argument("--flat_norm", default="_None", type=str)
    p.add_argument("--end_norm", default="_None", type=str)
    p.add_argument("--pre_do", default="_None()", type=str)
    p.add_argument("--graph_do", default="_None()", type=str)
    p.add_argument("--flat_do", default="Dropout(0.2)", type=str)
    p.add_argument("--end_do", default="Dropout(0.2)", type=str)
    p.add_argument("--pre_act", default="RReLU", type=str)
    p.add_argument("--graph_act", default="RReLU", type=str)
    p.add_argument("--flat_act", default="RReLU", type=str)
    p.add_argument("--end_act", default="RReLU", type=str,
                   help="pair-head activation")
    p.add_argument("--graph_res", default=1, type=int)

    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--epochs", default=800, type=int)
    p.add_argument("--loss", default="mse", type=str)
    p.add_argument("--optim", default="Adam", type=str)
    p.add_argument("--k", default=6, type=int, help="lookahead steps")
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--lr_reduce_rate", default=0.7, type=float)
    p.add_argument("--lr_reduce_patience", default=20, type=int)
    p.add_argument("--early_stop_patience", default=50, type=int)
    p.add_argument("--verbose_patience", default=500, type=int)
    p.add_argument("--scan_steps", default=8, type=int,
                   help="optimizer steps (and evaluation batches) a "
                        "dispatch: on the card one CUDA graph replay "
                        "for a group of this many batches of one shape")
    p.add_argument("--work_dir", default=None, type=str,
                   help="where log_{dataset}/ run dirs are created")
    p.add_argument("--platform", default=None, type=str,
                   help="'cpu' trains on the host CPU; default the CUDA "
                        "card --gpu")
    p.add_argument("--resume", default=None, type=str,
                   help="run dir (or last_save.pt) to resume "
                        "mid-training from")
    p.add_argument("--dtype", default="float32", type=str,
                   help="compute dtype of the forward and backward: "
                        "float32, bfloat16 or float16 (master parameters "
                        "stay float32)")
    p.add_argument("--compile_cache", default=None, type=str,
                   help="accepted for the JAX package's commands; no "
                        "effect")
    p.add_argument("--pallas", default="auto", type=str,
                   help="accepted for the JAX package's commands; no "
                        "effect (the CUDA kernels always run on the card)")
    p.add_argument("--probe_compile", default=0.0, type=float,
                   help="accepted for the JAX package's commands; no "
                        "effect")
    p.add_argument("--n_devices", default=1, type=int,
                   help="data-parallel ranks, one process each")
    p.add_argument("--halo", default="a2a", type=str,
                   help="halo plan for --pro_shards: 'a2a' (one "
                        "all_to_all), 'ring' (one send a ring distance) "
                        "or 'auto' (ring where it halves the rows)")
    p.add_argument("--pro_shards", default=1, type=int,
                   help="DTI datasets: the protein tower node-sharded over "
                        "N ranks, one process each; excludes --n_devices")
    p.add_argument("--pair_batch", default=1, type=int,
                   help="pairs per optimizer step with --pro_shards")
    return p


def resolve_run_device(args) -> str:
    """``cpu`` for ``--platform cpu``, else ``cuda:<gpu>``."""
    platform = (args.get("platform") or "cuda").strip().lower()
    if platform == "cpu":
        return "cpu"
    if platform not in ("cuda", "gpu"):
        raise ValueError(f"--platform {platform!r}: use 'cpu', or leave it "
                         "unset for the CUDA card")
    return f"cuda:{int(args.get('gpu') or 0)}"


def check_ranks(args) -> int:
    """The rank count (``--n_devices`` or ``--pro_shards``), after the JAX
    CLI's checks of the two options and ``--pair_batch``."""
    pro_shards = int(args.get("pro_shards") or 1)
    if pro_shards > 1:
        if int(args.get("n_devices") or 1) > 1:
            raise ValueError("--pro_shards and --n_devices are "
                             "mutually exclusive")
        from .data.datasets import PAIR_DATASET_NAMES, auto_dataset
        if args["dataset"] not in (PAIR_DATASET_NAMES["dti"]
                                   + PAIR_DATASET_NAMES["scr"]):
            _, _, kind = auto_dataset(dict(args))
            raise ValueError("--pro_shards applies to DTI datasets "
                             f"only (got trainer kind {kind})")
        return pro_shards
    if int(args.get("pair_batch", 1)) > 1:
        raise ValueError("--pair_batch applies to --pro_shards runs "
                         "only (dense trainers batch via --batch_size)")
    return int(args.get("n_devices") or 1)


def launch_ranks(argv, args, n: int) -> int:
    """Start ``n`` rank processes of this command and wait for them;
    returns the first nonzero exit code (the others are stopped then),
    else 0."""
    from .parallel import distributed
    platform = resolve_run_device(args)
    if platform != "cpu":
        # the ranks' cards; raises without one
        distributed.rank_device(0, "cuda")
        from .ops.kernels import build
        t0 = time.time()
        built = build.build()
        print(f"[launcher] CUDA kernels: {len(built)} built, "
              f"{len(build.SOURCES) - len(built)} cached "
              f"({time.time() - t0:.1f} s)", flush=True)
    rc = distributed.wait_ranks(distributed.spawn_ranks(
        [sys.executable, "-m", "glam_tpu_torch.run", *argv], n))
    if rc:
        print(f"[launcher] a rank exited with {rc}; the others were "
              "stopped", file=sys.stderr, flush=True)
    return rc


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = vars(build_parser().parse_args(argv))
    from .parallel import distributed
    from .train.trainer import check_supported

    check_supported(args)
    n = check_ranks(args)
    rank = 0
    if n > 1 and distributed.ENV_PROCESS_ID not in os.environ:
        rc = launch_ranks(argv, args, n)
        if rc:
            raise SystemExit(rc)
        return None
    if n > 1:
        platform = resolve_run_device(args)
        platform = "cpu" if platform == "cpu" else "cuda"
        distributed.initialize_distributed(num_processes=n,
                                           platform=platform)
        rank = distributed.world()[0]
        device = distributed.rank_device(rank, platform)
    else:
        device = resolve_run_device(args)
    import torch
    from .data.datasets import auto_dataset
    from .train.pair_trainer import make_auto_trainer
    from .utils.seed import seed_everything

    args.pop("compile_cache", None)
    seed_everything(args["seed"])
    if rank == 0:
        print("Loading dataset...")
    # rank 0 first: it writes the dataset cache that the others read
    if rank > 0:
        torch.distributed.barrier()
    args, dataset, trainer_kind = auto_dataset(args)
    if n > 1 and rank == 0:
        torch.distributed.barrier()
    if rank == 0:
        print("Training init...")
    resume = args.pop("resume", None)
    if int(args.get("pro_shards") or 1) > 1:
        from .train.sharded_pair_trainer import ShardedPairTrainer
        trainer = ShardedPairTrainer(args, dataset, task=trainer_kind,
                                     work_dir=args.get("work_dir"),
                                     device=device)
    else:
        trainer = make_auto_trainer(args, dataset, trainer_kind,
                                    work_dir=args.get("work_dir"),
                                    device=device)
    if resume:
        trainer.resume(resume)
    trainer.train_and_test()
    return trainer


if __name__ == "__main__":
    main()
