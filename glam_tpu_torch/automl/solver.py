"""AutoML solver: random search, low/high-fidelity trials, blending and
PASP; the port of the JAX package's ``automl/solver.py`` (reference
glam.py ``GLAM`` and trainer.py ``GLAMHelper``):

  * trials run as subprocesses of ``python -m glam_tpu_torch.run``, each
    on the card of a free slot (``--gpu``), scheduled by
    :class:`glam_tpu_torch.automl.scheduler.DeviceManager`;
  * results are read from the per-run log files (the reference's
    filesystem contract, kept so that crashed trials are tolerated by
    omission; they are counted and logged);
  * ``auto_blend`` reruns the top configurations for more epochs and
    seeds, blends the top checkpoints (mean score or mean prediction)
    and, on ``physprop_perturb``, runs PASP on the blend.

The blend and PASP run in the solver's own process, on the card
(``platform=None``) or the CPU (``platform="cpu"``, which also passes
``--platform cpu`` to the trials).  Before its first trial the solver
builds the native featurizer and, on the card, the CUDA kernels, so the
trials load the built libraries instead of each running ``g++`` and
``nvcc``; that build cache takes the place of the JAX package's XLA
compilation cache.
"""
from __future__ import annotations

import ast
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from ..run import resolve_run_device
from .scheduler import DeviceManager
from .search_space import config2cmd, sample_config
from .summary import auto_summarize_logs, select_top_runs

# the directory that holds glam_tpu_torch/
_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


class GLAM:
    """Random-search solver (reference glam.py:13-120)."""

    SEEDS = [12, 123, 1234, 16, 32, 50, 64, 100, 128, 200]

    def __init__(self, dataset: str, dataset_root: str,
                 n_init_configs: int = 200, n_low_fidelity_seed: int = 3,
                 n_top_blend: int = 3, n_high_fidelity_seed: int = 5,
                 seed: int = 1234, split_seed: int = 1234,
                 work_dir: str = ".", env: Optional[Dict] = None,
                 high_fidelity_epochs: int = 2000,
                 low_fidelity_epochs: Optional[int] = None,
                 platform: Optional[str] = None,
                 probe_compile: float = 0.0, pro_shards: int = 1,
                 halo: str = "a2a", pair_batch: int = 1):
        self.dataset = dataset
        self.dataset_root = dataset_root
        self.n_init_configs = n_init_configs
        self.n_low_fidelity_seed = n_low_fidelity_seed
        self.n_top_blend = n_top_blend
        self.n_high_fidelity_seed = n_high_fidelity_seed
        self.seed = seed
        self.split_seed = split_seed
        self.high_fidelity_epochs = high_fidelity_epochs
        self.low_fidelity_epochs = low_fidelity_epochs
        self.platform = platform
        # the blend's device, as a trial resolves its own (card 0)
        self.device = resolve_run_device({"platform": platform})
        self.probe_compile = float(probe_compile or 0.0)
        self.pro_shards = int(pro_shards or 1)
        self.halo = str(halo or "a2a")
        if self.halo not in ("a2a", "ring", "auto"):
            # fail here, not in every trial subprocess
            raise ValueError(f"halo must be 'a2a', 'ring' or 'auto', "
                             f"got {self.halo!r}")
        if self.halo != "a2a" and self.pro_shards <= 1:
            raise ValueError(
                f"halo={self.halo!r} requires pro_shards > 1 (the halo "
                "exchange only exists on the sharded protein path)")
        self.pair_batch = int(pair_batch or 1)
        if self.pair_batch > 1 and self.pro_shards <= 1:
            raise ValueError(
                f"pair_batch={self.pair_batch} requires pro_shards > 1 "
                "(dense trials batch via the searched batch_size)")
        self.work_dir = Path(work_dir)
        self.env = env
        self.dm = DeviceManager()
        if self.device != "cpu" and not self.dm.num_cards:
            raise RuntimeError("the solver runs its trials on the CUDA "
                               "cards, and none is visible; pass "
                               "platform='cpu' for the host CPU")
        self.rng = random.Random(seed)
        self.start = time.time()
        self.logs_dir = self.work_dir / f"log_{dataset}"
        self.logs_dir.mkdir(parents=True, exist_ok=True)
        self.searched: List[str] = []
        self.slot_procs: Dict[int, subprocess.Popen] = {}
        # per launched trial: its config and slot, the process, and its
        # wall seconds once it has exited
        self.trials: List[Dict] = []
        self.failed_trials = 0
        self.blend_result: Optional[Dict] = None
        self.pasp_result: Optional[Dict] = None
        self._kernels_built = False
        self.log(f"Solver for {dataset} start @ {time.asctime()}")
        self.log(f"{self.dm.num_slots} trial slots on "
                 f"{self.dm.num_cards} CUDA card(s); trials and blending "
                 f"on {self.device}")

    def _build_kernels(self) -> None:
        """Build the native featurizer and, on the card, every CUDA
        kernel once, before the first trial."""
        if self._kernels_built:
            return
        from ..ops.kernels import build
        t0 = time.time()
        native = build.build_host()
        self.log(f"native featurizer: {'built' if native else 'cached'} "
                 f"({time.time() - t0:.1f} s)")
        if self.device != "cpu":
            t0 = time.time()
            built = build.build()
            self.log(f"CUDA kernels: {len(built)} built, "
                     f"{len(build.SOURCES) - len(built)} cached "
                     f"({time.time() - t0:.1f} s)")
        self._kernels_built = True

    def _launch_on_free_device(self, config: Dict, procs: List) -> None:
        """Run the trial on the card of a free slot (reference --gpu
        pinning, utils.py:219-225)."""
        slot = self.dm.wait_free_device(self.slot_procs)
        self._reap()
        config = dict(config)
        config["gpu"] = self.dm.card(slot)
        p = self._launch(config)
        self.slot_procs[slot] = p
        self.trials.append({"config": config, "slot": slot, "proc": p,
                            "start": time.time(), "seconds": None})
        procs.append(p)

    # ------------------------------------------------------------------
    def _launch(self, config: Dict) -> subprocess.Popen:
        self._build_kernels()
        argv = [sys.executable] + config2cmd(config) + [
            "--work_dir", str(self.work_dir)]
        if self.platform:
            argv += ["--platform", self.platform]
        if self.probe_compile > 0:
            # accepted by the run CLI and ignored: no compile to probe
            argv += ["--probe_compile", str(self.probe_compile)]
        if self.pro_shards > 1:
            argv += ["--pro_shards", str(self.pro_shards)]
            if self.halo != "a2a":
                argv += ["--halo", self.halo]
            if self.pair_batch > 1:
                argv += ["--pair_batch", str(self.pair_batch)]
        # the trial imports the package this solver runs, wherever the
        # solver was started from
        env = dict(os.environ if self.env is None else self.env)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_PACKAGE_ROOT)] + ([env["PYTHONPATH"]]
                                    if env.get("PYTHONPATH") else []))
        return subprocess.Popen(argv, env=env)

    def _reap(self) -> None:
        """Record the wall seconds of every trial that has exited."""
        for t in self.trials:
            if t["seconds"] is None and t["proc"].poll() is not None:
                t["seconds"] = time.time() - t["start"]

    def _config_ok(self, config: Dict) -> bool:
        """Whether the trial can train ``config``: with ``pro_shards`` the
        sharded path's subset (:func:`sharded_config_ok`), else any."""
        if self.pro_shards > 1:
            from ..train.sharded_pair_trainer import sharded_config_ok
            return sharded_config_ok(config)
        return True

    def low_fidelity_training(self):
        procs = []
        for i in range(self.n_init_configs):
            config, cid = sample_config(self.dataset, self.dataset_root,
                                        self.seed, self.split_seed, self.rng)
            while cid in self.searched or not self._config_ok(config):
                config, cid = sample_config(self.dataset, self.dataset_root,
                                            self.seed, self.split_seed,
                                            self.rng)
            self.searched.append(cid)
            config["note"] = cid
            if self.low_fidelity_epochs is not None:
                config["epochs"] = self.low_fidelity_epochs
            self.log(f"Configuration {i}: id={cid} config={config}")
            for j in range(self.n_low_fidelity_seed):
                config["seed"] = self.SEEDS[j]
                self._launch_on_free_device(config, procs)
        self._wait_all(procs)
        self.log("Search complete !", with_time=True)

    def _wait_all(self, procs):
        while any(p.poll() is None for p in procs):
            self._reap()
            time.sleep(self.dm.poll_interval)
        self._reap()
        failures = sum(1 for p in procs if p.returncode != 0)
        self.failed_trials += failures
        if failures:
            # crashed trials are tolerated (reference contract: they
            # simply never write their final log line) but recorded
            self.log(f"warning: {failures}/{len(procs)} trials exited "
                     "non-zero")

    def high_fidelity_training(self, top_n: Optional[int] = None,
                               n_seed: Optional[int] = None):
        top_n = top_n or self.n_top_blend
        n_seed = n_seed or self.n_high_fidelity_seed
        self.log("Run configurations for more epochs...")
        summary = auto_summarize_logs(self.dataset, self.work_dir)
        if not summary:
            self.log("No finished runs found; nothing to refine")
            return
        seeds = [1, 12, 123, 1234, 2, 4, 6, 8]
        procs = []
        for i in range(min(top_n, len(summary))):
            config = ast.literal_eval(summary[i]["config"])
            config["epochs"] = self.high_fidelity_epochs
            config["note"] = "more_epochs_run"
            self.log(f"Configuration {i + 1}: {config}")
            for seed in seeds[:n_seed]:
                config["seed"] = seed
                self._launch_on_free_device(config, procs)
        self._wait_all(procs)
        self.log("Run Complete!", with_time=True)

    # ------------------------------------------------------------------
    def blend_and_inference(self, custom_test=None):
        from .ensemble import blend_and_inference
        sel = select_top_runs(self.logs_dir, self.dataset, self.n_top_blend)
        if not sel:
            self.log("No checkpoints to blend")
            return None
        self.log(f"{len(sel)} checkpoints selected "
                 f"(details: {self.logs_dir}/inf_ckpt_selected.csv)")
        result = blend_and_inference(
            ids=[r["id"] for r in sel], configs=[r["config"] for r in sel],
            work_dir=self.work_dir, custom_test=custom_test, log=self.log,
            device=self.device)
        self.log(f"blend results: {result}")
        return result

    def auto_blend(self):
        """High-fidelity reruns, the blend on the test set and, on
        physprop_perturb, PASP; the results are kept as ``blend_result``
        and ``pasp_result``."""
        self.log("Run more epochs estimation...")
        self.high_fidelity_training()
        self.log("Run solution for original test set...")
        self.blend_result = self.blend_and_inference()
        if self.dataset in ["physprop_perturb"]:
            self.pasp_result = self.pasp()
        return self.blend_result

    def pasp(self):
        from .ensemble import pasp_ensemble
        return pasp_ensemble(self, log=self.log)

    # ------------------------------------------------------------------
    def log(self, msg=None, with_time=False):
        msg = str(msg)
        if with_time:
            el = time.time() - self.start
            msg += " time elapsed {:.2f} hrs ({:.1f} mins)".format(
                el / 3600.0, el / 60.0)
        with open(self.logs_dir / "solver_log.txt", "a+") as f:
            f.write(msg + "\n")
        print(msg)
