"""AutoML search spaces, a copy of the JAX package's
``automl/search_space.py`` (the reference glam.py samplers).

Three task-family spaces, their values and duplicate-weighted entries
(the duplicates are the reference's sampling bias) as in the reference:
  single-graph  src_1gp/glam.py:54-100
  DDI           src_2gi_ddi/glam.py:50-91
  DTI/screening src_2gi_dti_scr/glam.py:52-104
``sample_config`` dispatches on the dataset name; from the same
``random.Random`` it draws the configs and ids the JAX sampler draws.
Config ids are the last 5 hex digits of the md5 of the flattened config
(reference utils.py:249-250).  ``config2cmd`` gives the argv of a
``glam_tpu_torch.run`` trial."""
from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Optional, Tuple

from ..data.datasets import DATASET_NAMES, PAIR_DATASET_NAMES

MOL_BLOCKS = ["_TripletMessage", "_NNConv", "_TripletMessageLight",
              "_GCNConv", "_GATConv"]
READOUTS = ["Set2Set", "GlobalPool5", "GlobalLAPool"]


def config_id(config: Dict) -> str:
    s = " ".join(k + " " + str(v) for k, v in config.items())
    return hashlib.md5(s.encode()).hexdigest()[-5:]


def _common_blocks(r) -> Dict:
    """Dropout/norm/act sub-space shared verbatim by all three samplers."""
    return {
        "pre_do": r.choice(["_None()", "_None()", "Dropout(0.1)"]),
        "graph_do": r.choice(["_None()", "_None()", "Dropout(0.1)"]),
        "flat_do": r.choice(["_None()", "Dropout(0.1)", "Dropout(0.2)",
                             "Dropout(0.5)"]),
        "end_do": r.choice(["_None()", "Dropout(0.1)", "Dropout(0.2)",
                            "Dropout(0.5)"]),
        "pre_norm": r.choice(["_None", "_BatchNorm", "_LayerNorm"]),
        "graph_norm": r.choice(["_None", "_None", "_None", "_BatchNorm",
                                "_LayerNorm", "_PairNorm"]),
        "flat_norm": r.choice(["_None", "_None", "_None", "_BatchNorm",
                               "_LayerNorm"]),
        "end_norm": r.choice(["_None", "_None", "_None", "_BatchNorm",
                              "_LayerNorm"]),
        "pre_act": r.choice(["_None", "ReLU", "LeakyReLU", "RReLU",
                             "RReLU", "RReLU"]),
        "graph_act": r.choice(["_None", "ReLU", "LeakyReLU", "RReLU",
                               "RReLU", "RReLU", "CELU"]),
        "flat_act": r.choice(["_None", "ReLU", "LeakyReLU", "RReLU",
                              "RReLU", "RReLU", "CELU"]),
        "graph_res": r.choice([1, 0]),
    }


def sample_config_ddi(dataset: str, dataset_root: str, seed: int = 1234,
                      split_seed: int = 1234,
                      rng: Optional[random.Random] = None
                      ) -> Tuple[Dict, str]:
    """DDI space (reference src_2gi_ddi/glam.py:50-91): identical to the
    1gp space plus end_act, loss fixed to bcel, epochs=20."""
    r = rng or random
    config = {
        "dataset": dataset,
        "dataset_root": dataset_root,
        "seed": seed,
        "split_seed": split_seed,
        "hid_dim_alpha": r.choice([1, 2, 3, 4, 6]),
        "e_dim": r.choice([256, 512, 1024, 2048]),
        "mol_block": r.choice(MOL_BLOCKS),
        "message_steps": r.choice([1, 2, 3, 6]),
        "mol_readout": r.choice(READOUTS),
        **_common_blocks(r),
        "end_act": r.choice(["_None", "ReLU", "LeakyReLU", "RReLU",
                             "RReLU", "RReLU", "CELU"]),
        "loss": r.choice(["bcel"]),
        "batch_size": r.choice([4, 8, 12, 16, 32, 64, 128, 256, 512, 768]),
        "optim": r.choice(["Adam", "Ranger"]),
        "k": r.choice([1, 3, 6]),
        "epochs": 20,
        "lr": r.choice([0.01, 0.005, 0.001, 0.0005, 0.0001]),
        "early_stop_patience": 50,
    }
    if config["optim"] == "Adam":
        del config["k"]
    return config, config_id(config)


def sample_config_dti(dataset: str, dataset_root: str, seed: int = 1234,
                      split_seed: int = 1234,
                      rng: Optional[random.Random] = None
                      ) -> Tuple[Dict, str]:
    """DTI/screening space (reference src_2gi_dti_scr/glam.py:52-104):
    narrower mol blocks, pro_block/pro_readout dims, wce/focal losses,
    and the bindingdb batch/loss tweak — including the reference's quirk
    that the tweak sits on the optim!='Adam' elif branch."""
    r = rng or random
    config = {
        "dataset": dataset,
        "dataset_root": dataset_root,
        "seed": seed,
        "hid_dim_alpha": r.choice([1, 2, 6]),
        "e_dim": r.choice([256, 512, 1024, 2048]),
        "mol_block": r.choice(["_TripletMessage", "_NNConv"]),
        "pro_block": r.choice(["_NNConv", "_GCNConv", "_GATConv"]),
        "message_steps": r.choice([1, 2, 3, 6]),
        "mol_readout": r.choice(["Set2Set", "GlobalPool5"]),
        "pro_readout": r.choice(["GlobalLAPool", "Set2Set", "GlobalPool5"]),
        **_common_blocks(r),
        "end_act": r.choice(["_None", "ReLU", "LeakyReLU", "RReLU",
                             "RReLU", "RReLU", "CELU"]),
        "loss": r.choice(["wce", "wce", "focal"]),
        "batch_size": r.choice([8, 16, 32, 64, 128, 256, 512, 768]),
        "optim": r.choice(["Adam", "Ranger"]),
        "k": r.choice([1, 3, 6]),
        "epochs": 20,
        "lr": r.choice([0.01, 0.005, 0.001, 0.0005, 0.0001]),
        "early_stop_patience": 50,
    }
    if config["optim"] == "Adam":
        del config["k"]
    elif dataset in PAIR_DATASET_NAMES["dti"]:
        config["batch_size"] = r.choice(
            [8, 16, 16, 16, 32, 32, 32, 64, 128, 256, 512])
        config["loss"] = r.choice(["ce", "ce", "focal"])
    return config, config_id(config)


def sample_config(dataset: str, dataset_root: str, seed: int = 1234,
                  split_seed: int = 1234,
                  rng: Optional[random.Random] = None
                  ) -> Tuple[Dict, str]:
    if dataset in PAIR_DATASET_NAMES["ddi"]:
        return sample_config_ddi(dataset, dataset_root, seed, split_seed,
                                 rng)
    if dataset in PAIR_DATASET_NAMES["dti"] \
            or dataset in PAIR_DATASET_NAMES["scr"]:
        return sample_config_dti(dataset, dataset_root, seed, split_seed,
                                 rng)
    r = rng or random
    config = {
        "dataset": dataset,
        "dataset_root": dataset_root,
        "seed": seed,
        "split_seed": split_seed,
        "hid_dim_alpha": r.choice([1, 2, 3, 4, 6]),
        "e_dim": r.choice([256, 512, 1024, 2048]),

        "mol_block": r.choice(MOL_BLOCKS),
        "message_steps": r.choice([1, 2, 3, 6]),
        "mol_readout": r.choice(READOUTS),

        "pre_do": r.choice(["_None()", "_None()", "Dropout(0.1)"]),
        "graph_do": r.choice(["_None()", "_None()", "Dropout(0.1)"]),
        "flat_do": r.choice(["_None()", "Dropout(0.1)", "Dropout(0.2)",
                             "Dropout(0.5)"]),
        "end_do": r.choice(["_None()", "Dropout(0.1)", "Dropout(0.2)",
                            "Dropout(0.5)"]),

        "pre_norm": r.choice(["_None", "_BatchNorm", "_LayerNorm"]),
        "graph_norm": r.choice(["_None", "_None", "_None", "_BatchNorm",
                                "_LayerNorm", "_PairNorm"]),
        "flat_norm": r.choice(["_None", "_None", "_None", "_BatchNorm",
                               "_LayerNorm"]),
        "end_norm": r.choice(["_None", "_None", "_None", "_BatchNorm",
                              "_LayerNorm"]),

        "pre_act": r.choice(["_None", "ReLU", "LeakyReLU", "RReLU",
                             "RReLU", "RReLU"]),
        "graph_act": r.choice(["_None", "ReLU", "LeakyReLU", "RReLU",
                               "RReLU", "RReLU", "CELU"]),
        "flat_act": r.choice(["_None", "ReLU", "LeakyReLU", "RReLU",
                              "RReLU", "RReLU", "CELU"]),
        "graph_res": r.choice([1, 0]),

        "loss": "bcel",
        "batch_size": r.choice([4, 8, 12, 16, 32, 64, 128, 256, 512, 768]),
        "optim": r.choice(["Adam", "Ranger"]),
        "k": r.choice([1, 3, 6]),
        "epochs": 30,
        "lr": r.choice([0.01, 0.005, 0.001, 0.0005, 0.0001]),
        "early_stop_patience": 50,
    }
    if config["optim"] != "Ranger":
        del config["k"]
    if dataset in DATASET_NAMES["c"]:
        config["loss"] = r.choice(["bcel"])
    elif dataset in DATASET_NAMES["r"]:
        config["loss"] = r.choice(["mse", "mse", "mse", "mae", "huber"])
    return config, config_id(config)


_CLI_FLAGS = frozenset([
    "dataset_root", "dataset", "split", "seed", "split_seed", "gpu",
    "note", "hid_dim_alpha", "mol_block", "pro_block", "e_dim", "out_dim",
    "message_steps", "mol_readout", "pro_readout", "pre_norm",
    "graph_norm", "flat_norm", "end_norm", "pre_do", "graph_do", "flat_do",
    "end_do", "pre_act", "graph_act", "flat_act", "end_act", "graph_res",
    "batch_size", "epochs", "loss", "optim", "k", "lr", "lr_reduce_rate",
    "lr_reduce_patience", "early_stop_patience", "verbose_patience",
    "work_dir", "platform", "scan_steps", "dtype", "pallas", "n_devices",
    "probe_compile",
])


def config2cmd(config: Dict) -> List[str]:
    """Config dict -> argv list for the run CLI (reference logger.py:35-40
    built a shell string; this is an argv list, no shell quoting).
    Keys that are not CLI flags (e.g. trainer-internal 'task'/'num_tasks'
    recorded in run logs) are dropped."""
    argv = ["-m", "glam_tpu_torch.run"]
    for k, v in config.items():
        # None values (e.g. 'platform': None round-tripped through a run
        # log) must not become the string "None" on the child CLI
        if k in _CLI_FLAGS and v is not None:
            argv += [f"--{k}", str(v)]
    return argv
