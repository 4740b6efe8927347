"""Serving: load a checkpoint, predict from SMILES.

    pred = Predictor.from_checkpoint("<run_dir>", batch_size=128)
    scores = pred.predict_smiles(["CCO", "c1ccccc1"])

The port of the JAX package's ``Predictor`` (``serve.py``).  Batches are
padded to budgets pinned from the checkpoint's ``max_nodes``, with a
fallback to input-derived budgets for unusually large molecules;
SMILES that cannot be featurized yield NaN rows.  Loading runs no forward
pass.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with ``cuda`` and no card they raise.

Checkpoints are ``best_save.pt`` files written by :func:`save_checkpoint`
(the trainer writes them so too): ``{"args": json string, "state_dict":
{name: tensor}}``, plus the trainer's ``"records"`` (json string), read
with ``torch.load(weights_only=True)``.  The ``state_dict`` holds the
BatchNorm running statistics, which the model (in ``eval()`` mode)
normalises with, as the JAX ``Predictor`` does with its ``batch_stats``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .chem.featurize import smiles_to_arrays
from .data.batching import GraphLoader
from .data.graph import GraphArrays, GraphBatch
from .nn.model import Architecture, ModelConfig, model_config_from_args


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, checked: ``cuda`` needs a card, and on
    the card float32 matmuls and convolutions run in full float32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               "device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def pinned_budgets(batch_size: int, max_nodes: int):
    """(node, edge) budgets of one padded batch: max_nodes per graph slot
    plus the padding node; molecular edge counts stay below ~2.4x the
    node count, so 3x pads generously."""
    return (8 * -(-(batch_size * max_nodes + 1) // 8),
            8 * -(-(3 * batch_size * max_nodes) // 8))


def save_checkpoint(run_dir, model: Architecture, args: Dict,
                    which: str = "best_save.pt",
                    records: Optional[Dict] = None) -> Path:
    """Write ``run_dir/which``; ``args`` gains the model's ``model_cfg``
    when it lacks one, so the checkpoint describes its model.
    ``records`` (the trainer's) are stored beside the weights."""
    args = dict(args)
    args.setdefault("model_cfg", dataclasses.asdict(model.cfg))
    path = Path(run_dir) / which
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    payload = {"args": json.dumps(args), "state_dict": state}
    if records is not None:
        payload["records"] = json.dumps(records)
    torch.save(payload, path)
    return path


class Predictor:
    """Single-model predictor over molecular SMILES."""

    def __init__(self, model: Architecture, args: Dict,
                 batch_size: int = 32, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.args = args
        self.batch_size = batch_size
        self.task = args.get("task", "regression")
        self.num_tasks = int(args.get("num_tasks", 1))
        self.out_dim = int(args.get("out_dim", 1))
        max_nodes = int(args.get("model_cfg", {}).get("max_nodes", 132))
        self.node_budget, self.edge_budget = pinned_budgets(batch_size,
                                                            max_nodes)

    @classmethod
    def from_checkpoint(cls, run_dir, which: str = "best_save.pt",
                        batch_size: int = 32, device="cuda") -> "Predictor":
        resolve_device(device)
        payload = torch.load(Path(run_dir) / which, map_location="cpu",
                             weights_only=True)
        args = json.loads(payload["args"])
        if "model_cfg" in args:
            cfg = ModelConfig(**args["model_cfg"])
        else:
            cfg = model_config_from_args(args,
                                         out_dim=args.get("out_dim", 1))
        model = Architecture(cfg)
        model.load_state_dict(payload["state_dict"])
        return cls(model, args, batch_size, device)

    def featurize(self, smiles: Sequence[str]) -> List[Optional[GraphArrays]]:
        """One graph per SMILES; None where it cannot be featurized."""
        graphs: List[Optional[GraphArrays]] = []
        for smi in smiles:
            try:
                x, snd, rcv, e = smiles_to_arrays(smi)
            except ValueError:
                graphs.append(None)
                continue
            graphs.append(GraphArrays(
                nodes=x, edges=e, senders=snd, receivers=rcv,
                y=np.zeros(self.num_tasks, np.float32), smi=smi))
        return graphs

    def batches(self, graphs: Sequence[GraphArrays]) -> List[GraphBatch]:
        """Padded host batches at the pinned budgets, or at budgets
        derived from the inputs when they exceed those."""
        try:
            return list(GraphLoader(graphs, self.batch_size,
                                    self.num_tasks,
                                    node_budget=self.node_budget,
                                    edge_budget=self.edge_budget))
        except ValueError:
            return list(GraphLoader(graphs, self.batch_size,
                                    self.num_tasks))

    def predict_smiles(self, smiles: Sequence[str]) -> np.ndarray:
        """[N, out] predictions (logits for classification, values for
        regression); unparseable SMILES yield NaN rows."""
        graphs = self.featurize(smiles)
        valid = [g for g in graphs if g is not None]
        outs = []
        if valid:
            with torch.inference_mode():
                for batch in self.batches(valid):
                    out = self.model(batch.to(self.device)).cpu().numpy()
                    outs.append(out[batch.graph_mask.numpy()])
            preds = np.concatenate(outs, axis=0)
        else:
            preds = np.zeros((0, self.out_dim), np.float32)
        width = preds.shape[1] if preds.size else self.out_dim
        full = np.full((len(smiles), width), np.nan, np.float32)
        full[np.asarray([g is not None for g in graphs], bool)] = preds
        return full

    def predict_scores(self, smiles: Sequence[str]) -> np.ndarray:
        """Probability scores for classification tasks (sigmoid/softmax
        applied per the trained head)."""
        out = self.predict_smiles(smiles)
        if self.task == "binary_nan_bce":
            return 1.0 / (1.0 + np.exp(-out))
        if self.task == "binary_nan":
            logits = out.reshape(out.shape[0], self.num_tasks, 2)
            ex = np.exp(logits - logits.max(-1, keepdims=True))
            return (ex / ex.sum(-1, keepdims=True))[..., 1]
        return out
