"""Serving: load a checkpoint, predict from SMILES, or from pairs.

    pred = Predictor.from_checkpoint("<run_dir>", batch_size=128)
    scores = pred.predict_smiles(["CCO", "c1ccccc1"])

    pair = PairPredictor.from_checkpoint("<pair run_dir>",
                                         contact_maps={seq: cmap})
    scores = pair.predict_scores([("CCO", seq), ("c1ccccc1", seq)])

    ens = EnsemblePredictor.from_runs("<work_dir>/log_<dataset>", n=3)
    scores = ens.predict_scores(["CCO", "c1ccccc1"])

The port of the JAX package's ``Predictor``, ``EnsemblePredictor`` and
``PairPredictor`` (``serve.py``).  ``EnsemblePredictor`` serves the mean
of the top runs of an AutoML search (or any log directory) as the
solver's blend selects them.  ``PairPredictor`` serves a ``PairArchitecture``
checkpoint: a DDI one (tasks ``pair_binary_bce``, ``pair_multiclass``)
from (SMILES, SMILES) pairs, a DTI one from (SMILES, protein sequence)
pairs, each sequence's residue graph made from its contact map in
``contact_maps``; a pair whose SMILES does not featurize or whose
protein has no contact map yields a NaN row.  Its batch budgets are
monotone floors kept across calls (``PairGraphLoader``'s ``budget1`` /
``budget2``), which fit the inputs given: a contact-map graph has far
more edges per node than ``pinned_budgets`` assumes.  Batches are
padded to budgets pinned from the checkpoint's ``max_nodes``, with a
fallback to input-derived budgets for unusually large molecules;
SMILES that cannot be featurized yield NaN rows.  Loading runs no forward
pass.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with ``cuda`` and no card they raise.

On the card every predictor serves through CUDA graphs
(``cuda_graphs.ForwardGraphs``), the counterpart of the JAX predictors'
one jitted executable per batch shape: one graph per batch signature,
captured at its second batch (its first runs eagerly on the capture's
stream) and replayed for every later one; a batch is one pinned copy
in, the replay, and its output copied back before the next replay.
``Predictor`` pins the signature of its pinned budgets and keeps the
last 2 others (the fallback budgets of unusually large molecules), each
``PairPredictor`` floor growth frees the superseded graph, and an
``EnsemblePredictor``'s members keep their own.  ``graph_stats`` reports
captures, replays and the pools' bytes.  On the CPU the forwards run
eagerly.

Checkpoints are ``best_save.pt`` files written by :func:`save_checkpoint`
(the trainer writes them so too): ``{"args": json string, "state_dict":
{name: tensor}}``, plus the trainer's ``"records"`` (json string), read
with ``torch.load(weights_only=True)``.  The ``state_dict`` holds the
BatchNorm running statistics, which the model (in ``eval()`` mode)
normalises with, as the JAX ``Predictor`` does with its ``batch_stats``.
``from_checkpoint`` also serves a JAX run directory: a ``which`` ending
in ``.ckpt`` (the JAX trainer's ``best_save.ckpt``) is read by
``convert.load_jax_checkpoint``, anything else as the port's file.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .convert import config_from_args, load_jax_checkpoint, pair_kind
from .cuda_graphs import ForwardGraphs
from .data.batching import GraphLoader, PairGraphLoader
from .data.datasets import featurize_smiles
from .data.graph import GraphArrays, GraphBatch
from .data.pair_datasets import mol_graph, protein_graph
from .nn.model import Architecture, PairArchitecture


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


def forward_graphs(model, device) -> Optional[ForwardGraphs]:
    """The captured forwards of ``model`` on the card; None on the CPU,
    where a predictor runs its forwards eagerly."""
    return ForwardGraphs(model, device) if device.type == "cuda" else None


def served(model, graphs: Optional[ForwardGraphs], parts,
           pin: bool = False) -> np.ndarray:
    """``model``'s output on one padded batch (a tuple of CPU
    GraphBatches) as a host array: through ``graphs`` on the card (its
    signature pinned there if ``pin``), eagerly on the CPU.  Call it
    under ``torch.inference_mode()``."""
    if graphs is None:
        return model(*parts).numpy()
    return graphs(parts, pin).cpu().numpy()


def graph_stats(graphs: Optional[ForwardGraphs]) -> Optional[Dict]:
    """Captures, replays, seconds, pool bytes and signatures held of a
    predictor's graphs; None on the CPU."""
    if graphs is None:
        return None
    return dict(graphs.stats, signatures=len(graphs))


def save_checkpoint(run_dir, model: Union[Architecture, PairArchitecture],
                    args: Dict,
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


def read_checkpoint(path) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """(args, state_dict) of a checkpoint file: the JAX trainer's where
    the name ends in ``.ckpt``, else the port's."""
    path = Path(path)
    if path.suffix == ".ckpt":
        return load_jax_checkpoint(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return json.loads(payload["args"]), payload["state_dict"]


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
        self.graphs = forward_graphs(self.model, self.device)

    @classmethod
    def from_checkpoint(cls, run_dir, which: str = "best_save.pt",
                        batch_size: int = 32, device="cuda") -> "Predictor":
        """Serve ``run_dir/which``: the port's ``.pt`` or the JAX
        trainer's ``.ckpt``."""
        resolve_device(device)
        path = Path(run_dir) / which
        args, state = read_checkpoint(path)
        if pair_kind(args) is not None:
            raise ValueError(
                f"{path} holds a pair model (task "
                f"{args['task']!r}); serve it with PairPredictor")
        model = Architecture(config_from_args(args))
        model.load_state_dict(state)
        return cls(model, args, batch_size, device)

    def featurize(self, smiles: Sequence[str]) -> List[Optional[GraphArrays]]:
        """One graph per SMILES; None where it cannot be featurized."""
        graphs: List[Optional[GraphArrays]] = []
        for smi in smiles:
            try:
                x, snd, rcv, e = featurize_smiles(smi)
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
                    pinned = (batch.num_nodes, batch.num_edges) == (
                        self.node_budget, self.edge_budget)
                    out = served(self.model, self.graphs, (batch,), pinned)
                    outs.append(out[batch.graph_mask.numpy()])
            preds = np.concatenate(outs, axis=0)
        else:
            preds = np.zeros((0, self.out_dim), np.float32)
        width = preds.shape[1] if preds.size else self.out_dim
        full = np.full((len(smiles), width), np.nan, np.float32)
        full[np.asarray([g is not None for g in graphs], bool)] = preds
        return full

    @property
    def graph_stats(self) -> Optional[Dict]:
        return graph_stats(self.graphs)

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


class EnsemblePredictor:
    """Mean-score ensemble over several run checkpoints (the reference's
    blending, metrics.py:153-186): each output is the mean of its
    ``Predictor``s' outputs."""

    def __init__(self, predictors: List[Predictor]):
        if not predictors:
            raise ValueError("no predictors")
        self.predictors = predictors

    @classmethod
    def from_runs(cls, logs_dir, n: int = 3, dataset: Optional[str] = None,
                  batch_size: int = 32, device="cuda"
                  ) -> "EnsemblePredictor":
        """The top ``n`` runs of ``logs_dir`` (a ``log_<dataset>``
        directory) by their validation metric, as the solver's blend
        selects them, each served by ``Predictor.from_checkpoint``: a
        run of the port (``best_save.pt``) or of the JAX package
        (``best_save.ckpt``)."""
        from .automl.summary import select_top_runs
        logs_dir = Path(logs_dir)
        ds = dataset or logs_dir.name.replace("log_", "")
        sel = select_top_runs(logs_dir, ds, n)
        predictors = []
        for r in sel:
            run = logs_dir / r["id"]
            which = ("best_save.pt" if (run / "best_save.pt").is_file()
                     else "best_save.ckpt")
            predictors.append(Predictor.from_checkpoint(
                run, which=which, batch_size=batch_size, device=device))
        return cls(predictors)

    @property
    def graph_stats(self) -> Optional[Dict]:
        """Its predictors' ``graph_stats`` summed (each keeps its own
        graphs, stream and pools)."""
        each = [p.graph_stats for p in self.predictors]
        if None in each:
            return None
        return {k: sum(st[k] for st in each) for k in each[0]}

    def predict_scores(self, smiles: Sequence[str]) -> np.ndarray:
        return np.mean([p.predict_scores(smiles)
                        for p in self.predictors], axis=0)

    def predict_smiles(self, smiles: Sequence[str]) -> np.ndarray:
        return np.mean([p.predict_smiles(smiles)
                        for p in self.predictors], axis=0)


class PairPredictor:
    """Pair-model predictor: DDI (SMILES, SMILES) or DTI (SMILES,
    protein sequence + contact map); see the module docstring."""

    def __init__(self, model: PairArchitecture, args: Dict,
                 contact_maps: Optional[Dict[str, np.ndarray]] = None,
                 batch_size: int = 16, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.args = args
        self.hetero = model.hetero
        self.contact_maps = contact_maps or {}
        self.task = args.get("task", "pair_binary")
        self.out_dim = int(args.get("out_dim", 1))
        self.batch_size = max(int(batch_size), 1)
        self._pro_cache: Dict[str, GraphArrays] = {}
        # sticky (node, edge) budget floors per tower, grown as needed
        self.budget1: Optional[Tuple[int, int]] = None
        self.budget2: Optional[Tuple[int, int]] = None
        self.graphs = forward_graphs(self.model, self.device)

    @classmethod
    def from_checkpoint(cls, run_dir, which: str = "best_save.pt",
                        contact_maps: Optional[Dict[str, np.ndarray]] = None,
                        batch_size: int = 16,
                        device="cuda") -> "PairPredictor":
        resolve_device(device)
        path = Path(run_dir) / which
        args, state = read_checkpoint(path)
        pair = pair_kind(args)
        if pair is None:
            raise ValueError(f"{path} holds a single-graph model (task "
                             f"{args.get('task', '')!r}); serve it with "
                             "Predictor")
        model = PairArchitecture(config_from_args(args),
                                 hetero=pair == "hetero")
        model.load_state_dict(state)
        return cls(model, args, contact_maps, batch_size, device)

    def _protein(self, seq: str) -> Optional[GraphArrays]:
        if seq in self._pro_cache:
            return self._pro_cache[seq]
        cm = self.contact_maps.get(seq)
        if cm is None:
            return None
        g = self._pro_cache[seq] = protein_graph(seq, cm)
        return g

    def samples(self, pairs: Sequence[tuple]
                ) -> List[Optional[Tuple[GraphArrays, GraphArrays]]]:
        """One (g1, g2) per pair; None where either side cannot be
        resolved."""
        out: List[Optional[Tuple[GraphArrays, GraphArrays]]] = []
        for a, b in pairs:
            g1 = mol_graph(a)
            g2 = None if g1 is None else (
                self._protein(b) if self.hetero else mol_graph(b))
            out.append((g1, g2) if g2 is not None else None)
        return out

    def loader(self, valid) -> PairGraphLoader:
        """The padded batches of the resolved pairs ``valid``, at budgets
        no smaller than the previous calls'; the floors move up to them.
        A floor that grows supersedes the graph of the old floors, which
        can never replay again: it is freed."""
        loader = PairGraphLoader(valid, self.batch_size, 1,
                                 budget1=self.budget1, budget2=self.budget2)
        grown = (loader.budget1, loader.budget2) != (self.budget1,
                                                     self.budget2)
        self.budget1, self.budget2 = loader.budget1, loader.budget2
        if grown and self.graphs is not None:
            self.graphs.release()
        return loader

    @property
    def graph_stats(self) -> Optional[Dict]:
        return graph_stats(self.graphs)

    def predict_pairs(self, pairs: Sequence[tuple]) -> np.ndarray:
        """[N, out] outputs (logits); unresolvable pairs yield NaN
        rows."""
        samples = self.samples(pairs)
        valid = [s for s in samples if s is not None]
        outs = []
        if valid:
            with torch.inference_mode():
                for b1, b2 in self.loader(valid):
                    out = served(self.model, self.graphs, (b1, b2))
                    outs.append(out[b1.graph_mask.numpy()])
            preds = np.concatenate(outs, axis=0)
        else:
            preds = np.zeros((0, self.out_dim), np.float32)
        width = preds.shape[1] if preds.size else self.out_dim
        full = np.full((len(samples), width), np.nan, np.float32)
        full[np.asarray([s is not None for s in samples], bool)] = preds
        return full

    def predict_scores(self, pairs: Sequence[tuple]) -> np.ndarray:
        """Interaction probability per pair (sigmoid of the 1-logit DDI
        head, softmax P(class 1) of the 2-logit DTI head), else the first
        output."""
        out = self.predict_pairs(pairs)
        if self.task == "pair_binary_bce":
            return 1.0 / (1.0 + np.exp(-out[:, 0]))
        if self.task in ("pair_binary", "pair_screening"):
            ex = np.exp(out - np.nanmax(out, axis=-1, keepdims=True))
            return (ex / ex.sum(-1, keepdims=True))[:, 1]
        return out[:, 0]
