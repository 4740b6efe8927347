"""Atom-level attention visualization: the port of the JAX package's
``viz/attention.py``.

``Visualizer`` runs one molecule at a time through the port's model
(``forward(g, return_nodes=True)``, on the model's device: the card
unless the caller loads it on the CPU), takes the final node embeddings
and reduces them to per-atom weights in one of four modes (the
reference ``visualize_gp.py:83-104`` modes, plus the per-head triplet
attention); ``weights(smiles)`` returns them and ``visualize`` draws
them, a PNG per molecule (per head for ``triplet_attention``).  The
reductions replay the trained readout or conv in numpy, as the JAX
package does; the drawing (``draw_molecule``, matplotlib imported when
called) uses the chemistry-standard coordinates of ``layout2d``.

    python -m glam_tpu_torch.viz.attention --ckpt <run_dir> \
        --smiles CCO c1ccccc1 --mode hidden_node --out_dir ./viz

reads a run directory of the port (``best_save.pt``) or of the JAX
package (``best_save.ckpt``) and runs on ``cuda`` unless ``--device
cpu`` is given (the JAX CLI's default is ``--platform cpu``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..chem.smiles import Mol, parse_smiles


def spring_layout(mol: Mol, iterations: int = 200,
                  seed: int = 0) -> np.ndarray:
    """2D coordinates via Fruchterman-Reingold on the molecular graph."""
    n = mol.num_atoms()
    if n == 1:
        return np.zeros((1, 2), np.float32)
    rng = np.random.RandomState(seed)
    pos = rng.randn(n, 2).astype(np.float64)
    adj = np.zeros((n, n), bool)
    for b in mol.bonds:
        adj[b.a, b.b] = adj[b.b, b.a] = True
    k = 1.0 / np.sqrt(n)
    t = 0.1
    for it in range(iterations):
        delta = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(delta, axis=-1) + 1e-9
        rep = (k * k / dist ** 2)[..., None] * delta
        att = np.where(adj[..., None], (dist / k)[..., None] * -delta, 0.0)
        disp = (rep + att).sum(axis=1)
        length = np.linalg.norm(disp, axis=-1, keepdims=True) + 1e-9
        pos += disp / length * min(t, 1.0)
        t *= 0.98
    pos -= pos.mean(0)
    scale = np.abs(pos).max() + 1e-9
    return (pos / scale).astype(np.float32)


def node_weights_from_embeddings(node_embeddings: np.ndarray) -> np.ndarray:
    """Per-atom scalar weights = mean |embedding| (reference
    'hidden_node' mode, visualize_gp.py:97-104), min-max normalized."""
    w = np.abs(node_embeddings).mean(axis=-1)
    lo, hi = w.min(), w.max()
    return (w - lo) / (hi - lo + 1e-12)


def _softmax(z: np.ndarray) -> np.ndarray:
    e = np.exp(z - z.max())
    return e / (e.sum() + 1e-16)


def lapool_attention_weights(readout_params: Dict,
                             emb: np.ndarray) -> np.ndarray:
    """Per-atom GlobalLAPool gate attention (reference 'lapool_attention'
    hook, visualize_gp.py:85-86): softmax over gate(x) for one molecule."""
    p = readout_params["gate_nn"]
    gate = emb @ np.asarray(p["kernel"]) + np.asarray(p["bias"])
    return _softmax(gate[:, 0])


def set2set_attention_weights(readout_params: Dict, emb: np.ndarray,
                              processing_steps: int = 3) -> np.ndarray:
    """Per-atom Set2Set attention of the LAST processing step (reference
    'set2set_attention' hook, visualize_gp.py:83-84): replay the LSTM
    recurrence with the trained weights on one molecule's embeddings."""
    w_ih = np.asarray(readout_params["lstm_w_ih"])
    w_hh = np.asarray(readout_params["lstm_w_hh"])
    b_ih = np.asarray(readout_params["lstm_b_ih"])
    b_hh = np.asarray(readout_params["lstm_b_hh"])
    C = emb.shape[-1]
    q_star = np.zeros((2 * C,), emb.dtype)
    h = np.zeros((C,), emb.dtype)
    c = np.zeros((C,), emb.dtype)
    alpha = np.full((emb.shape[0],), 1.0 / max(emb.shape[0], 1))
    for _ in range(processing_steps):
        z = q_star @ w_ih + b_ih + h @ w_hh + b_hh
        i, f, g, o = np.split(z, 4)
        i, f, o = (1 / (1 + np.exp(-v)) for v in (i, f, o))
        c = f * c + i * np.tanh(g)
        h = o * np.tanh(c)
        q = h
        alpha = _softmax(emb @ q)
        r = alpha @ emb
        q_star = np.concatenate([q, r])
    return alpha


def triplet_attention_weights(conv_params: Dict, emb: np.ndarray,
                              edge_attr: np.ndarray, senders: np.ndarray,
                              receivers: np.ndarray,
                              negative_slope: float = 0.2) -> np.ndarray:
    """Per-atom, PER-HEAD TripletMessage attention (beyond the
    reference's three modes): replay the trained triplet attention
    (nn/convs.py:TripletMessage) on the final node embeddings and sum,
    for every atom and head, the attention mass on its OUTGOING edges —
    "how much the model attends to messages from this atom".  Returns
    [N, heads], min-max normalized per head."""
    wn = np.asarray(conv_params["weight_node"])       # [C, H*C]
    we = np.asarray(conv_params["weight_edge"])       # [Fe, H*C]
    watt = np.asarray(conv_params["weight_triplet_att"])  # [H, 3C]
    N, C = emb.shape
    H = watt.shape[0]
    xp = (emb @ wn).reshape(N, H, C)
    ep = (edge_attr @ we).reshape(-1, H, C)
    a_i = np.einsum("nhc,hc->nh", xp, watt[:, :C])
    a_e = np.einsum("ehc,hc->eh", ep, watt[:, C:2 * C])
    a_j = np.einsum("nhc,hc->nh", xp, watt[:, 2 * C:])
    logits = a_i[receivers] + a_e + a_j[senders]      # [E, H]
    logits = np.where(logits >= 0, logits, negative_slope * logits)
    # segment softmax over incoming edges per receiver (PyG 1e-16 eps)
    mx = np.full((N, H), -np.inf, logits.dtype)
    np.maximum.at(mx, receivers, logits)
    mx = np.where(np.isfinite(mx), mx, 0.0)
    ex = np.exp(logits - mx[receivers])
    den = np.zeros((N, H), logits.dtype)
    np.add.at(den, receivers, ex)
    alpha = ex / (den[receivers] + 1e-16)             # [E, H]
    w = np.zeros((N, H), logits.dtype)
    np.add.at(w, senders, alpha)
    lo, hi = w.min(axis=0), w.max(axis=0)
    return (w - lo) / (hi - lo + 1e-12)


def draw_molecule(smiles: str, weights: Optional[np.ndarray] = None,
                  path: Optional[str] = None, title: str = ""):
    """Render the molecule colored by per-atom weights; returns the
    matplotlib figure (saved to ``path`` if given)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm

    mol = parse_smiles(smiles)
    # chemistry-standard coordinates (regular rings, 120-degree chains
    # — reference RDKit-depiction parity, visualize_gp.py:61-131);
    # spring_layout remains available as the generic-graph fallback
    from .layout2d import layout2d
    pos = layout2d(mol)
    fig, ax = plt.subplots(figsize=(5, 5))
    span = float(np.abs(pos).max()) + 1e-9
    off = 0.035 * span  # parallel-line offset, scale-relative
    nbrs = [set() for _ in range(mol.num_atoms())]
    for b in mol.bonds:
        nbrs[b.a].add(b.b)
        nbrs[b.b].add(b.a)
    for b in mol.bonds:
        pa, pb = pos[b.a], pos[b.b]
        d = pb - pa
        n = np.array([-d[1], d[0]])
        n = n / (np.linalg.norm(n) + 1e-12)
        # ring bonds put the second line on the RING side: common
        # neighbors of the endpoints sit inside the ring
        common = nbrs[b.a] & nbrs[b.b]
        side = 1.0
        if common:
            mid = (pa + pb) / 2.0
            c = np.mean([pos[x] for x in common], axis=0)
            side = 1.0 if float(n @ (c - mid)) >= 0 else -1.0
        # chemist-standard bond marks: single = one line, double = two
        # parallel, triple = three, aromatic = solid + dashed inner
        if b.order == 2:
            if common:  # in-ring double: main line + inner second line
                offsets, styles = [0.0, side], ["-", "-"]
            else:
                offsets, styles = [-0.5, 0.5], ["-", "-"]
        elif b.order == 3:
            offsets, styles = [-1.0, 0.0, 1.0], ["-", "-", "-"]
        elif b.order == 4:
            offsets, styles = [0.0, side], ["-", (0, (3, 3))]
        else:
            offsets, styles = [0.0], ["-"]
        for o, ls in zip(offsets, styles):
            q = n * o * off
            ax.plot([pa[0] + q[0], pb[0] + q[0]],
                    [pa[1] + q[1], pb[1] + q[1]], color="0.4",
                    lw=1.5, linestyle=ls, zorder=1)
    w = (weights if weights is not None
         else np.zeros(mol.num_atoms(), np.float32))
    colors = cm.coolwarm(np.clip(w, 0, 1))
    ax.scatter(pos[:, 0], pos[:, 1], s=420, c=colors, zorder=2,
               edgecolors="0.2")
    for i, atom in enumerate(mol.atoms):
        ax.annotate(atom.symbol, pos[i], ha="center", va="center",
                    fontsize=9, zorder=3)
    ax.set_title(title or smiles[:50])
    ax.axis("off")
    ax.set_aspect("equal")
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


class Visualizer:
    """Per-atom weights of a trained model over molecules, and their
    PNGs.

    ``source`` is anything with the trained ``model`` (an
    ``Architecture``) and its ``args``: a ``serve.Predictor`` or a
    ``train.trainer.Trainer``.  ``vis_content`` modes:
      hidden_node        mean |final node embedding| (any readout)
      lapool_attention   GlobalLAPool gate softmax (readout=GlobalLAPool)
      set2set_attention  last Set2Set step's attention (readout=Set2Set)
      triplet_attention  per-head TripletMessage attention replayed on
                         the final embeddings (mol_block=_TripletMessage;
                         one PNG per head)
    """

    MODES = ("hidden_node", "lapool_attention", "set2set_attention",
             "triplet_attention")

    def __init__(self, source, vis_content: str = "hidden_node"):
        if vis_content not in self.MODES:
            raise ValueError(f"Unknown content to visualize: "
                             f"{vis_content!r}; have {self.MODES}")
        cfg = source.model.cfg
        readout, block = cfg.mol_readout, cfg.mol_block.strip()
        if vis_content == "lapool_attention" and readout != "GlobalLAPool":
            raise ValueError("lapool_attention needs mol_readout="
                             f"GlobalLAPool (model has {readout})")
        if vis_content == "set2set_attention" and readout != "Set2Set":
            raise ValueError("set2set_attention needs mol_readout="
                             f"Set2Set (model has {readout})")
        if vis_content == "triplet_attention" and block != "_TripletMessage":
            raise ValueError("triplet_attention needs mol_block="
                             f"_TripletMessage (model has {block})")
        self.model = source.model
        self.args = source.args
        self.vis_content = vis_content

    def _params(self, module: torch.nn.Module) -> Dict[str, np.ndarray]:
        return {n: p.detach().cpu().numpy()
                for n, p in module.named_parameters()}

    def _weights(self, emb: np.ndarray, graph) -> np.ndarray:
        if self.vis_content == "hidden_node":
            return node_weights_from_embeddings(emb)
        if self.vis_content == "triplet_attention":
            edge_attr, senders, receivers = graph
            return triplet_attention_weights(
                self._params(self.model.mol.conv.conv), emb, edge_attr,
                senders, receivers)
        ro = self._params(self.model.mol.readout)
        if self.vis_content == "lapool_attention":
            # torch's Linear stores [out, in]; the JAX kernel is [in, out]
            gate = {"kernel": ro["gate_nn.weight"].T,
                    "bias": ro["gate_nn.bias"]}
            return lapool_attention_weights({"gate_nn": gate}, emb)
        return set2set_attention_weights(ro, emb,
                                         self.model.mol.readout
                                         .processing_steps)

    def weights(self, smiles_list: List[str]) -> List[np.ndarray]:
        """Per-atom weights of each molecule ([N] or, for
        ``triplet_attention``, [N, heads]), from one forward each."""
        from ..data.batching import GraphLoader
        from ..data.datasets import featurize_smiles
        from ..data.graph import GraphArrays

        device = next(self.model.parameters()).device
        self.model.eval()
        out = []
        for smi in smiles_list:
            x, snd, rcv, e = featurize_smiles(smi)
            g = GraphArrays(nodes=x, edges=e, senders=snd, receivers=rcv,
                            y=np.zeros(1, np.float32), smi=smi)
            batch = next(iter(GraphLoader([g], 1, 1))).to(device)
            with torch.inference_mode():
                _, node_steps = self.model(batch, return_nodes=True)
            emb = node_steps[-1][:x.shape[0]].float().cpu().numpy()
            out.append(self._weights(emb, (e, snd, rcv)))
        return out

    def visualize(self, smiles_list: List[str], out_dir: str) -> List[str]:
        """Draw ``weights(smiles_list)`` into ``out_dir``; returns the
        PNG paths."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        paths = []
        for i, (smi, w) in enumerate(zip(smiles_list,
                                         self.weights(smiles_list))):
            if w.ndim == 2:  # per-head: one rendering per head
                for h in range(w.shape[1]):
                    p = str(out / f"attention_{i}_head{h}.png")
                    draw_molecule(smi, w[:, h], path=p,
                                  title=f"{smi[:40]} head {h}")
                    paths.append(p)
            else:
                p = str(out / f"attention_{i}.png")
                draw_molecule(smi, w, path=p)
                paths.append(p)
        return paths


def main(argv=None):
    """Render attention PNGs from a trained run directory (reference
    visualize_gp.py):

    python -m glam_tpu_torch.viz.attention --ckpt <run_dir> \
        --smiles CCO c1ccccc1 --mode hidden_node --out_dir ./viz
    """
    import argparse
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--ckpt", required=True,
                   help="run directory holding best_save.pt (the port's) "
                        "or best_save.ckpt (the JAX package's)")
    p.add_argument("--which", default=None,
                   help="checkpoint file in the run directory; default "
                        "best_save.pt, else best_save.ckpt")
    p.add_argument("--smiles", nargs="+", required=True)
    p.add_argument("--mode", default="hidden_node",
                   choices=Visualizer.MODES)
    p.add_argument("--out_dir", default="./viz")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from ..serve import Predictor
    which = args.which or (
        "best_save.pt" if (Path(args.ckpt) / "best_save.pt").is_file()
        else "best_save.ckpt")
    pred = Predictor.from_checkpoint(args.ckpt, which=which,
                                     device=args.device)
    viz = Visualizer(pred, vis_content=args.mode)
    for path in viz.visualize(args.smiles, args.out_dir):
        print(path)


if __name__ == "__main__":
    main()
