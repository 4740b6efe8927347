"""Port featurizer, padded batches and receiver CSR against the JAX
package: byte-identical featurizer output, value-identical padded arrays,
and the CSR's invariants."""
import numpy as np
import pandas as pd
import pytest
import torch

from conftest import SMILES_SET
from glam_tpu.chem import featurize as jax_featurize
from glam_tpu.data import graph as jax_graph
from glam_tpu_torch.chem import featurize as port_featurize
from glam_tpu_torch.data import graph as port_graph
from glam_tpu_torch.data.batching import GraphLoader

DEMO = pd.read_csv("datasets/demo/raw/demo.csv").smiles.tolist()
INVALID = ["C1CC", "xyz", "", "C(C", "C)C", "[C", "N1CC2"]


def _graphs(mod_featurize, mod_graph, smis):
    out = []
    for s in smis:
        x, snd, rcv, e = mod_featurize.smiles_to_arrays(s)
        out.append(mod_graph.GraphArrays(nodes=x, edges=e, senders=snd,
                                         receivers=rcv,
                                         y=np.ones(1, np.float32), smi=s))
    return out


class TestFeaturizer:
    @pytest.mark.parametrize("corpus", ["conftest", "demo300"])
    def test_byte_identical(self, corpus):
        smis = SMILES_SET if corpus == "conftest" else DEMO[:300]
        n_ok = 0
        for s in smis:
            try:
                want = jax_featurize.smiles_to_arrays(s)
            except ValueError:
                with pytest.raises(ValueError):
                    port_featurize.smiles_to_arrays(s)
                continue
            got = port_featurize.smiles_to_arrays(s)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape, s
                assert a.tobytes() == b.tobytes(), s
            n_ok += 1
        assert n_ok >= len(smis) - 2

    @pytest.mark.parametrize("smi", INVALID)
    def test_invalid_raises_alike(self, smi):
        with pytest.raises(ValueError):
            jax_featurize.smiles_to_arrays(smi)
        with pytest.raises(port_featurize.FeaturizeError):
            port_featurize.smiles_to_arrays(smi)


FIELDS = ("nodes", "edges", "senders", "receivers", "node_graph",
          "node_pos", "n_node", "node_mask", "edge_mask", "graph_mask", "y")


class TestPadGraphs:
    @pytest.mark.parametrize("smis,num_graphs,extra", [
        (SMILES_SET, 6, (8, 16)),        # includes methane (no edges)
        (SMILES_SET, 9, (0, 0)),          # padding graph slots
        (["C"], 2, (3, 5)),               # methane alone: E_real = 0
        (DEMO[:40], 40, (24, 48)),
    ])
    def test_array_for_array(self, smis, num_graphs, extra):
        jg = _graphs(jax_featurize, jax_graph, smis)
        pg = _graphs(port_featurize, port_graph, smis)
        n = sum(g.nodes.shape[0] for g in jg) + 1 + extra[0]
        e = max(sum(g.senders.shape[0] for g in jg), 1) + extra[1]
        want = jax_graph.pad_graphs(jg, num_graphs, n, e, 1)
        got = port_graph.pad_graphs(pg, num_graphs, n, e, 1)
        for f in FIELDS:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        # index dtypes: int64 for torch indexing, int32 for the kernel
        assert got.senders.dtype == torch.int64
        assert got.csr_snd.dtype == torch.int32

    def test_over_budget_raises(self):
        pg = _graphs(port_featurize, port_graph, SMILES_SET)
        with pytest.raises(ValueError):
            port_graph.pad_graphs(pg, 6, 8, 8, 1)
        with pytest.raises(ValueError):
            port_graph.pad_graphs(pg, 2, 1000, 1000, 1)


class TestCSR:
    @pytest.mark.parametrize("smis", [SMILES_SET, DEMO[:64], ["C", "C"]])
    def test_invariants(self, smis):
        pg = _graphs(port_featurize, port_graph, smis)
        e_tot = sum(g.senders.shape[0] for g in pg)
        b = next(iter(GraphLoader(pg, batch_size=len(pg), num_tasks=1,
                                  edge_budget=e_tot + 16)))
        assert b.num_edges > e_tot          # padded edges exist
        e_off = int(b.edge_mask.sum())
        rowptr = b.csr_rowptr.numpy()
        snd, eid = b.csr_snd.numpy(), b.csr_eid.numpy()
        assert rowptr.shape == (b.num_nodes + 1,)
        # the slot arrays run to the edge budget; the rows end at E_real
        assert rowptr[0] == 0 and rowptr[-1] == e_off
        assert len(snd) == len(eid) == b.num_edges
        assert (np.diff(rowptr) >= 0).all()
        # every real edge exactly once in the rows, padded edges past them
        # in order, sent by the last node
        assert sorted(eid[:e_off].tolist()) == list(range(e_off))
        np.testing.assert_array_equal(eid[e_off:],
                                      np.arange(e_off, b.num_edges))
        assert (snd[e_off:] == b.num_nodes - 1).all()
        snd, eid = snd[:e_off], eid[:e_off]
        rcv_all, snd_all = b.receivers.numpy(), b.senders.numpy()
        rcv = np.repeat(np.arange(b.num_nodes), np.diff(rowptr))
        np.testing.assert_array_equal(rcv_all[eid], rcv)
        np.testing.assert_array_equal(snd_all[eid], snd)
        # sorted by receiver, stable within a receiver
        for r in range(b.num_nodes):
            ids = eid[rowptr[r]:rowptr[r + 1]]
            assert (np.diff(ids) > 0).all()
        # no edge into the padding rows
        n_real = int(b.node_mask.sum())
        assert rowptr[n_real] == rowptr[-1]

    @pytest.mark.parametrize("smis,edge_pad", [(DEMO[:64], 300),
                                               (["C", "C"], 5),
                                               (SMILES_SET, 0)])
    def test_real_edges_first_and_eid_a_permutation(self, smis, edge_pad):
        """The invariant the backward kernel relies on to write d_eh and
        d_pre without a fill: pad_graphs puts the E_real real edges first
        (padded ones after them) and csr_eid's first E_real slots, those of
        the CSR's rows, are a permutation of [0, E_real); the slots past
        them, to the edge budget, hold the padded edges in order."""
        pg = _graphs(port_featurize, port_graph, smis)
        n_tot = sum(g.nodes.shape[0] for g in pg) + 3
        e_real = sum(g.senders.shape[0] for g in pg)
        b = port_graph.pad_graphs(pg, len(pg), n_tot, e_real + edge_pad, 1)
        mask = b.edge_mask.numpy()
        assert mask[:e_real].all() and not mask[e_real:].any()
        eid = b.csr_eid.numpy()
        assert eid.dtype == np.int32 and len(eid) == e_real + edge_pad
        assert int(b.csr_rowptr[-1]) == e_real
        np.testing.assert_array_equal(np.sort(eid[:e_real]),
                                      np.arange(e_real))
        np.testing.assert_array_equal(eid[e_real:],
                                      np.arange(e_real, e_real + edge_pad))
        assert (b.edges.numpy()[e_real:] == 0).all()

    def test_loader_budgets_and_order(self):
        pg = _graphs(port_featurize, port_graph, DEMO[:50])
        loader = GraphLoader(pg, batch_size=16, num_tasks=1)
        batches = list(loader)
        assert len(batches) == len(loader) == 4
        assert {b.num_nodes for b in batches} == {loader.node_budget}
        assert int(batches[-1].graph_mask.sum()) == 2
        shuf = GraphLoader(pg, batch_size=16, num_tasks=1, shuffle=True)
        a = [b.nodes.sum().item() for b in shuf]
        c = [b.nodes.sum().item() for b in shuf]
        assert a != c   # reshuffled per epoch
