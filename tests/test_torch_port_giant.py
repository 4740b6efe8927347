"""The port's giant-protein demo (``scripts/giant_protein_demo_torch.py``)
against the JAX package's (``scripts/giant_protein_demo.py``), on the
CPU:

  * its generator equals the JAX script's, array for array, at L = 200
    for seeds 0-2;
  * ``--L 200 --shards 2 --pairs 6 --platform cpu`` trains on 2 gloo
    ranks, exits 0, prints its plan line, and its plan (node, edge, a2a
    and ring budgets and the resolved ``--halo auto``) equals the JAX
    ``ShardedPairTrainer._plan_pro_budgets`` on the same corpus.

The JAX script configures JAX when it is imported, so its side runs in a
subprocess of its own (``JAX_PLATFORMS=cpu``), while the port's ranks
run.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import giant_protein_demo_torch as giant  # noqa: E402

L, SHARDS, PAIRS = 200, 2, 6

# the JAX side: its proteins at L for seeds 0-2 and its trainer's plan of
# the corpus the demo builds from them
JAX_SIDE = f"""
import json, sys, types
import numpy as np
sys.path[:0] = ["scripts", "."]
import giant_protein_demo as g
from glam_tpu.train.sharded_pair_trainer import ShardedPairTrainer
pros = [g.synth_protein({L}, s) for s in range(3)]
np.savez(sys.argv[1], **{{f"{{s}}_{{k}}": getattr(p, k) for s, p in
                          enumerate(pros) for k in
                          ("nodes", "edges", "senders", "receivers")}})
pairs = [(g.synth_mol(i, float(i % 2)), pros[i % 3]) for i in range({PAIRS})]
me = types.SimpleNamespace(halo="auto", n_shards={SHARDS})
nb, eb, hb, ring = ShardedPairTrainer._plan_pro_budgets(me, pairs)
print(json.dumps({{"node_budget": int(nb), "edge_budget": int(eb),
                  "a2a_budget": int(hb), "ring": [int(r) for r in ring],
                  "halo": me.halo}}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's demo run: its exit code and output; the JAX side's
    proteins and plan)."""
    tmp = tmp_path_factory.mktemp("giant")
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    port = subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "giant_protein_demo_torch.py"),
         "--L", str(L), "--shards", str(SHARDS), "--pairs", str(PAIRS),
         "--platform", "cpu", "--work_dir", str(tmp / "work")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    jax_side = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(tmp / "jax.npz")], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    out, _ = port.communicate(timeout=300)
    assert jax_side.returncode == 0, jax_side.stderr[-3000:]
    plan = json.loads(jax_side.stdout.strip().splitlines()[-1])
    return (port.returncode, out), (np.load(tmp / "jax.npz"), plan)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generator_equals_the_jax_script(runs, seed):
    _, (arrays, _) = runs
    got = giant.synth_protein(L, seed)
    for k in ("nodes", "edges", "senders", "receivers"):
        want = arrays[f"{seed}_{k}"]
        assert getattr(got, k).dtype == want.dtype, k
        np.testing.assert_array_equal(getattr(got, k), want, err_msg=k)


def test_demo_on_two_cpu_ranks_plans_as_the_jax_trainer(runs):
    (rc, out), (_, want) = runs
    assert rc == 0, out[-4000:]
    lines = out.splitlines()
    assert any(l.startswith("plan: node_budget ") for l in lines), out
    got = json.loads(lines[-1])
    assert got["L"] == L and got["shards"] == SHARDS
    for k in ("node_budget", "edge_budget", "a2a_budget", "ring", "halo"):
        assert got["plan"][k] == want[k], k
    assert np.isfinite(got["val_loss"])
    assert all(r["steps"] == 2 for r in got["launches_by_rank"])


_NO_JAX = r"""
import sys
sys.path[:0] = ["scripts", "tests", "."]
import chip_smoke, ddi_spread, giant_protein_demo_torch, largest_protein_torch
import profile_overlap_torch, sharded_cards
giant_protein_demo_torch.synth_protein(50, 0)
giant_protein_demo_torch.synth_mol(0, 1.0)
largest_protein_torch.build(50, 1, "cpu")
banned = ("jax", "flax", "optax", "pandas", "sklearn", "glam_tpu")
found = sorted(k for k in sys.modules
               if k in banned or k.startswith(tuple(b + "." for b in banned)))
assert not found, found
print("ok")
"""


def test_scripts_import_no_jax():
    """The new scripts (and the smoke they read) import no JAX, flax,
    optax, pandas, scikit-learn or module of the JAX package, as
    tests/test_torch_port_imports.py checks the package: the card's
    machine has none of them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout[-2000:] + res.stderr[-3000:]
