"""Import hygiene: every module of glam_tpu_torch, the layer library's
convs, norms, readouts, kernel C's module, the pair families' modules,
the AutoML solver's (``automl/``, ``glam``, ``demo``, ``data/perturb``,
``data/transforms``), the native featurizer's binding, the msgpack
decoder, ``data/perturb_builder``, the attention visualization, the parallel
layer (``parallel/*``, the node-sharded tower among them), the sharded
DTI trainer, the captured steps (``train/step_graph``) and the capture
core they share with the predictors (``cuda_graphs``) among them,
imports without JAX, flax, optax, pandas, scikit-learn, msgpack or
matplotlib, and without any module of the JAX package (checked in a
fresh interpreter).  The card's machine has none of them."""
import subprocess
import sys
from pathlib import Path

_CHECK = r"""
import importlib, pkgutil, sys
import glam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(glam_tpu_torch.__path__,
                                               "glam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
want = {"glam_tpu_torch.run", "glam_tpu_torch.train.trainer",
        "glam_tpu_torch.train.optim", "glam_tpu_torch.train.losses",
        "glam_tpu_torch.train.metrics", "glam_tpu_torch.data.datasets",
        "glam_tpu_torch.chem.scaffold", "glam_tpu_torch.chem.stereo",
        "glam_tpu_torch.utils.seed", "glam_tpu_torch.serve",
        "glam_tpu_torch.ops.kernels.triplet_fused",
        "glam_tpu_torch.ops.kernels.segment_softmax_spmm",
        "glam_tpu_torch.ops.segment", "glam_tpu_torch.nn.convs",
        "glam_tpu_torch.nn.norms", "glam_tpu_torch.nn.readouts",
        "glam_tpu_torch.nn.cells", "glam_tpu_torch.nn.init",
        "glam_tpu_torch.data.graph", "glam_tpu_torch.convert",
        "glam_tpu_torch.chem.proteins", "glam_tpu_torch.nn.fusion",
        "glam_tpu_torch.data.pair_datasets",
        "glam_tpu_torch.train.pair_trainer",
        "glam_tpu_torch.automl.search_space",
        "glam_tpu_torch.automl.scheduler", "glam_tpu_torch.automl.summary",
        "glam_tpu_torch.automl.ensemble", "glam_tpu_torch.automl.solver",
        "glam_tpu_torch.glam", "glam_tpu_torch.demo",
        "glam_tpu_torch.data.perturb", "glam_tpu_torch.data.transforms",
        "glam_tpu_torch.chem.native", "glam_tpu_torch.chem.fingerprints",
        "glam_tpu_torch.data.perturb_builder",
        "glam_tpu_torch.utils.msgpack", "glam_tpu_torch.viz.attention",
        "glam_tpu_torch.viz.layout2d", "glam_tpu_torch.parallel",
        "glam_tpu_torch.parallel.distributed",
        "glam_tpu_torch.parallel.data_parallel",
        "glam_tpu_torch.parallel.graph_partition",
        "glam_tpu_torch.parallel.bench_scaling",
        "glam_tpu_torch.parallel.sharded_model",
        "glam_tpu_torch.train.sharded_pair_trainer",
        "glam_tpu_torch.train.step_graph", "glam_tpu_torch.cuda_graphs"}
assert want <= set(names), sorted(want - set(names))
assert len(names) >= 30, names
banned = ("jax", "flax", "optax", "pandas", "sklearn", "msgpack",
          "matplotlib", "glam_tpu")
found = sorted(k for k in sys.modules
               if k in banned or k.startswith(tuple(b + "." for b in banned)))
assert not found, found
# the layer library builds every name the JAX package registers, and
# building it imports nothing new
from glam_tpu_torch.nn.convs import get_conv
from glam_tpu_torch.nn.norms import get_norm
from glam_tpu_torch.nn.readouts import get_readout
for c in ("_TripletMessage", "_TripletMessageLight", "_NNConv", "_GCNConv",
          "_GATConv"):
    get_conv(c, 8, 8, 4)
for n in ("_None", "_BatchNorm", "_LayerNorm", "_PairNorm",
          "_GraphSizeNorm"):
    get_norm(n, 8)
for r in ("GlobalPool5", "GlobalLAPool", "Set2Set"):
    get_readout(r, 8, 16)
found = sorted(k for k in sys.modules
               if k in banned or k.startswith(tuple(b + "." for b in banned)))
assert not found, found
print("ok", len(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    res = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax_and_no_reference_package():
    """The card's smoke run imports none of them either (its helpers,
    imported by the card tests, included)."""
    check = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
             "chip_smoke.stress_cases(); "
             "banned = ('jax', 'flax', 'optax', 'pandas', 'sklearn', "
             "'glam_tpu'); "
             "found = sorted(k for k in sys.modules if k in banned or "
             "k.startswith(tuple(b + '.' for b in banned))); "
             "assert not found, found; print('ok')")
    res = subprocess.run([sys.executable, "-c", check], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")
