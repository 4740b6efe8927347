"""Import hygiene: every module of glam_tpu_torch imports without JAX,
flax, optax, pandas or scikit-learn, and without any module of the JAX
package (checked in a fresh interpreter).  The card's machine has none
of them."""
import subprocess
import sys

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
        "glam_tpu_torch.ops.kernels.triplet_fused"}
assert want <= set(names), sorted(want - set(names))
assert len(names) >= 30, names
banned = ("jax", "flax", "optax", "pandas", "sklearn", "glam_tpu")
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
