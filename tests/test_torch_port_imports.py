"""Import hygiene: every module of glam_tpu_torch imports without JAX and
without any module of the JAX package (checked in a fresh interpreter)."""
import subprocess
import sys

_CHECK = r"""
import importlib, pkgutil, sys
import glam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(glam_tpu_torch.__path__,
                                               "glam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
jax_mods = sorted(k for k in sys.modules
                  if k in ("jax", "flax") or k.startswith(("jax.", "flax.")))
assert not jax_mods, jax_mods
ref = sorted(k for k in sys.modules
             if k == "glam_tpu" or k.startswith("glam_tpu."))
assert not ref, ref
print("ok", len(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    res = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")
