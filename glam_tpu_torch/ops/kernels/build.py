"""Build the port's CUDA sources, and its host library, into shared
libraries at first use.

Each ``glam_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``glam_tpu_torch/_build/<name>-<hash>.so``, keyed by a
hash of the source, the headers beside it and the flags, and loaded with
``ctypes``.  The
sources have a plain C interface and include no PyTorch header, so a
build takes seconds.  ``build()`` starts one ``nvcc`` per missing library,
all at once.

``build_host()`` compiles the C++ SMILES featurizer
(``csrc/glam_native.cpp``) with ``g++`` and the flags of
``native/build.sh`` into ``_build/glam_native-<hash>.so``, hashed the same
way.  Every build writes a temporary file and ``os.replace``s it into
place, so processes that build at once (trials started together) never
load a half-written library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("triplet_fused", "triplet_fused_bwd", "segment_softmax_spmm",
           "segment_softmax_spmm_bwd", "segment_sum_csr")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_SOURCES = ("glam_native",)
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``; raises if
    neither exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "port's CUDA kernels")


def source_hash(name: str) -> str:
    """A hash of ``csrc/<name>.cu``, every header in ``csrc/`` (a source
    may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_hash(name)}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in ``names``, one ``nvcc`` process
    each, started together.  Returns ``{name: ptxas report}`` for the
    libraries built now (empty for those already built)."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def find_gxx() -> str:
    """``$CXX``, else ``g++`` on ``PATH``; raises if neither exists."""
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if not gxx:
        raise RuntimeError("g++ not found: set CXX or put g++ on PATH to "
                           "build the port's native featurizer")
    return gxx


def host_source_hash(name: str) -> str:
    """A hash of ``csrc/<name>.cpp`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def host_library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{host_source_hash(name)}.so"


def build_host(name: str = "glam_native") -> bool:
    """Compile ``csrc/<name>.cpp`` with ``g++`` unless it is built;
    returns whether it was built now.  Raises if ``g++`` fails."""
    out = host_library_path(name)
    if out.is_file():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([find_gxx(), *GXX_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {name}.cpp (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return True


@functools.cache
def load_host(name: str = "glam_native") -> ctypes.CDLL:
    """The loaded host library for ``csrc/<name>.cpp``, built first if
    needed."""
    build_host(name)
    return ctypes.CDLL(str(host_library_path(name)))
