"""The triplet-attention CUDA kernel against its plain torch version, on
the card.  Every test here is marked ``cuda`` and skips without a CUDA
device.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerance: rtol 1e-4, atol 1e-4 in float32.  The kernel sums each row's
edges in CSR order with an online softmax; the plain version sums with
atomics in another order, and its softmax divides after the sum.
"""
import numpy as np
import pytest
import torch

from chip_smoke import demo_csr, kernel_inputs, random_csr, read_demo
from glam_tpu_torch.data.graph import receiver_csr
from glam_tpu_torch.ops.kernels.triplet_fused import (
    triplet_attention, triplet_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _random_csr(rng, n_graphs=40):
    """Small random graphs, 64 empty rows and a receiver of in-degree
    300."""
    return random_csr(rng, n_graphs=n_graphs, max_n=30, tail=64, hub=300)


@pytest.mark.parametrize("case,heads,channels", [
    ("demo128", 3, 60),       # the flagship serving shapes
    ("random", 3, 60),        # empty rows and a 300-edge receiver
    ("random", 5, 54),        # H*C = 270, the search space's widest
    ("random", 1, 8),
    ("random", 8, 64),        # H*C = 512, the kernel's maximum
    ("no_edges", 3, 60),      # E_real = 0 (a batch of methane)
])
def test_kernel_matches_plain(cuda, case, heads, channels):
    rng = np.random.RandomState(0)
    if case == "demo128":
        csr = demo_csr(read_demo())
    elif case == "random":
        csr = _random_csr(rng)
    else:
        empty = np.zeros(0, np.int32)
        csr = receiver_csr(empty, empty, 9) + (
            np.zeros((4, 4), np.float32),)
    args = kernel_inputs(rng, *csr, heads, channels, cuda)
    before = triplet_attention.launches
    got = triplet_attention(*args, heads, channels)
    want = triplet_attention_plain(*args, heads, channels)
    torch.cuda.synchronize()
    assert triplet_attention.launches == before + 1
    assert got.shape == want.shape == (len(csr[0]) - 1, heads * channels)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    empty_rows = torch.from_numpy(np.diff(csr[0]) == 0).to(cuda)
    assert (got[empty_rows] == 0).all()


def test_kernel_rejects_what_it_cannot_take(cuda):
    rng = np.random.RandomState(1)
    csr = _random_csr(rng, n_graphs=3)
    args = kernel_inputs(rng, *csr, 6, 90, cuda)   # H*C = 540 > 512
    with pytest.raises(ValueError, match="exceeds its maximum"):
        triplet_attention(*args, 6, 90)
    args = kernel_inputs(rng, *csr, 3, 60, cuda)
    bad = list(args)
    bad[7] = bad[7].long()                          # int64 CSR
    with pytest.raises(TypeError, match="csr_snd"):
        triplet_attention(*bad, 3, 60)
    bad = list(args)
    bad[0] = bad[0].T.contiguous().T                # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        triplet_attention(*bad, 3, 60)
    bad = list(args)
    bad[1] = bad[1].cpu()                           # mixed devices
    with pytest.raises(ValueError, match="a_i is on cpu"):
        triplet_attention(*bad, 3, 60)
