"""Leaving a process group (``parallel/distributed.py`` ``shutdown``).

An nccl communicator's destruction waits for every CUDA graph that holds
its collectives to be destroyed.  A trainer holds its step graphs in a
reference cycle (the graphs hold its steps, which hold the trainer), so
a rank that destroyed its group while such a cycle waited for the
garbage collector hung there, after its work was done (the 4-card data
parallel ``time`` task of ``tests/torch_port_dp_worker.py``).
``shutdown`` collects the cycles first.  Here, on the CPU, a group of
one gloo rank: an object in a reference cycle is gone once ``shutdown``
returns, and the group with it.  On a card (marked ``cuda``), a process
of one nccl rank that leaves a captured all-reduce in such a cycle
leaves its group and exits.
"""
import gc
import subprocess
import sys
import weakref
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from glam_tpu_torch.parallel import distributed


class _Holder:
    """Stands for a trainer whose step graphs refer back to it."""

    def __init__(self):
        self.graphs = {"steps": self}


def test_shutdown_collects_cycles_before_leaving():
    threads = torch.get_num_threads()     # a rank sets its share
    distributed.initialize_distributed(
        f"127.0.0.1:{distributed.free_port()}", 1, 0, platform="cpu")
    gc.disable()                 # only shutdown may collect the cycle
    try:
        held = weakref.ref(_Holder())
        assert held() is not None
        distributed.shutdown()
        assert held() is None
    finally:
        gc.enable()
        torch.set_num_threads(threads)
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()


# one nccl rank: a CUDA graph holding an all-reduce, left in a reference
# cycle, then ``shutdown``
_NCCL_RANK = """
import gc
import torch
from glam_tpu_torch.cuda_graphs import CapturedCalls
from glam_tpu_torch.parallel import distributed

class Holder:
    pass

gc.disable()
distributed.initialize_distributed(
    f"127.0.0.1:{distributed.free_port()}", 1, 0)
assert torch.distributed.get_backend() == "nccl"
x = torch.ones(1024, device="cuda")

def body():
    y = x * 2.0
    torch.distributed.all_reduce(y)
    return (y,)

calls = CapturedCalls(torch.device("cuda"))
calls.capture_error_mode = distributed.CAPTURE_ERROR_MODE["nccl"]
calls.warm_up(body)
graph = calls.capture(body)
(y,) = calls.replay(graph)
assert torch.equal(y.cpu(), torch.full((1024,), 2.0))
holder = Holder()
holder.graphs = {"step": (calls, graph), "trainer": holder}
del holder, graph, calls, y
distributed.shutdown()
print("left the group")
"""


@pytest.mark.cuda
def test_nccl_rank_leaves_with_a_captured_collective_in_a_cycle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _NCCL_RANK], cwd=root,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "left the group" in proc.stdout
