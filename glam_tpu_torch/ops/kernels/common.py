"""What the wrappers of the port's CUDA kernels share: argument checks,
the zeroed ticket buffer of the kernels that merge rows crossing chunks,
and the launch call."""
from __future__ import annotations

import functools

import torch


def check(name, t, device, dtype, shape):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_TICKETS = {}
_RETIRED = []


def tickets(dev, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets for kernels on ``stream``: one
    buffer per device and stream, zeroed when made or grown (the kernels
    leave it zeroed), so a call needs no fill.  Kernels on one stream run
    in turn, so they share it.  A CUDA graph's capture may not make or
    grow one (the buffer would live in the graph's pool): the calls run
    eagerly on the capture's stream first (``cuda_graphs.py``), and a
    capture that finds none raises.  A grown buffer's predecessor is kept,
    never freed: a graph captured before the growth still replays over
    it."""
    key = (dev.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"no ticket buffer of {n} for stream {stream} on cuda:"
                f"{dev.index} during a CUDA graph capture: run the step "
                "on the capture's stream before capturing it")
        if buf is not None:
            _RETIRED.append((key, buf))
        buf = torch.zeros((max(n, 1024),), device=dev, dtype=torch.int32)
        _TICKETS[key] = buf
    return buf



def dirty_tickets():
    """{(device index, stream): {index: value}} of every nonzero ticket
    (at most 16 a buffer); empty when every buffer is zero, as the
    kernels leave them.  Reads the buffers: synchronizes with the
    device."""
    out = {}
    for key, buf in list(_TICKETS.items()) + _RETIRED:
        nz = torch.nonzero(buf).flatten()[:16].tolist()
        if nz:
            out.setdefault(key, {}).update(zip(nz, buf[nz].tolist()))
    return out


@functools.cache
def sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def run(launch, name, dev, args, stream):
    """Call ``launch(*args, stream)`` with ``dev`` current; raise on a
    launch error."""
    if dev.index == torch.cuda.current_device():
        err = launch(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def up4(n: int) -> int:
    """``n`` rounded up to a multiple of 4 (floats to 16 bytes)."""
    return (n + 3) & ~3


def aligned(*tensors) -> bool:
    """Whether every tensor starts at a 16-byte boundary (float4 loads)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)
