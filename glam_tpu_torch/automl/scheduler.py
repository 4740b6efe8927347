"""Trial scheduler: a fixed number of trial slots over the CUDA cards,
the port of the JAX package's ``automl/scheduler.py``.

The reference's GPUManager polled ``nvidia-smi`` for free memory and let
trials share a GPU (utils.py:190-246).  Here the slots come from
``GLAM_TPU_TRIAL_SLOTS`` when it is set, else one per visible card, and
slot ``s`` runs its trial on card ``s % cards`` (passed as ``--gpu``), so
several slots on one card share it.  The cards are counted with
``torch.cuda.device_count()``, which creates no CUDA context: the solver
process leaves the cards to its trials until it blends.  A trial is
launched when a slot is free; ``wait_free_slot`` and ``wait_free_device``
block until one is, as the reference's ``wait_free_gpu`` did, polling
every 0.5 s (the JAX package every 2 s), a small share of a trial."""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional


def _detect_slots(cards: int) -> int:
    env = os.environ.get("GLAM_TPU_TRIAL_SLOTS")
    if env:
        return max(1, int(env))
    return max(1, cards)


class DeviceManager:
    """Fixed-slot trial scheduler with blocking backpressure."""

    def __init__(self, num_slots: Optional[int] = None,
                 poll_interval: float = 0.5,
                 num_cards: Optional[int] = None):
        if num_cards is None:
            import torch
            num_cards = torch.cuda.device_count()   # creates no context
        self.num_cards = num_cards
        self.num_slots = num_slots if num_slots else _detect_slots(
            self.num_cards)
        self.poll_interval = poll_interval

    def card(self, slot: int) -> int:
        """The card that slot ``slot`` runs its trials on (0 without a
        card: such trials run on the CPU)."""
        return slot % self.num_cards if self.num_cards else 0

    def running(self, procs: List) -> int:
        return sum(1 for p in procs if p.poll() is None)

    def wait_free_slot(self, procs: List) -> None:
        """Block until fewer than num_slots trials are running
        (reference utils.py:219-225 30s-sleep loop, tightened)."""
        while self.running(procs) >= self.num_slots:
            time.sleep(self.poll_interval)

    def wait_free_device(self, slot_procs: Dict) -> int:
        """Block until a slot is free (it has no process, or its process
        has exited) and return it; its trial runs on ``card(slot)``."""
        while True:
            for s in range(self.num_slots):
                p = slot_procs.get(s)
                if p is None or p.poll() is not None:
                    return s
            time.sleep(self.poll_interval)
