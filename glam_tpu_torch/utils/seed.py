"""Reproducibility helpers: a copy of the JAX package's
``utils/seed.py`` that also seeds torch's default generators.

The model's own noise (dropout, RReLU) is drawn from the trainer's
explicit ``torch.Generator``; these seeds cover the host-side random
state and anything drawn from torch's defaults."""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 1234) -> None:
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
