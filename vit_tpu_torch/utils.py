"""Seeding and parameter counting (port of part of ``vit_tpu/utils.py``)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch

__all__ = ["seed_everything", "count_params"]


def seed_everything(seed: int = 42) -> int:
    """Seed Python's, numpy's and torch's global generators. The port's own
    randomness (weights, dropout seeds, noise) comes from explicit
    ``torch.Generator``s; this covers library code that draws globally."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def count_params(module: torch.nn.Module) -> int:
    """Total number of scalar parameters."""
    return sum(p.numel() for p in module.parameters())
