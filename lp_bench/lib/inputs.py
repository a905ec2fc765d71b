"""Inputs drawn from ``--seed``: the unary images of the Potts
segmentation example (``example_pott_segmentation.py:62-66``: an image of
``round(coef_mul * U(-1, 1))``), and every other random choice a run makes.
The same seed gives the same inputs; every seed gives the same sizes."""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one use of the run's seed."""
    tag = int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.Generator(np.random.PCG64([int(seed), tag]))


def unary_images(config: dict, seed: int, count: int) -> np.ndarray:
    """``count`` integer unary images ``(count, H, W)`` of ``config``."""
    size = int(config["image_size"])
    mul = float(config["coef_mul"])
    u = rng(seed, "images").random((count, size, size))
    return np.round(mul * (u * 2.0 - 1.0))
