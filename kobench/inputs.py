"""The benchmark's inputs, made on the device from the run's seed.

Weights and batches are standard normal draws from one `torch.Generator`
on the run's device, in a few large calls, scaled and rounded to the type
they are served in. The same seed, device and call order give the same
tensors, so the reference can make them again after the program's state
is freed instead of holding a copy.
"""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def normal(shape, gen: torch.Generator, dtype: torch.dtype,
           scale: float = 1.0) -> torch.Tensor:
    """One draw of `shape` from `gen`, times `scale`, rounded to `dtype`
    (drawn in float32, rounded to nearest even)."""
    t = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    if scale != 1.0:
        t.mul_(scale)
    return t.to(dtype)


def normal_tree(shapes: dict, gen: torch.Generator, dtype: torch.dtype,
                scale: float) -> dict:
    """One draw per leaf of `shapes`, in its key order."""
    return {name: normal(shape, gen, dtype, scale)
            for name, shape in shapes.items()}
