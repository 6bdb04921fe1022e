"""Host state from the reference package into the port's tensors.

The reference builds its parameters and batches on the host as numpy
(`parallel/validation_net.py::build_params_and_batch` returns a nested
dict of arrays). `from_jax_host` turns such a dict into the same nesting
of `torch.Tensor`s on one device, so a parity test can hand both packages
the same numbers. bfloat16 arrays (numpy's `ml_dtypes.bfloat16`, which
torch cannot read directly) pass through their 16-bit pattern.

This slice carries no parameters; the later slices that port the
validation net and the workloads fill in layouts and sharding.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from kubeoperator_tpu_torch.utils.device import resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_host(host: Mapping[str, Any],
                  device: torch.device | str | None = None) -> dict[str, Any]:
    """Nested dict of numpy arrays (and scalars) → same nesting of tensors
    on `device` (default: the current CUDA card)."""
    device = resolve_device(device)
    out: dict[str, Any] = {}
    for key, value in host.items():
        if isinstance(value, Mapping):
            out[key] = from_jax_host(value, device)
        else:
            out[key] = _tensor(np.asarray(value), device)
    return out
