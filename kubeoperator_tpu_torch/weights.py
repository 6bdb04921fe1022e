"""Host state into the port's tensors, and each rank's shard of it.

The reference builds its parameters and batches on the host as numpy
(`parallel/validation_net.py::build_params_and_batch` returns the `host`
dict of arrays). `from_jax_host` turns such a dict into the same nesting of
`torch.Tensor`s on one device, so a parity test can hand both packages the
same numbers; given a mesh and a placement table (which dim of each
parameter is cut along which mesh axis, as the validation net's
`param_specs` gives it), it returns this rank's local shard of each
parameter instead. bfloat16 arrays (numpy's `ml_dtypes.bfloat16`, which
torch cannot read directly) pass through their 16-bit pattern.

`bf16_from_f64` is the port's own rounding of host draws to bfloat16, bit
for bit what the reference's `astype(ml_dtypes.bfloat16)` gives: that cast
rounds to float32 first and then to bfloat16, both to nearest even, and so
does this, on the integer bit pattern (a direct rounding of the float64
value breaks some ties the other way).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.utils.device import resolve_device


def bf16_from_f64(a: np.ndarray) -> torch.Tensor:
    """float64 (or float32) array → bfloat16 CPU tensor, rounded through
    float32 to nearest even at each step."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    nan = np.isnan(bits.view(np.float32))
    rounded = (bits >> 16) & 1
    rounded += bits
    rounded += 0x7FFF            # finite values cannot carry past bit 31
    rounded >>= 16
    out = rounded.astype(np.uint16)
    out[nan] = 0x7FC0
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


def from_f64(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A float64 host draw as a CPU tensor of a configuration's `dtype`
    ("bfloat16" through `bf16_from_f64`, else float32), rounded as the
    reference rounds it."""
    if dtype == "bfloat16":
        return bf16_from_f64(a)
    return torch.from_numpy(a.astype(np.float32))


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """numpy array (bfloat16 included) → CPU tensor of the same type."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))   # keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def spec_axes(entry: str | Sequence[str] | None) -> tuple[str, ...]:
    """The mesh axes one entry of a placement cuts a dim along: none, one,
    or a tuple of axes taken major to minor (as ``P(("data", "fsdp"))``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shard(t: torch.Tensor, spec: Sequence[str | Sequence[str] | None],
                mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the global `t`: dim i is cut into equal parts
    along the mesh axes of spec[i] (None: kept whole; several axes: their
    coordinates flattened row-major) and the part at this rank's coordinate
    is kept. Dims past the end of `spec` are kept whole."""
    names = mesh.mesh_dim_names
    for dim, entry in enumerate(spec):
        parts, index = 1, 0
        for axis in spec_axes(entry):
            size = mesh.size(names.index(axis))
            parts, index = parts * size, index * size + mesh.get_local_rank(axis)
        if parts > 1:
            size = t.shape[dim] // parts
            t = t.narrow(dim, index * size, size)
    return t.contiguous()


def place(host: Mapping[str, torch.Tensor], mesh: DeviceMesh,
          specs: Mapping[str, Sequence[str | None]],
          device: torch.device) -> dict[str, torch.Tensor]:
    """Each global host tensor's local shard (`specs[name]`) on `device`."""
    return {k: local_shard(v, specs[k], mesh).to(device) for k, v in host.items()}


def from_jax_host(host: Mapping[str, Any],
                  device: torch.device | str | None = None,
                  mesh: DeviceMesh | None = None,
                  specs: Mapping[str, Sequence[str | None]] | None = None
                  ) -> dict[str, Any]:
    """Nested dict of numpy arrays (and scalars) → same nesting of tensors
    on `device` (default: the current CUDA card). With `mesh` and `specs`,
    `host` is a flat dict of global arrays and each tensor is this rank's
    shard of it (`place`)."""
    device = resolve_device(device)
    if (mesh is None) != (specs is None):
        raise ValueError("from_jax_host: pass mesh and specs together")
    if mesh is not None:
        return place({k: host_tensor(np.asarray(v)) for k, v in host.items()},
                     mesh, specs, device)
    out: dict[str, Any] = {}
    for key, value in host.items():
        if isinstance(value, Mapping):
            out[key] = from_jax_host(value, device)
        else:
            out[key] = host_tensor(np.asarray(value)).to(device)
    return out
