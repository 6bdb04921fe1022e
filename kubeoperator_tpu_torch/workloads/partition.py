"""Partition-rule engine: regex → placement over a named tree (port of
`workloads/partition.py`).

A workload declares its layout as an ORDERED list of ``(regex, spec)``
rules. A spec is a placement tuple, one entry per dim: the mesh axis the
dim is cut along, a tuple of axes cut together (major to minor), or None
for a whole dim — the twin of the reference's `PartitionSpec`, as in
``("fsdp", None)`` or ``(("data", "fsdp"), None)``; ``()`` is replicated.
The engine matches each rule against the ``/``-joined path of every leaf
and returns a matching tree of specs. Three contracts:

* **Scalars are never partitioned** — a 0-d (or 1-element) leaf gets
  ``()`` before any rule is consulted.
* **First match wins** — rules are ordered.
* **Unmatched leaves are a hard error naming the offending path** —
  silent replication is not a fallback; `explain_rules` shows which rule
  claimed what and which rules never fired.

Trees are nested dicts, lists, tuples and namedtuples, flattened as
`jax.tree_util` flattens them: dict keys sorted, sequence indices, the
fields of a namedtuple in declaration order, None an empty node. Anything
else is a leaf. So a TrainState names its leaves exactly as the
reference's does (``opt/0/count`` before ``opt/0/mu/step``, ``params/...``
last), and the checkpoint files of both packages carry the same names.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.parallel.comm import gather_dim
from kubeoperator_tpu_torch.parallel.mesh import mesh_device
from kubeoperator_tpu_torch.utils.errors import ValidationError
from kubeoperator_tpu_torch.weights import host_tensor, local_shard, spec_axes


class PartitionError(ValidationError):
    """A param tree and a rule list that don't agree (unmatched param,
    malformed rule). ValidationError subclass so the API surface maps it
    to a 400, not a 500 — a bad layout is the caller's input."""


Rules = Sequence[tuple[str, Any]]


def _children(node) -> list | None:
    """``[(key, child)]`` of a container in flatten order; None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def _child(node, key):
    return getattr(node, key) if hasattr(node, "_fields") else node[key]


def tree_map_with_path(fn: Callable, tree, *rest):
    """`tree` with every leaf replaced by ``fn(path, leaf, *others)``, where
    `others` are the parts of the `rest` trees at the same place (so a spec
    tree, whose leaves are tuples, rides along whole). Containers keep their
    type and a dict its key order."""

    def walk(path: str, node, others):
        kids = _children(node)
        if kids is None:
            return fn(path, node, *others)
        done = {key: walk(f"{path}/{key}" if path else str(key), child,
                          [_child(o, key) for o in others])
                for key, child in kids}
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: done[k] for k in node}
        if hasattr(node, "_fields"):
            return type(node)(*(done[f] for f in node._fields))
        return type(node)(done[i] for i in range(len(node)))

    return walk("", tree, list(rest))


def tree_map(fn: Callable, tree, *rest):
    """`tree_map_with_path` without the path."""
    return tree_map_with_path(lambda _, leaf, *others: fn(leaf, *others),
                              tree, *rest)


def tree_paths(tree) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` with ``/``-joined path names, the naming contract
    every rule regex is written against."""
    out: list[tuple[str, Any]] = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _is_scalar(leaf) -> bool:
    shape = np.shape(leaf)
    return len(shape) == 0 or int(np.prod(shape)) == 1


def match_partition_rules(rules: Rules, params):
    """Tree of specs mirroring `params` (see module docstring for the three
    contracts). Only shapes are consulted."""
    compiled = [(re.compile(pattern), spec) for pattern, spec in rules]

    def spec_for(path: str, leaf):
        if _is_scalar(leaf):
            return ()
        for regex, spec in compiled:
            if regex.search(path) is not None:
                return spec
        raise PartitionError(
            f"no partition rule matches param {path!r} "
            f"(shape {tuple(np.shape(leaf))}); add a rule or rename — "
            f"silent replication is not a fallback")

    return tree_map_with_path(spec_for, params)


def explain_rules(rules: Rules, params) -> dict:
    """Rule-coverage report — the diagnostic face of the engine:

    ``claims``       ordered ``{path: {rule, spec, scalar}}`` — which rule
                     claimed each param (rule is ``"(scalar)"`` for the
                     scalar exemption, ``None`` for an unmatched param);
    ``unmatched``    paths no rule claimed (`match_partition_rules` would
                     raise on these);
    ``unused_rules`` rule patterns that never fired.
    """
    def spec_json(spec) -> list:
        # (("data","fsdp"), None) → [["data","fsdp"], None]
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    compiled = [(pattern, re.compile(pattern), spec)
                for pattern, spec in rules]
    claims: dict[str, dict] = {}
    fired: set[str] = set()
    unmatched: list[str] = []
    for path, leaf in tree_paths(params):
        if _is_scalar(leaf):
            claims[path] = {"rule": "(scalar)", "spec": [], "scalar": True}
            continue
        for pattern, regex, spec in compiled:
            if regex.search(path) is not None:
                fired.add(pattern)
                claims[path] = {"rule": pattern, "spec": spec_json(spec),
                                "scalar": False}
                break
        else:
            claims[path] = {"rule": None, "spec": None, "scalar": False}
            unmatched.append(path)
    return {
        "claims": claims,
        "unmatched": unmatched,
        "unused_rules": [pattern for pattern, _ in rules
                         if pattern not in fired],
    }


def as_tensor(leaf) -> torch.Tensor:
    """A host leaf (tensor, numpy array or scalar) as a tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return host_tensor(np.asarray(leaf))


def gather_leaf(t: torch.Tensor, spec, mesh: DeviceMesh) -> torch.Tensor:
    """The global tensor from every rank's block of it (`local_shard`'s
    inverse): each cut dim is all-gathered over its axes, minor first."""
    for dim, entry in enumerate(spec):
        for axis in reversed(spec_axes(entry)):
            t = gather_dim(t, dim, mesh.get_group(axis))
    return t


def make_shard_and_gather_fns(
    mesh: DeviceMesh, specs
) -> tuple[Callable[[Any], Any], Callable[[Any], Any]]:
    """(shard_fn, gather_fn) over whole trees: shard takes a host tree
    (tensors or numpy) to this rank's blocks on the mesh's device, per the
    spec tree; gather all-gathers every leaf back to the global tree as CPU
    tensors on every rank of the mesh (the checkpoint direction). Every
    rank of the mesh calls gather_fn together."""
    dev = mesh_device(mesh)

    def shard_fn(tree):
        return tree_map(
            lambda leaf, spec: local_shard(as_tensor(leaf), spec, mesh).to(dev),
            tree, specs)

    def gather_fn(tree):
        return tree_map(
            lambda leaf, spec: gather_leaf(leaf, spec, mesh).cpu(),
            tree, specs)

    return shard_fn, gather_fn


def replicated_specs(tree):
    """The all-replicated spec tree of `tree` (the shard_map layout)."""
    return tree_map(lambda _: (), tree)
