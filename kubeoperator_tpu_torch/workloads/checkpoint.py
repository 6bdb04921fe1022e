"""Sharded training checkpoints: content-hashed per-leaf files written
atomically, manifest last (port of `workloads/checkpoint.py`).

Layout on disk — one directory per checkpoint, the reference's byte for
byte (the same file names and sha256 for the same state):

    <root>/<checkpoint-id>/
        params-wqkv-3fa9c1d2.npy      # one file per TrainState leaf,
        opt-0-mu-wqkv-88ab01ef.npy    # named by its /-joined tree path
        ...                           # + the first 8 hex of its sha256
        manifest.json                 # written LAST — its presence IS
                                      # the completeness bit

* **Atomic writes**: every durable byte goes through `atomic_write_bytes`
  — tmp file in the same directory, fsync, `os.replace`.
* **Manifest last**: a directory without a readable manifest is not a
  checkpoint; restore refuses it and `sweep_torn` deletes it.
* **Gather/re-place mesh portability**: files hold the gathered global
  leaves (`make_shard_and_gather_fns`'s gather), so a checkpoint saved on
  one mesh restores onto any mesh the specs fit. Restore checks shapes and
  dtypes against the live TrainState template (`train_state_shapes`).

A leaf is written as `np.save` writes it in the reference. A bfloat16 leaf
(which numpy holds only through `ml_dtypes`) gets the header that
`np.save` writes for such an array, ``'descr': '<V2'``, and its raw 16-bit
patterns — and so, like the reference's, it reads back as ``|V2`` and
fails restore's dtype check: a bf16 TrainState saves but does not restore
in either package.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import shutil

import numpy as np
import torch

from kubeoperator_tpu_torch.utils.errors import KoError
from kubeoperator_tpu_torch.utils.ids import new_id, now_ts
from kubeoperator_tpu_torch.workloads.partition import (
    tree_map_with_path,
    tree_paths,
)

log = logging.getLogger("ko_tpu.workloads.checkpoint")

MANIFEST_NAME = "manifest.json"
CHECKPOINT_FORMAT = 1


class CheckpointError(KoError):
    """A checkpoint directory that cannot be trusted (missing/corrupt
    shard, manifest/template mismatch) or a save that cannot proceed."""


# ---------------------------------------------------------------- writes ----
def atomic_write_bytes(path: str, data: bytes) -> None:
    """THE durable-write helper: write to a tmp file in the target's own
    directory, flush+fsync, then `os.replace` — the write is visible either
    whole or not at all, and the tmp name carries a recognizable `.tmp-`
    marker the torn-sweep removes."""
    tmp = f"{path}.tmp-{os.getpid()}-{new_id()[:8]}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: str, obj: dict) -> None:
    atomic_write_bytes(
        path, json.dumps(obj, indent=1, sort_keys=True).encode("utf-8"))


def _leaf_array(leaf) -> tuple[np.ndarray, str]:
    """A host leaf (CPU tensor, numpy array or scalar) as (numpy array,
    dtype name); a bfloat16 leaf comes back as its 16-bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def leaf_to_bytes(leaf) -> bytes:
    """One leaf in .npy form, as the reference's `np.save` writes it."""
    return _npy_bytes(*_leaf_array(leaf))


def _npy_bytes(arr: np.ndarray, dtype: str) -> bytes:
    buf = io.BytesIO()
    if dtype == "bfloat16":
        np.lib.format.write_array_header_1_0(
            buf, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        buf.write(np.ascontiguousarray(arr, dtype="<u2").tobytes())
    else:
        np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def leaf_from_bytes(data: bytes):
    return np.load(io.BytesIO(data), allow_pickle=False)


def _shard_filename(path: str, sha: str) -> str:
    return f"{path.replace('/', '-')}-{sha[:8]}.npy"


# ----------------------------------------------------------------- save ----
def save_checkpoint(root_dir: str, state_host, *, step: int,
                    target_steps: int = 0, mesh: dict | None = None,
                    op_id: str = "", losses=(), seed: int = 0,
                    checkpoint_id: str = "") -> dict:
    """Write one complete checkpoint of a HOST (gathered) TrainState under
    `root_dir`; returns the manifest (which carries the checkpoint id and
    directory). Every shard is content-hashed and written via the atomic
    helper; the manifest lands strictly last."""
    ckpt_id = checkpoint_id or new_id()
    directory = os.path.join(root_dir, ckpt_id)
    os.makedirs(directory, exist_ok=True)
    leaves = []
    for path, leaf in tree_paths(state_host):
        arr, dtype = _leaf_array(leaf)
        data = _npy_bytes(arr, dtype)
        sha = hashlib.sha256(data).hexdigest()
        fname = _shard_filename(path, sha)
        atomic_write_bytes(os.path.join(directory, fname), data)
        leaves.append({
            "path": path,
            "file": fname,
            "sha256": sha,
            "shape": list(arr.shape),
            "dtype": dtype,
            "bytes": len(data),
        })
    manifest = {
        "format": CHECKPOINT_FORMAT,
        "id": ckpt_id,
        "dir": directory,
        "op_id": op_id,
        "step": int(step),
        "target_steps": int(target_steps),
        "mesh": dict(mesh or {}),
        "seed": int(seed),
        "losses": [float(l) for l in losses],
        "leaves": leaves,
        "total_bytes": sum(l["bytes"] for l in leaves),
        "created_at": now_ts(),
    }
    atomic_write_json(os.path.join(directory, MANIFEST_NAME), manifest)
    return manifest


def manifest_sha(manifest: dict) -> str:
    """Stable content hash of a manifest."""
    return hashlib.sha256(
        json.dumps(manifest, sort_keys=True).encode("utf-8")).hexdigest()


# -------------------------------------------------------------- restore ----
def load_manifest(directory: str) -> dict:
    """The directory's manifest, or CheckpointError when absent/unreadable
    — an absent manifest is the torn-save signature."""
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(path, encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"{directory} holds no readable {MANIFEST_NAME} ({e}) — a "
            f"save died before completing; this directory is not a "
            f"checkpoint") from None
    if manifest.get("format") != CHECKPOINT_FORMAT:
        raise CheckpointError(
            f"{directory}: unsupported checkpoint format "
            f"{manifest.get('format')!r} (this build reads "
            f"{CHECKPOINT_FORMAT})")
    return manifest


def _dtype_name(dtype: torch.dtype) -> str:
    """A template leaf's dtype as numpy names it ("float32", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def _read_shard(directory: str, entry: dict) -> bytes:
    fpath = os.path.join(directory, entry["file"])
    try:
        with open(fpath, "rb") as f:
            return f.read()
    except OSError as e:
        raise CheckpointError(
            f"{directory}: shard {entry['file']} unreadable ({e})"
        ) from None


def restore_checkpoint(directory: str, like) -> tuple:
    """Read a complete checkpoint back as a HOST TrainState (numpy leaves)
    shaped like `like` (`train_state_shapes()`, the template that supplies
    the structure and validates compatibility). Returns
    ``(state_host, manifest)``.

    Every shard is re-hashed against the manifest, the leaf set must match
    the template exactly, and shapes/dtypes are checked leaf by leaf in
    the template's order; the first mismatch is named."""
    manifest = load_manifest(directory)
    by_path = {l["path"]: l for l in manifest["leaves"]}
    flat = tree_paths(like)
    template_paths = [path for path, _ in flat]
    missing = [p for p in template_paths if p not in by_path]
    extra = [p for p in by_path if p not in set(template_paths)]
    if missing or extra:
        raise CheckpointError(
            f"{directory} does not match the live TrainState: "
            f"missing leaves {missing[:3]}, unexpected {extra[:3]} — "
            f"checkpoint and workload disagree about the model")
    arrays = {}
    for path_str, tmpl in flat:
        entry = by_path[path_str]
        data = _read_shard(directory, entry)
        sha = hashlib.sha256(data).hexdigest()
        if sha != entry["sha256"]:
            raise CheckpointError(
                f"{directory}: shard {entry['file']} content hash "
                f"mismatch (manifest {entry['sha256'][:8]}, file "
                f"{sha[:8]}) — refusing to restore corrupt state")
        arr = leaf_from_bytes(data)
        want = _dtype_name(tmpl.dtype)
        if list(arr.shape) != list(tmpl.shape) or str(arr.dtype) != want:
            raise CheckpointError(
                f"{directory}: leaf {path_str} is "
                f"{arr.shape}/{arr.dtype}, the live TrainState wants "
                f"{tuple(tmpl.shape)}/{want} — model "
                f"config mismatch")
        arrays[path_str] = arr
    return tree_map_with_path(lambda path, _: arrays[path], like), manifest


def verify_checkpoint(directory: str) -> dict:
    """Hash-verify every shard against the manifest without building a
    state tree. Returns the manifest; raises CheckpointError on any
    mismatch."""
    manifest = load_manifest(directory)
    for entry in manifest["leaves"]:
        data = _read_shard(directory, entry)
        if hashlib.sha256(data).hexdigest() != entry["sha256"]:
            raise CheckpointError(
                f"{directory}: shard {entry['file']} failed hash "
                f"verification")
    return manifest


# ---------------------------------------------------------------- sweep ----
# a save takes seconds; a manifest-less directory YOUNGER than this may
# be a peer replica's save still in flight, so the boot sweep must not
# rmtree it out from under them. Anything older is debris.
TORN_MIN_AGE_S = 900.0


def _dir_age_s(directory: str) -> float:
    """Seconds since the NEWEST write anywhere in the directory (the
    directory itself counts: an empty dir's own mtime is its age)."""
    newest = os.path.getmtime(directory)
    for fn in os.listdir(directory):
        try:
            newest = max(newest,
                         os.path.getmtime(os.path.join(directory, fn)))
        except OSError:
            pass
    return max(now_ts() - newest, 0.0)


def sweep_torn(root_dir: str, min_age_s: float = TORN_MIN_AGE_S,
               _depth: int = 0) -> list[str]:
    """Boot hygiene: delete checkpoint directories left WITHOUT a readable
    manifest (the torn-save signature) plus any stranded `.tmp-*` files
    inside complete ones. Returns the removed paths.

    Tenant namespaces (`<root>/<tenant>/<checkpoint-id>/`) are swept
    per-namespace: a manifest-less directory that CONTAINS subdirectories
    is a namespace, not a torn save — the sweep recurses one level into it.

    `min_age_s` is the multi-replica guard: a manifest-less directory
    whose newest write is younger than this is treated as a peer's save
    still in flight. Tests pass 0 to sweep their own fresh turds."""
    removed: list[str] = []
    if not os.path.isdir(root_dir):
        return removed
    for name in sorted(os.listdir(root_dir)):
        directory = os.path.join(root_dir, name)
        if not os.path.isdir(directory):
            continue
        try:
            load_manifest(directory)
        except CheckpointError:
            if _depth == 0 and any(
                    os.path.isdir(os.path.join(directory, child))
                    for child in os.listdir(directory)):
                # a tenant namespace: sweep INSIDE it, never the namespace
                removed.extend(sweep_torn(directory, min_age_s, _depth=1))
                continue
            if _dir_age_s(directory) < min_age_s:
                log.info("checkpoint dir %s has no manifest but was "
                         "written recently — possibly a peer's in-flight "
                         "save, leaving it", directory)
                continue
            shutil.rmtree(directory, ignore_errors=True)
            removed.append(directory)
            log.warning("swept torn checkpoint %s (no complete manifest)",
                        directory)
            continue
        if _dir_age_s(directory) < min_age_s:
            continue
        for fn in sorted(os.listdir(directory)):
            if ".tmp-" in fn:
                try:
                    os.unlink(os.path.join(directory, fn))
                    removed.append(os.path.join(directory, fn))
                except OSError:
                    pass
    return removed
