"""Checkpointing: a tree of tensors -> (JSON manifest + one .npy per leaf)
(port of `repro.checkpoint.store`, same on-disk format).

Atomic step directories (``step_%09d``: every leaf written and fsynced in
a ``.tmp`` directory, then one rename publishes it), a ``manifest.json``
listing each leaf's ``file``, ``dtype``, ``shape`` and ``crc32``, a
dedicated :class:`CheckpointCorruptError` for truncated or bit-rotted
files, and ``keep`` garbage collection.  bf16 tensors are widened to f32
on disk (numpy has no bf16) with ``"bfloat16"`` in the manifest, as the
JAX package writes them; restoring narrows them back exactly.  The two
packages read each other's checkpoints.

Leaves are listed in JAX order (`repro_torch.tree`), and ``None`` is an
empty subtree, as in JAX, not a leaf: a ``PacedCarry(events, inner=None)``
has the same leaves in both packages.  Tensors go to the host with
``.detach().cpu()``; restore puts each leaf back on the device of the
corresponding ``tree_like`` leaf.

Restoring without an explicit ``step`` walks a fallback chain: the newest
step first and, if it is corrupt (truncated leaf, crc mismatch, mangled
manifest), the next-older intact one; only when every step is corrupt
does the newest step's error propagate.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import zlib
from typing import List, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = [
    "save_checkpoint", "restore_checkpoint", "latest_step", "list_steps",
    "CheckpointCorruptError",
]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint exists but cannot be trusted: missing manifest or leaf
    file, truncated array, or a crc32 mismatch.  Distinct from
    FileNotFoundError (no checkpoint at all) so callers can fall back to an
    older step instead of training from garbage."""


def _path_names(node, prefix: tuple, out: list) -> None:
    """(name, leaf) of every non-None leaf in JAX order; names are JAX's key
    paths (dict key, sequence index, ``.field`` of a named tuple)."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _path_names(node[k], prefix + (str(k),), out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            _path_names(v, prefix + ("." + f,), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _path_names(v, prefix + (str(i),), out)
    else:
        out.append(("/".join(prefix).replace("/", "__") or "leaf", node))


def _leaf_paths(tree) -> list:
    out: list = []
    _path_names(tree, (), out)
    return out


def _host_array(leaf):
    """(numpy array, dtype name as the manifest records it)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"  # widened: lossless
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    true_dtype = str(arr.dtype)
    if arr.dtype.kind == "V" or "bfloat16" in true_dtype or "float8" in true_dtype:
        arr = arr.astype(np.float32)
    return arr, true_dtype


def _crc32_of(arr: np.ndarray) -> int:
    # JAX's value (crc32 of the C-order bytes), read through the buffer
    # rather than a `tobytes()` copy of a multi-GB leaf
    return zlib.crc32(np.ascontiguousarray(arr).data) & 0xFFFFFFFF


def save_checkpoint(directory: str, step: int, tree, keep: int = 3) -> str:
    """Write one atomic step directory: every leaf lands in a tmp directory
    first (each file flushed and fsynced), then a single rename publishes
    the checkpoint, so a crash mid-save leaves only a ``.tmp`` directory
    that the next save overwrites."""
    step_dir = os.path.join(directory, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(_leaf_paths(tree)):
        arr, true_dtype = _host_array(leaf)
        fname = f"{i:05d}_{name[:80]}.npy"
        with open(os.path.join(tmp_dir, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append(
            {"file": fname, "dtype": true_dtype, "shape": list(arr.shape),
             "crc32": _crc32_of(arr)}
        )
        del arr
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    _gc(directory, keep)
    return step_dir


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def list_steps(directory: str) -> List[int]:
    """All published checkpoint steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _like(arr: np.ndarray, leaf, fname: str):
    """`arr` in the form of the template leaf: a tensor of its type on its
    device, a numpy array of its dtype, or a Python number."""
    if isinstance(leaf, torch.Tensor):
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {fname}: {arr.shape} vs {want}")
        # widened bf16 narrows back exactly (every value came from a bf16)
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    want = np.asarray(leaf)
    if list(arr.shape) != list(want.shape):
        raise ValueError(f"shape mismatch for {fname}: {arr.shape} vs {want.shape}")
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr.item())
    return arr if arr.dtype == want.dtype else arr.astype(want.dtype)


def restore_checkpoint(directory: str, tree_like, step: Optional[int] = None):
    """Restore into the structure of `tree_like`.

    Validates the leaf count, shapes and per-leaf crc32 checksums; a
    missing or unreadable leaf file, a short read, or a checksum mismatch
    raises :class:`CheckpointCorruptError` naming the file.  Manifests
    without a ``crc32`` key still restore (the check is skipped).

    With ``step=None`` the steps are tried newest first and the first
    intact one wins (corrupt steps are skipped with a note on stderr); the
    newest step's error propagates only when every step is corrupt.  An
    explicit ``step`` never falls back.
    """
    if step is None:
        steps = list_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        newest_err: Optional[CheckpointCorruptError] = None
        for s in reversed(steps):
            try:
                return restore_checkpoint(directory, tree_like, s)
            except CheckpointCorruptError as e:
                if newest_err is None:
                    newest_err = e
                print(
                    f"[checkpoint] step {s} is corrupt ({e}); falling "
                    "back to the next-older checkpoint",
                    file=sys.stderr, flush=True,
                )
        raise newest_err
    step_dir = os.path.join(directory, f"step_{step:09d}")
    manifest_path = os.path.join(step_dir, "manifest.json")
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(f"no checkpoint for step {step} under {directory}")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(f"{step_dir}: manifest.json is missing") from e
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"{manifest_path}: manifest is not valid JSON ({e})"
        ) from e
    all_leaves, treedef = tree_flatten(tree_like)
    slots = [i for i, x in enumerate(all_leaves) if x is not None]
    if len(slots) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected {len(slots)}"
        )
    out = list(all_leaves)
    for i, meta in zip(slots, manifest["leaves"]):
        fpath = os.path.join(step_dir, meta["file"])
        try:
            arr = np.load(fpath)
        except FileNotFoundError as e:
            raise CheckpointCorruptError(
                f"{step_dir}: leaf file {meta['file']} is missing"
            ) from e
        except ValueError as e:
            # numpy raises ValueError on truncated or garbled .npy payloads
            raise CheckpointCorruptError(
                f"{fpath}: unreadable or truncated array ({e})"
            ) from e
        if "crc32" in meta and _crc32_of(arr) != meta["crc32"]:
            raise CheckpointCorruptError(f"{fpath}: crc32 mismatch — checkpoint is corrupt")
        out[i] = _like(arr, all_leaves[i], meta["file"])
        del arr
    return tree_unflatten(treedef, out)
