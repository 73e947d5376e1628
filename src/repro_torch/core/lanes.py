"""Lanes: S seeds × C configs of one algorithm as one batched step.

A lane-batched state (`core.algorithms.BatchedAlgorithm`) keeps each
node-stacked leaf as [L, m, ...], lane l = c·S + s, and its step counter
and key as int64 arrays [L].  A step views the leaves as [L·m, ...] (a
reshape, no copy) and runs the algorithm's node loop over the L·m rows:
row r is node r % m of lane r // m.  What keeps the lanes apart:

  * keys are per lane, always an int64 ndarray [L] (an int is one
    unbatched key): a lane's key is folded with the step and with the
    node's index *within its lane*, never with its row index (`fold`,
    `node_key`), so lane l draws what its unbatched run draws;
  * hyperparameters swept across configs are per-lane tuples
    (`lane_value`, `scale_`, `scaled`) — a type a key never has;
  * node means and metrics are reduced lane by lane (`lane_mean`,
    `lane_slices`);
  * the exchange gathers over tables whose every slot of lane l, padding
    included, is offset by l·m (`offset_rows`, used by
    `core.mixing.fold_padded` and `core.pame.fold_topology_arrays`), so
    no lane reads another lane's rows — not even through a weight of 0.0,
    which would carry a NaN across.

An unbatched state (int step and key) is one lane of all its rows, and
every helper here then reduces to the unbatched arithmetic.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["LaneKey", "count", "keys", "fold", "lane_key", "node_key", "lane_value",
           "lane_slices", "lane_mean", "scale_", "scaled", "offset_rows"]

# an unbatched key (int) or one key per lane (int64 ndarray [L])
LaneKey = Union[int, np.ndarray]


def _fold_in(key: int, data: int) -> int:
    # imported here: `core.pme` imports `core.mixing`, which imports this module
    from repro_torch.core.pme import fold_in

    return fold_in(key, data)


def count(key: LaneKey) -> Optional[int]:
    """The lane count of a lane-batched key, None for an unbatched one."""
    return len(key) if isinstance(key, np.ndarray) else None


def keys(key: LaneKey) -> List[int]:
    """Each lane's key as an int (one for an unbatched key)."""
    return [int(k) for k in key] if isinstance(key, np.ndarray) else [int(key)]


def fold(key: LaneKey, data) -> LaneKey:
    """`fold_in` lane by lane: each lane's key with `data` (an int, or one
    int per lane)."""
    if not isinstance(key, np.ndarray):
        return _fold_in(key, data)
    ds = np.broadcast_to(np.asarray(data), key.shape)
    return np.array([_fold_in(int(k), int(d)) for k, d in zip(key, ds)], dtype=np.int64)


def lane_key(key: LaneKey, lane: int) -> int:
    return int(key[lane]) if isinstance(key, np.ndarray) else key


def node_key(key: LaneKey, row: int, m: int) -> int:
    """The key of row `row` (m rows a lane): its lane's key folded with the
    node's index within the lane."""
    return _fold_in(lane_key(key, row // m), row % m)


def _per_lane(v) -> bool:
    return isinstance(v, (tuple, list))


def lane_value(v, lane: int):
    """A hyperparameter's value in `lane` (a per-lane tuple or a scalar)."""
    return v[lane] if _per_lane(v) else v


def lane_slices(rows: int, key: LaneKey) -> List[slice]:
    """The row ranges of the lanes of `key` over `rows` rows."""
    n = count(key) or 1
    m = rows // n
    return [slice(lane * m, (lane + 1) * m) for lane in range(n)]


def lane_mean(vals: Sequence[torch.Tensor], key: LaneKey) -> torch.Tensor:
    """The mean of per-row scalars: one value for an unbatched key, [L]
    (each lane's mean, reduced as its unbatched run reduces it) for a
    lane-batched one."""
    if count(key) is None:
        return torch.stack(list(vals)).mean()
    return torch.stack([torch.stack(list(vals[sl])).mean()
                        for sl in lane_slices(len(vals), key)])


def scale_(t: torch.Tensor, v, key: LaneKey) -> torch.Tensor:
    """t *= v in place, each lane's rows by its own value."""
    if not _per_lane(v):
        return t.mul_(v)
    for sl, val in zip(lane_slices(t.shape[0], key), v):
        t[sl].mul_(val)
    return t


def scaled(t: torch.Tensor, v, key: LaneKey) -> torch.Tensor:
    """t * v as a new tensor, each lane's rows by its own value."""
    if not _per_lane(v):
        return t * v
    out = torch.empty_like(t)
    for sl, val in zip(lane_slices(t.shape[0], key), v):
        torch.mul(t[sl], val, out=out[sl])
    return out


def offset_rows(tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """L lanes' [m, k] row-index tables as one [L·m, k] table: every entry
    of lane l's table, padding slots included, offset by l·m."""
    m = tables[0].shape[0]
    return torch.cat([t + lane * m for lane, t in enumerate(tables)])
