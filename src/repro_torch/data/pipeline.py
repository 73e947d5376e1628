"""Per-node sub-batch sampling B_i^k (Alg. 1 line 12) as a data pipeline.

NodeBatcher owns per-node index pools and serves node-stacked numpy batches
[m, batch, ...] each round, with independent per-node shuffling (numpy only:
the port's copy of `repro.data.pipeline`, the same per-node streams and
epoch reshuffles).  Moving a batch to the device is the caller's
``batch_fn``'s job, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["NodeBatcher"]


class NodeBatcher:
    def __init__(
        self,
        arrays: Dict[str, np.ndarray],  # each [N, ...] global arrays
        parts: Sequence[np.ndarray],    # per-node index lists into N
        batch_size: int,
        seed: int = 0,
    ):
        self.arrays = arrays
        self.parts = [np.asarray(p) for p in parts]
        self.m = len(parts)
        self.batch = batch_size
        self._rngs = [np.random.default_rng(seed + 7919 * i) for i in range(self.m)]
        self._cursors = [len(p) for p in self.parts]  # force shuffle on first use
        self._orders: List[Optional[np.ndarray]] = [None] * self.m

    def _next_indices(self, i: int) -> np.ndarray:
        part = self.parts[i]
        if len(part) == 0:
            raise ValueError(f"node {i} has an empty shard")
        out = np.empty(self.batch, np.int64)
        filled = 0
        while filled < self.batch:
            if self._cursors[i] >= len(part):
                self._orders[i] = self._rngs[i].permutation(len(part))
                self._cursors[i] = 0
            take = min(self.batch - filled, len(part) - self._cursors[i])
            sel = self._orders[i][self._cursors[i] : self._cursors[i] + take]
            out[filled : filled + take] = part[sel]
            filled += take
            self._cursors[i] += take
        return out

    def next(self, step: int = 0) -> Dict[str, np.ndarray]:
        del step
        idx = np.stack([self._next_indices(i) for i in range(self.m)])  # [m, b]
        return {k: v[idx] for k, v in self.arrays.items()}
