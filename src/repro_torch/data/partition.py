"""Non-IID partitioners — the paper's heterogeneity mechanisms (numpy only:
the port's copy of `repro.data.partition`, bitwise equal to it for the same
arguments and seed).

  * label_skew_partition — each node sees samples from exactly C classes
    (paper Fig. 11, C in {1, 7, 10}); lower C = more heterogeneous.
  * dirichlet_partition  — class mix per node ~ Dir(beta) (paper Fig. 12,
    beta in {0.3, 0.6}); lower beta = more heterogeneous.
  * iid_partition        — uniform shuffle baseline.
"""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["iid_partition", "label_skew_partition", "dirichlet_partition"]


def iid_partition(labels: np.ndarray, m: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, m)]


def label_skew_partition(
    labels: np.ndarray, m: int, classes_per_node: int, seed: int = 0
) -> List[np.ndarray]:
    """Each node is assigned `classes_per_node` classes and receives an
    equal share of every assigned class's samples.

    Raises ValueError when `classes_per_node` falls outside
    ``[1, n_classes]`` (beyond n_classes the round-robin would silently
    assign the same class to a node twice) and when any node would end up
    with an empty shard (downstream batchers cannot sample from it).
    """
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    if not 1 <= classes_per_node <= n_classes:
        raise ValueError(
            f"classes_per_node={classes_per_node} outside [1, {n_classes}]: "
            f"the dataset has {n_classes} classes, so larger values would "
            "double-assign a class to the same node"
        )
    by_class = [np.nonzero(labels == c)[0] for c in range(n_classes)]
    for c, idx in enumerate(by_class):
        if len(idx) == 0:
            raise ValueError(
                f"class {c} has no samples; every class in [0, labels.max()] "
                "must be populated to cover its assigned nodes"
            )
        rng.shuffle(idx)
    # round-robin class assignment so every class is covered
    assign = [
        [(i * classes_per_node + j) % n_classes for j in range(classes_per_node)]
        for i in range(m)
    ]
    # per class, how many nodes want it -> split its indices that many ways
    takers: List[List[int]] = [[] for _ in range(n_classes)]
    for i, cls_list in enumerate(assign):
        for c in cls_list:
            takers[c].append(i)
    shares = [np.array_split(by_class[c], max(1, len(takers[c]))) for c in range(n_classes)]
    parts: List[List[np.ndarray]] = [[] for _ in range(m)]
    for c in range(n_classes):
        for k, node in enumerate(takers[c]):
            parts[node].append(shares[c][k])
    out = []
    for i, p in enumerate(parts):
        shard = np.sort(np.concatenate(p)) if p else np.array([], np.int64)
        if len(shard) == 0:
            starved = assign[i]
            raise ValueError(
                f"node {i} received an empty shard (assigned classes "
                f"{starved} have too few samples for "
                f"{[len(takers[c]) for c in starved]} takers); use more "
                "data or fewer nodes"
            )
        out.append(shard)
    return out


def dirichlet_partition(
    labels: np.ndarray, m: int, beta: float, seed: int = 0, min_size: int = 2
) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        parts: List[List[int]] = [[] for _ in range(m)]
        for c in range(n_classes):
            idx = np.nonzero(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(m, beta))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for node, chunk in enumerate(np.split(idx, cuts)):
                parts[node].extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_size:
            return [np.sort(np.array(p, np.int64)) for p in parts]
    raise RuntimeError("dirichlet partition failed min_size; raise beta")
