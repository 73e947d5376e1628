"""Communication topologies for decentralized federated learning.

Builds the undirected communication graph G = ([m], E), the neighbor sets
N_i, and the doubly-stochastic communication matrix B of Assumption 1
(PaME paper, Sec. IV-A).  The paper defines B_ji = 1/m_i for j in N_i which
is doubly stochastic only for regular graphs; for general graphs we use the
standard Metropolis–Hastings weights (symmetric, doubly stochastic) and keep
the paper's definition for regular topologies where the two coincide.

This is the port's own copy of `repro.core.topology` (numpy only): for the
same arguments and seed every array it builds is bitwise equal to the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "Topology",
    "ring_graph",
    "grid_graph",
    "complete_graph",
    "star_graph",
    "erdos_renyi_graph",
    "regular_graph",
    "build_topology",
    "metropolis_matrix",
    "spectral_gap_zeta",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A fixed communication graph plus derived quantities.

    Attributes:
      m: number of nodes.
      adjacency: [m, m] 0/1 symmetric numpy array, zero diagonal.
      neighbor_sets: tuple of tuples, N_i for each node i (excludes i).
      mixing: [m, m] doubly-stochastic matrix B (float64).
      zeta: max(|lambda_2|, |lambda_m|) of B — Assumption 1 spectral gap.
    """

    m: int
    adjacency: np.ndarray
    neighbor_sets: Tuple[Tuple[int, ...], ...]
    mixing: np.ndarray
    zeta: float

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1).astype(np.int64)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    def neighbor_matrix_padded(self) -> Tuple[np.ndarray, np.ndarray]:
        """Pad neighbor lists to [m, max_degree] for device-side sampling.

        Returns (nbrs, valid) where nbrs[i, :] lists N_i padded with i's own
        index and valid[i, :] marks real entries.
        """
        d = self.max_degree
        nbrs = np.tile(np.arange(self.m)[:, None], (1, d))
        valid = np.zeros((self.m, d), dtype=bool)
        for i, ns in enumerate(self.neighbor_sets):
            nbrs[i, : len(ns)] = ns
            valid[i, : len(ns)] = True
        return nbrs, valid

    def mixing_padded(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The mixing matrix B in padded neighbor-exchange form.

        Returns (nbrs, w, is_self), each [m, max_degree + 1]: row i lists
        N_i ∪ {i} in ascending sender order with the receive weight
        w[i, slot] = B[nbrs[i, slot], i]; padding slots repeat i with weight
        exactly 0.0 so they are no-ops under IEEE summation.  This is the
        O(m·deg·n) gather form consumed by `repro_torch.core.mixing.mix_padded`,
        replacing the dense O(m²·n) einsum on sparse graphs.
        """
        k = self.max_degree + 1
        nbrs = np.tile(np.arange(self.m)[:, None], (1, k)).astype(np.int32)
        w = np.zeros((self.m, k), dtype=np.float32)
        is_self = np.zeros((self.m, k), dtype=bool)
        for i, ns in enumerate(self.neighbor_sets):
            ids = sorted(list(ns) + [i])
            nbrs[i, : len(ids)] = ids
            w[i, : len(ids)] = self.mixing[ids, i]
            is_self[i, : len(ids)] = np.asarray(ids) == i
        return nbrs, w, is_self


def _adjacency_from_edges(m: int, edges: List[Tuple[int, int]]) -> np.ndarray:
    a = np.zeros((m, m), dtype=np.int64)
    for i, j in edges:
        if i == j:
            continue
        a[i, j] = 1
        a[j, i] = 1
    return a


def ring_graph(m: int) -> np.ndarray:
    if m < 2:
        raise ValueError("ring needs m >= 2")
    return _adjacency_from_edges(m, [(i, (i + 1) % m) for i in range(m)])


def grid_graph(m: int) -> np.ndarray:
    """2-D torus grid; m must have an integer-ish factorization r*c."""
    r = int(np.floor(np.sqrt(m)))
    while m % r != 0:
        r -= 1
    c = m // r
    edges = []
    for i in range(r):
        for j in range(c):
            u = i * c + j
            edges.append((u, i * c + (j + 1) % c))
            edges.append((u, ((i + 1) % r) * c + j))
    return _adjacency_from_edges(m, edges)


def complete_graph(m: int) -> np.ndarray:
    a = np.ones((m, m), dtype=np.int64) - np.eye(m, dtype=np.int64)
    return a


def star_graph(m: int) -> np.ndarray:
    """CFL as a special case of DFL (paper Sec. I)."""
    return _adjacency_from_edges(m, [(0, i) for i in range(1, m)])


def erdos_renyi_graph(m: int, p: float, seed: int = 0) -> np.ndarray:
    """Random G(m, p) conditioned on connectivity (re-draw until connected)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        upper = rng.random((m, m)) < p
        a = np.triu(upper, k=1).astype(np.int64)
        a = a + a.T
        if _is_connected(a):
            return a
    raise RuntimeError("failed to sample a connected G(m,p); raise p")


def regular_graph(m: int, degree: int, seed: int = 0) -> np.ndarray:
    """Random d-regular graph via repeated configuration-model draws."""
    import networkx as nx

    g = nx.random_regular_graph(degree, m, seed=seed)
    a = np.zeros((m, m), dtype=np.int64)
    for u, v in g.edges:
        a[u, v] = 1
        a[v, u] = 1
    if not _is_connected(a):
        return regular_graph(m, degree, seed=seed + 1)
    return a


def _is_connected(a: np.ndarray) -> bool:
    m = a.shape[0]
    seen = np.zeros(m, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.nonzero(a[u])[0]:
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen.all())


def metropolis_matrix(adjacency: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings doubly-stochastic mixing matrix.

    B_ij = 1/(1+max(d_i, d_j)) for (i,j) in E, diagonal absorbs the rest.
    Symmetric => doubly stochastic; for d-regular graphs equals the paper's
    1/m_i row rule up to the self-weight.
    """
    a = adjacency
    m = a.shape[0]
    deg = a.sum(axis=1)
    b = np.zeros((m, m), dtype=np.float64)
    for i in range(m):
        for j in np.nonzero(a[i])[0]:
            b[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(b, 1.0 - b.sum(axis=1))
    return b


def spectral_gap_zeta(mixing: np.ndarray) -> float:
    """zeta = max(|lambda_2(B)|, |lambda_m(B)|) — Assumption 1, Eq. (10)."""
    eig = np.sort(np.linalg.eigvalsh(mixing))[::-1]
    return float(max(abs(eig[1]), abs(eig[-1])))


_BUILDERS = {
    "ring": lambda m, **kw: ring_graph(m),
    "grid": lambda m, **kw: grid_graph(m),
    "complete": lambda m, **kw: complete_graph(m),
    "star": lambda m, **kw: star_graph(m),
    "erdos_renyi": lambda m, **kw: erdos_renyi_graph(
        m, kw.get("p", 0.4), kw.get("seed", 0)
    ),
    "regular": lambda m, **kw: regular_graph(
        m, kw.get("degree", 4), kw.get("seed", 0)
    ),
}


def build_topology(kind: str, m: int, **kwargs) -> Topology:
    if kind not in _BUILDERS:
        raise ValueError(f"unknown topology {kind!r}; pick from {sorted(_BUILDERS)}")
    a = _BUILDERS[kind](m, **kwargs)
    if not _is_connected(a):
        raise ValueError(f"{kind} graph on m={m} is not connected")
    nsets = tuple(tuple(int(j) for j in np.nonzero(a[i])[0]) for i in range(m))
    b = metropolis_matrix(a)
    return Topology(
        m=m,
        adjacency=a,
        neighbor_sets=nsets,
        mixing=b,
        zeta=spectral_gap_zeta(b),
    )
