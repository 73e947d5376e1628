"""Synthetic datasets (numpy only): the port's copy of `repro.data.synthetic`.

`make_linear_regression` and `make_logistic_regression` are the paper's
Examples 1 and 2, `SyntheticClassification` the class-conditional Gaussian
images standing in for Fashion-MNIST / CIFAR-10 (Examples 3 and 4: the
heterogeneity mechanisms act on labels, so they are reproduced exactly),
and `SyntheticTokens` the non-IID token corpus of the LM trainer.  For the
same arguments and seed each is bitwise equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "make_linear_regression",
    "make_logistic_regression",
    "SyntheticClassification",
    "SyntheticTokens",
]


def make_linear_regression(
    m: int, samples_per_node: int, n: int, seed: int = 0, noise: float = 0.5,
    nonzero_frac: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paper Example 1: b = <a, w*> + 0.5 e, w* has 1% nonzeros in
    [0.5,2] U [-2,-0.5].  Returns (A [m,S,n], b [m,S], w_star [n])."""
    rng = np.random.default_rng(seed)
    w_star = np.zeros(n)
    nnz = max(1, int(round(nonzero_frac * n)))
    idx = rng.choice(n, nnz, replace=False)
    w_star[idx] = rng.uniform(0.5, 2.0, nnz) * rng.choice([-1.0, 1.0], nnz)
    a = rng.standard_normal((m, samples_per_node, n))
    b = a @ w_star + noise * rng.standard_normal((m, samples_per_node))
    return a.astype(np.float32), b.astype(np.float32), w_star.astype(np.float32)


def make_logistic_regression(
    m: int, samples_per_node: int, n: int, seed: int = 0, nonzero_frac: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paper Example 2: labels from sigmoid(<a, w*>), w* 50% nonzero."""
    rng = np.random.default_rng(seed)
    w_star = np.zeros(n)
    nnz = max(1, int(round(nonzero_frac * n)))
    idx = rng.choice(n, nnz, replace=False)
    w_star[idx] = rng.uniform(0.5, 2.0, nnz) * rng.choice([-1.0, 1.0], nnz)
    a = rng.standard_normal((m, samples_per_node, n))
    p = 1.0 / (1.0 + np.exp(-(a @ w_star)))
    b = (rng.random((m, samples_per_node)) < p).astype(np.float32)
    return a.astype(np.float32), b, w_star.astype(np.float32)


@dataclasses.dataclass
class SyntheticClassification:
    """Class-conditional Gaussian images; stand-in for FMNIST / CIFAR-10."""

    images: np.ndarray  # [N, H, W, C] float32
    labels: np.ndarray  # [N] int32
    n_classes: int

    @staticmethod
    def make(
        n_samples: int = 4096,
        shape: Tuple[int, int, int] = (28, 28, 1),
        n_classes: int = 10,
        seed: int = 0,
        sep: float = 2.0,
    ) -> "SyntheticClassification":
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, n_classes, n_samples).astype(np.int32)
        # one Gaussian mean-image per class; output standardized to unit
        # variance (as real image pipelines do) so loss scales are sane
        means = rng.standard_normal((n_classes,) + shape).astype(np.float32) * sep
        images = means[labels] + rng.standard_normal(
            (n_samples,) + shape
        ).astype(np.float32)
        images /= np.sqrt(sep**2 + 1.0)
        return SyntheticClassification(images, labels, n_classes)


@dataclasses.dataclass
class SyntheticTokens:
    """Deterministic synthetic token corpus for LM training.

    Per-node Markov-ish streams: node i's unigram distribution is a
    Dirichlet draw, giving *feature-distribution* heterogeneity for the
    language-model DFL experiments (the LM analogue of label skew).
    """

    tokens: np.ndarray  # [m, N] int32

    @staticmethod
    def make(
        m: int, per_node: int, vocab: int, seed: int = 0, alpha: float = 0.3
    ) -> "SyntheticTokens":
        rng = np.random.default_rng(seed)
        toks = np.empty((m, per_node), np.int32)
        for i in range(m):
            probs = rng.dirichlet(np.full(min(vocab, 512), alpha))
            support = rng.choice(vocab, min(vocab, 512), replace=False)
            toks[i] = support[rng.choice(len(probs), per_node, p=probs)]
        return SyntheticTokens(toks)
