"""Synthetic high-frequency data streams with controllable distribution shift.

The container ships no image datasets (MNIST/CIFAR/CLEAR...), so the paper's
benchmark *protocols* are reproduced over generated streams (documented in
DESIGN.md §9). Three stream families cover the paper's three regimes:

- ``iid``        : stationary distribution (CORe50-iid-style)
- ``split``      : K tasks presented sequentially, disjoint class subsets
                   (Split-MNIST/CIFAR-style class-incremental)
- ``drift``      : slowly rotating class prototypes (CLEAR-style natural
                   distribution shift)

Two modalities:
- classification vectors (x ∈ R^d, y ∈ [C)) for the paper-scale MLP/ConvNet
  analogues, and
- token sequences for the LM architectures (next-token prediction over a
  drifting Markov source), so Ferret runs on the assigned archs end-to-end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    kind: str = "drift"  # iid | split | drift
    modality: str = "tokens"  # tokens | vectors
    length: int = 512  # number of stream items (rounds)
    batch: int = 1  # items arrive one microbatch at a time
    seed: int = 0

    # vectors modality
    dim: int = 32
    num_classes: int = 10
    noise: float = 0.25

    # tokens modality
    vocab: int = 256
    seq: int = 32
    markov_order: int = 1

    # shift controls
    num_tasks: int = 5  # split: number of sequential tasks
    drift_rate: float = 0.02  # drift: radians of prototype rotation per item


def _rotate(protos: np.ndarray, angle: float) -> np.ndarray:
    """Rotate prototypes in every consecutive (2i, 2i+1) plane — all feature
    dims drift, like natural covariate shift."""
    c, s = np.cos(angle), np.sin(angle)
    out = protos.copy()
    d = protos.shape[1] - protos.shape[1] % 2
    x0, x1 = protos[:, 0:d:2].copy(), protos[:, 1:d:2].copy()
    out[:, 0:d:2] = c * x0 - s * x1
    out[:, 1:d:2] = s * x0 + c * x1
    return out


def make_stream(cfg: StreamConfig) -> Dict[str, np.ndarray]:
    """Materializes the stream as stacked arrays over rounds.

    vectors: {'x': (R, b, dim), 'labels': (R, b)}
    tokens : {'tokens': (R, b, seq), 'labels': (R, b, seq)}
    """
    rng = np.random.default_rng(cfg.seed)
    R, b = cfg.length, cfg.batch
    if cfg.modality == "vectors":
        return _vector_stream(cfg, rng)
    if cfg.modality == "tokens":
        return _token_stream(cfg, rng)
    raise ValueError(cfg.modality)


def _vector_stream(cfg: StreamConfig, rng) -> Dict[str, np.ndarray]:
    R, b, d, C = cfg.length, cfg.batch, cfg.dim, cfg.num_classes
    protos = rng.normal(size=(C, d)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    xs = np.zeros((R, b, d), np.float32)
    ys = np.zeros((R, b), np.int32)
    for m in range(R):
        if cfg.kind == "drift":
            protos = _rotate(protos, cfg.drift_rate)
            allowed = np.arange(C)
        elif cfg.kind == "split":
            task = min(m * cfg.num_tasks // R, cfg.num_tasks - 1)
            per = C // cfg.num_tasks
            allowed = np.arange(task * per, (task + 1) * per)
        else:
            allowed = np.arange(C)
        y = rng.choice(allowed, size=b)
        xs[m] = protos[y] + cfg.noise * rng.normal(size=(b, d))
        ys[m] = y
    return {"x": xs, "labels": ys}


def _token_stream(cfg: StreamConfig, rng) -> Dict[str, np.ndarray]:
    """Markov token source whose transition matrix drifts / switches by task."""
    R, b, V, s = cfg.length, cfg.batch, cfg.vocab, cfg.seq

    def random_transition():
        # sparse-ish transition: each state prefers ~4 successors
        T = rng.random((V, V)).astype(np.float32) ** 8
        T /= T.sum(axis=1, keepdims=True)
        return T

    T0, T1 = random_transition(), random_transition()
    toks = np.zeros((R, b, s + 1), np.int64)
    state = rng.integers(0, V, size=(b,))
    for m in range(R):
        if cfg.kind == "split":
            task = min(m * cfg.num_tasks // R, cfg.num_tasks - 1)
            mix = task / max(cfg.num_tasks - 1, 1)
        elif cfg.kind == "drift":
            mix = min(1.0, m * cfg.drift_rate)
        else:
            mix = 0.0
        T = (1.0 - mix) * T0 + mix * T1
        cum = np.cumsum(T, axis=1)
        seqs = np.zeros((b, s + 1), np.int64)
        seqs[:, 0] = state
        for t in range(1, s + 1):
            u = rng.random(b)[:, None]
            seqs[:, t] = (cum[seqs[:, t - 1]] < u).sum(axis=1)
        state = seqs[:, -1]
        toks[m] = seqs
    return {
        "tokens": toks[:, :, :-1].astype(np.int32),
        "labels": toks[:, :, 1:].astype(np.int32),
    }
