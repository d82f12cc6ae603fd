"""Sampler callbacks.

JAX re-design of
/root/reference/include/albatross/src/samplers/callbacks.hpp:18-100.
"""

from __future__ import annotations

import csv
from typing import IO, Optional, Sequence

import numpy as np


class NullCallback:
    def __call__(self, iteration: int, state) -> None:
        pass


class MaximumLikelihoodTrackingCallback:
    """Track the best (params, logp) seen (callbacks.hpp:30-60)."""

    def __init__(self):
        self.best_log_prob = -np.inf
        self.best_params: Optional[np.ndarray] = None
        self.best_iteration = -1

    def __call__(self, iteration: int, state) -> None:
        lp = np.asarray(state.log_prob)
        i = int(np.argmax(lp))
        if lp[i] > self.best_log_prob:
            self.best_log_prob = float(lp[i])
            self.best_params = np.asarray(state.params)[i].copy()
            self.best_iteration = iteration


class CsvWritingCallback:
    """Per-iteration chain dump: iteration, walker, log prob, param values
    (callbacks.hpp:80-100)."""

    def __init__(self, stream: IO, param_names: Sequence[str]):
        self.stream = stream
        self.writer = csv.writer(stream)
        self.param_names = list(param_names)
        self.writer.writerow(
            ["iteration", "ensemble_index", "log_probability"] + self.param_names
        )

    def __call__(self, iteration: int, state) -> None:
        params = np.asarray(state.params)
        log_prob = np.asarray(state.log_prob)
        for w in range(params.shape[0]):
            self.writer.writerow(
                [iteration, w, float(log_prob[w])]
                + [float(v) for v in params[w]]
            )
        # persist mid-run: the sampler fires callbacks per chunk, so a
        # crashed long chain keeps everything up to the last flushed chunk
        # (reference durability, callbacks.hpp:80-100)
        if hasattr(self.stream, "flush"):
            self.stream.flush()
