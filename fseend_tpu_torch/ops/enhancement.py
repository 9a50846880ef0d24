"""Mel-enhancement frontend hook (RS-EEND composition point).

The port's own copy of `fseend_tpu/ops/enhancement.py` (numpy).

The reference's RS-EEND project is a STUB — "code will be updated later"
(RS-EEND/README.md) — consisting only of configs that
compose a CleanMel mel-spectrogram enhancer with the LS-EEND backbone
(RS-EEND/configs/models/rseend.yaml:66-83, lseend_model
section = the standard LS-EEND with in_size=345).

We provide the same composition point: a ``MelEnhancer`` protocol applied to
the (T, n_mels) log-mel spectrogram BEFORE normalization/splicing.  Any
enhancement model (e.g. a CleanMel port, once its reference code exists)
plugs in here; ``IdentityEnhancer`` reproduces plain LS-EEND.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np


class MelEnhancer(Protocol):
    def __call__(self, logmel: np.ndarray) -> np.ndarray:
        """(T, n_mels) log10-mel -> enhanced (T, n_mels); must be causal
        (frame t may only use frames <= t + look_ahead) for streaming use."""
        ...


class IdentityEnhancer:
    look_ahead: int = 0

    def __call__(self, logmel: np.ndarray) -> np.ndarray:
        return logmel


class SpectralSubtractionEnhancer:
    """A simple causal baseline enhancer: running-minimum noise-floor
    subtraction in the log-mel domain (useful as a placeholder until a
    learned CleanMel-style model is plugged in). Causal: uses an
    exponential-forgetting noise estimate."""

    look_ahead: int = 0

    def __init__(self, alpha: float = 0.995, floor_init: float = -10.0):
        self.alpha = alpha
        self.floor_init = floor_init

    def __call__(self, logmel: np.ndarray) -> np.ndarray:
        out = np.empty_like(logmel)
        floor = np.full(logmel.shape[1], self.floor_init, logmel.dtype)
        for t in range(len(logmel)):
            floor = np.minimum(logmel[t], self.alpha * floor + (1 - self.alpha) * logmel[t])
            out[t] = logmel[t] - floor
        return out


def enhance_features(logmel: np.ndarray, enhancer: MelEnhancer | None) -> np.ndarray:
    if enhancer is None:
        return logmel
    return enhancer(logmel)
