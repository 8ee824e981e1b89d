"""Weighted running average (reference python/paddle/fluid/average.py
WeightedAverage — the event-loop-side metric accumulator book chapters use
to average per-batch losses/accuracies weighted by batch size), a copy of
``paddle_tpu/fluid/average.py`` (host numpy; no device work).

Reference semantics kept exactly: the numerator accumulates
``value * weight`` ELEMENTWISE (an array value stays an array), the weight
must be a number, and ``eval()`` returns numerator/denominator — so for an
array-valued metric the result is the weighted elementwise mean, not the
mean of per-batch scalar means."""
from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) or (
        isinstance(v, np.ndarray) and v.ndim == 0
    )


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not (_is_number(value) or isinstance(value, np.ndarray)):
            raise ValueError(
                "The 'value' must be a number or a numpy ndarray.")
        if not _is_number(weight):
            raise ValueError("The 'weight' must be a number.")
        value = np.asarray(value, dtype=np.float64)
        weight = float(weight)
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator = self.numerator + value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        if self.denominator == 0.0:
            raise ValueError(
                "The 'denominator' of WeightedAverage can not be 0.")
        return self.numerator / self.denominator
