"""Weighted running average (counterpart of paddle_tpu/average.py), host
numpy."""
import numpy as np

__all__ = ['WeightedAverage']


def _is_number_or_matrix(x):
    return isinstance(x, (int, float, np.ndarray)) or np.isscalar(x)


class WeightedAverage:
    """Accumulates ``add(value, weight)`` pairs; ``eval()`` is the weighted
    mean of the values' means."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            value = np.asarray(value)
        if not np.isscalar(weight) and not isinstance(weight, (int, float)):
            raise ValueError('weight must be a number')
        self.numerator += np.mean(value) * weight
        self.denominator += weight

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                'there is no data to be averaged in WeightedAverage')
        return self.numerator / self.denominator
