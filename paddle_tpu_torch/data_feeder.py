"""DataFeeder (counterpart of paddle_tpu/data_feeder.py): turns a batch of
python rows into the feed dict of batched numpy arrays, each cast and
reshaped to its feed variable's declared type and shape.

A ``lod_level > 0`` variable whose rows differ in length needs a LoD
tensor, which the port does not have yet: such a batch raises naming
ROADMAP A.10."""
from __future__ import annotations

import numpy as np

from .core.dtypes import convert_dtype
from .framework import Variable

__all__ = ['DataFeeder']


class DataFeeder:
    """``DataFeeder(feed_list, place=None, program=None)``: ``feed_list``
    holds Variables (cast and reshaped to their declaration) or names
    (stacked as given); ``place`` and ``program`` are kept and unused, as
    in the JAX package (the Executor moves feeds to its device)."""

    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = feed_list
        self.place = place

    @staticmethod
    def _convert(var, arr):
        """Cast and reshape one batched array to its feed var's
        declaration."""
        if isinstance(var, Variable):
            want = np.dtype(convert_dtype(var.dtype)
                            .replace('bfloat16', 'float32'))
            arr = arr.astype(want, copy=False)
            tail = list(var.shape[1:])
            if tail and all(s > 0 for s in tail):
                arr = arr.reshape((arr.shape[0], *tail))
        return arr

    def feed(self, iterable):
        """Rows (one item a feed variable each) -> {name: batched array}."""
        columns = None
        for row in iterable:
            if columns is None:
                columns = [[] for _ in row]
            for c, item in zip(columns, row):
                c.append(np.asarray(item))
        out = {}
        for var, col in zip(self.feed_vars, columns or []):
            name = var.name if isinstance(var, Variable) else var
            if (isinstance(var, Variable) and var.lod_level
                    and len({c.shape[:1] for c in col}) > 1):
                raise NotImplementedError(
                    f'DataFeeder: {name} has lod_level {var.lod_level} and '
                    f'rows of different lengths, which need a LoD tensor: '
                    f'not ported yet (ROADMAP A.10)')
            out[name] = self._convert(var, np.stack(col))
        return out

    def feed_batch(self, fields):
        """Already batched arrays, one a feed variable -> the feed dict, by
        :meth:`feed`'s cast and reshape rules."""
        out = {}
        for var, arr in zip(self.feed_vars, fields):
            name = var.name if isinstance(var, Variable) else var
            out[name] = self._convert(var, np.asarray(arr))
        return out
