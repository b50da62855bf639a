"""Scope: the runtime store of persistable values (counterpart of
paddle_tpu/core/scope.py), a flat name -> torch tensor map with an optional
parent. The executor reads a program's persistables from it and writes
them back after each run.

The executor may write a new value into the tensor the scope holds
(executor.py, in-place state). A tensor that has left the scope keeps its
contents all the same, as the JAX package's immutable arrays do: the
public accessors (:meth:`Scope.find`, :meth:`Scope.var`) mark the tensor
they return as handed out, and so does :meth:`Scope.set` (its caller
holds the tensor it stores), and the executor never writes a marked
tensor in place (:func:`handed_out`). On the CPU a ``.numpy()`` of a
tensor shares its memory, and no reference count sees it, so a mark is
the only way to know. The executor reads and writes through
:meth:`Scope._find` and :meth:`Scope._put`, which do not mark.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ['Scope', 'global_scope', 'scope_guard', 'handed_out',
           'mark_handed_out']

_HANDED_OUT = '_paddle_handed_out'


def mark_handed_out(value):
    """Mark a tensor as held outside the executor; returns it."""
    if isinstance(value, torch.Tensor):
        setattr(value, _HANDED_OUT, True)
    return value


def handed_out(value):
    """Whether ``value`` was marked by :func:`mark_handed_out`."""
    return getattr(value, _HANDED_OUT, False)


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self._parent = parent

    def new_scope(self):
        return Scope(parent=self)

    def var(self, name):
        """Find or declare ``name``; returns its value (None if unset),
        marked as handed out."""
        if name not in self._vars and (self._parent is None
                                       or self._parent._find(name) is None):
            self._vars[name] = None
        return self.find(name)

    def find(self, name):
        """The value of ``name`` here or in a parent (None if unset),
        marked as handed out."""
        return mark_handed_out(self._find(name))

    def _find(self, name):
        """:meth:`find` without the mark, for the executor."""
        if name in self._vars:
            return self._vars[name]
        if self._parent is not None:
            return self._parent._find(name)
        return None

    def has(self, name):
        return name in self._vars or (self._parent is not None
                                      and self._parent.has(name))

    def set(self, name, value):
        """Write where ``name`` lives, else here; ``value`` is marked as
        handed out (the caller holds it)."""
        self._put(name, mark_handed_out(value))

    def _put(self, name, value):
        """:meth:`set` without the mark, for the executor."""
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s._parent
        self._vars[name] = value

    def erase(self, name):
        self._vars.pop(name, None)

    def local_names(self):
        return list(self._vars)


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old
