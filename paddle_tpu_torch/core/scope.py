"""Scope: the runtime store of persistable values (counterpart of
paddle_tpu/core/scope.py), a flat name -> torch tensor map with an optional
parent. The executor reads a program's persistables from it and writes
them back after each run."""
from __future__ import annotations

import contextlib

__all__ = ['Scope', 'global_scope', 'scope_guard']


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self._parent = parent

    def new_scope(self):
        return Scope(parent=self)

    def var(self, name):
        """Find or declare ``name``; returns its value (None if unset)."""
        if name not in self._vars and (self._parent is None
                                       or self._parent.find(name) is None):
            self._vars[name] = None
        return self.find(name)

    def find(self, name):
        if name in self._vars:
            return self._vars[name]
        if self._parent is not None:
            return self._parent.find(name)
        return None

    def has(self, name):
        return name in self._vars or (self._parent is not None
                                      and self._parent.has(name))

    def set(self, name, value):
        """Write where ``name`` lives, else here."""
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
