"""Default-scope helpers (counterpart of
paddle_tpu/default_scope_funcs.py): a stack of scopes for each thread over
``core.Scope``; ``scoped_function`` runs a callable in a fresh child scope
and drops the scope afterwards."""
import threading

from .core.scope import global_scope

__all__ = ['get_cur_scope', 'enter_local_scope', 'leave_local_scope',
           'var', 'find_var', 'scoped_function']

_local = threading.local()


def _stack():
    if not getattr(_local, 'stack', None):
        _local.stack = [global_scope()]
    return _local.stack


def get_cur_scope():
    """The innermost scope of the current thread."""
    return _stack()[-1]


def enter_local_scope():
    """Push a child of the current scope."""
    _stack().append(get_cur_scope().new_scope())


def leave_local_scope():
    """Pop the innermost scope; the global scope stays."""
    stack = _stack()
    if len(stack) <= 1:
        raise RuntimeError('cannot leave the global scope')
    stack.pop()


def var(name):
    """Find or declare ``name`` in the current scope."""
    return get_cur_scope().var(name)


def find_var(name):
    """``name``'s value in the current scope or a parent."""
    return get_cur_scope().find(name)


def scoped_function(func):
    """``func()`` inside a fresh local scope."""
    enter_local_scope()
    try:
        return func()
    finally:
        leave_local_scope()
