"""The deprecated-API decorator (counterpart of
paddle_tpu/annotations.py): each call prints a notice to stderr, and the
notice is appended to the docstring."""
from __future__ import annotations

import functools
import sys

__all__ = ['deprecated']


def deprecated(since, instead, extra_message=''):
    def decorator(func):
        err_msg = (f'API {func.__name__} is deprecated since {since}. '
                   f'Please use {instead} instead.')
        if extra_message:
            err_msg += '\n' + extra_message

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            print(err_msg, file=sys.stderr)
            return func(*args, **kwargs)

        wrapper.__doc__ = (wrapper.__doc__ or '') + '\n    ' + err_msg
        return wrapper

    return decorator
