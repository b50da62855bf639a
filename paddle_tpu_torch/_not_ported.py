"""Stand-ins for the JAX package's public names the port does not run yet.

Each names its ROADMAP item: a function raises ``NotImplementedError`` when
called, a class when constructed (``isinstance`` against it is simply
False), and a module on any public attribute. They are objects, not a
module ``__getattr__``, so ``hasattr`` on a name the JAX package does not
have stays False."""
from __future__ import annotations

import types

__all__ = ['ITEMS', 'message', 'stand_in', 'stand_in_class',
           'stand_in_module']

ITEMS = {
    'A.9': 'distributed training on torch.distributed',
    'A.10': 'LoD tensors, the model zoo and the op long tail',
    'A.11': ('the runtime services: readers, datasets, the profiler, '
             'resilience and the rest of observability'),
}


def message(what, item):
    return f'{what} is not ported yet: ROADMAP {item}, {ITEMS[item]}'


def stand_in(qualname, item):
    """A function that raises naming ``item``."""
    def fn(*args, **kwargs):
        raise NotImplementedError(message(qualname, item))
    fn.__name__ = qualname.rsplit('.', 1)[-1]
    fn.__qualname__ = qualname
    fn.__doc__ = f'Not ported yet (ROADMAP {item}): raises.'
    return fn


def stand_in_class(qualname, item):
    """A class whose construction raises naming ``item``."""
    def __new__(cls, *args, **kwargs):
        raise NotImplementedError(message(qualname, item))
    name = qualname.rsplit('.', 1)[-1]
    return type(name, (), {
        '__new__': __new__, '__qualname__': qualname,
        '__doc__': f'Not ported yet (ROADMAP {item}): raises.',
        '__module__': 'paddle_tpu_torch'})


def stand_in_module(qualname, item):
    """A module whose public attributes raise naming ``item``."""
    mod = types.ModuleType(qualname,
                           f'{qualname}: not ported yet (ROADMAP {item})')

    def getattr_(attr):
        if attr.startswith('_'):
            raise AttributeError(attr)
        raise NotImplementedError(message(f'{qualname}.{attr}', item))
    mod.__getattr__ = getattr_
    return mod
