"""Structure utilities (counterpart of paddle_tpu/layers/utils.py): nest
flatten, pack and map."""

__all__ = ['convert_to_list', 'is_sequence', 'flatten', 'map_structure',
           'pack_sequence_as', 'assert_same_structure']


def convert_to_list(value, n, name, dtype=int):
    """ref utils.py:convert_to_list — scalar → [v]*n, or validate a list
    of length n."""
    if isinstance(value, dtype):
        return [value] * n
    try:
        value_list = list(value)
    except TypeError:
        raise ValueError(
            f'The {name} argument must be a {dtype} or list of {n} '
            f'{dtype}s, got {value}')
    if len(value_list) != n:
        raise ValueError(
            f'The {name} argument must be a {dtype} or list of {n} '
            f'{dtype}s, got {value}')
    for v in value_list:
        if not isinstance(v, dtype):
            raise ValueError(
                f'The {name} argument must contain {dtype}s, got {v}')
    return value_list


def is_sequence(seq):
    """ref utils.py:is_sequence — list/tuple/dict but not str."""
    return isinstance(seq, (list, tuple, dict)) \
        and not isinstance(seq, str)


def flatten(nest):
    """ref utils.py:flatten — depth-first leaves of a nested structure."""
    if isinstance(nest, dict):
        out = []
        for k in sorted(nest):
            out.extend(flatten(nest[k]))
        return out
    if isinstance(nest, (list, tuple)):
        out = []
        for x in nest:
            out.extend(flatten(x))
        return out
    return [nest]


def pack_sequence_as(structure, flat_sequence):
    """ref utils.py:pack_sequence_as — rebuild `structure`'s shape from a
    flat leaf list."""
    flat = list(flat_sequence)
    want = len(flatten(structure))
    if want != len(flat):
        raise ValueError(
            f'Could not pack sequence: structure has {want} leaves but '
            f'flat_sequence has {len(flat)} elements')

    def build(s):
        if isinstance(s, dict):
            return {k: build(s[k]) for k in sorted(s)}
        if isinstance(s, tuple) and hasattr(s, '_fields'):
            return type(s)(*[build(e) for e in s])
        if isinstance(s, (list, tuple)):
            return type(s)(build(e) for e in s)
        return flat.pop(0)
    return build(structure)


def map_structure(func, *structures):
    """ref utils.py:map_structure — apply func leafwise, preserving
    structure."""
    s0 = structures[0]
    if isinstance(s0, dict):
        return {k: map_structure(func, *[s[k] for s in structures])
                for k in sorted(s0)}
    if isinstance(s0, tuple) and hasattr(s0, '_fields'):
        return type(s0)(*[map_structure(func, *elems)
                          for elems in zip(*structures)])
    if isinstance(s0, (list, tuple)):
        return type(s0)(map_structure(func, *elems)
                        for elems in zip(*structures))
    return func(*structures)


def assert_same_structure(nest1, nest2, check_types=True):
    """ref utils.py:assert_same_structure."""
    f1, f2 = flatten(nest1), flatten(nest2)
    if len(f1) != len(f2):
        raise ValueError(
            f"The two structures don't have the same number of elements: "
            f'{len(f1)} vs {len(f2)}')

    def walk(a, b):
        sa, sb = is_sequence(a), is_sequence(b)
        if sa != sb:
            raise ValueError(
                "The two structures don't have the same nested structure")
        if not sa:
            return
        if check_types and type(a) is not type(b):
            raise TypeError(
                f"The two structures don't have the same sequence type: "
                f'{type(a)} vs {type(b)}')
        if isinstance(a, dict):
            if sorted(a) != sorted(b):
                raise ValueError(
                    "The two dictionaries don't have the same keys")
            for k in a:
                walk(a[k], b[k])
        else:
            if len(a) != len(b):
                raise ValueError(
                    "The two structures don't have the same length")
            for x, y in zip(a, b):
                walk(x, y)
    walk(nest1, nest2)
