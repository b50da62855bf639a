"""Op-frequency statistics (counterpart of
paddle_tpu/contrib/op_frequence.py)."""
from collections import OrderedDict

from ..framework import Program

__all__ = ['op_freq_statistic']


def op_freq_statistic(program):
    """Count single-op and adjacent-op-pair frequencies over the program.
    Returns (uni_op_freq, adj_2_op_freq) OrderedDicts sorted by count."""
    if not isinstance(program, Program):
        raise ValueError(f'{program} is not a Program instance')
    uni, adj = {}, {}
    for block in program.blocks:
        prev = None
        for op in block.ops:
            uni[op.type] = uni.get(op.type, 0) + 1
            if prev is not None:
                key = prev + '->' + op.type
                adj[key] = adj.get(key, 0) + 1
            prev = op.type
    uni_sorted = OrderedDict(
        sorted(uni.items(), key=lambda x: x[1], reverse=True))
    adj_sorted = OrderedDict(
        sorted(adj.items(), key=lambda x: x[1], reverse=True))
    return uni_sorted, adj_sorted
