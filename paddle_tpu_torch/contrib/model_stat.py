"""A model's parameter and FLOP table (counterpart of
paddle_tpu/contrib/model_stat.py): counts the op families Fluid's
``summary`` counts (conv2d, mul and matmul, pool2d, the norms, the
activations, the elementwise ops) over the op list; prints the table and
returns (rows, total_params, total_flops)."""
from collections import OrderedDict

import numpy as np

__all__ = ['summary']

_ACTS = {'relu', 'sigmoid', 'tanh', 'relu6', 'leaky_relu', 'prelu',
         'softmax', 'gelu', 'swish', 'hard_swish'}


def _var_shape(block, name):
    v = block.vars.get(name)
    return list(v.shape) if v is not None and v.shape else None


def _count(block, op):
    """(input_shape, out_shape, params, flops) or None to skip."""
    ins = [n for n in op.input_names()]
    outs = [n for n in op.output_names()]
    if not ins or not outs:
        return None
    out_shape = _var_shape(block, outs[0])
    if op.type == 'conv2d' or op.type == 'depthwise_conv2d':
        x = op.inputs.get('x', [None])[0]
        w = (op.inputs.get('weight') or op.inputs.get('w') or [None])[0]
        in_shape = _var_shape(block, x)
        w_shape = _var_shape(block, w)
        if not (in_shape and w_shape and out_shape):
            return None
        params = int(np.prod(w_shape))
        k_elems = int(np.prod(w_shape[1:]))
        flops = int(np.prod(out_shape[1:])) * k_elems * 2
        return in_shape, out_shape, params, flops
    if op.type in ('mul', 'matmul'):
        xs = _var_shape(block, ins[0])
        ys = _var_shape(block, ins[1]) if len(ins) > 1 else None
        if not (xs and ys and out_shape):
            return None
        params = int(np.prod(ys)) if len(ys) == 2 else 0
        flops = 2 * int(np.prod(out_shape[1:] or out_shape)) * ys[0]
        return xs, out_shape, params, flops
    if op.type in ('pool2d', 'pool3d'):
        in_shape = _var_shape(block, ins[0])
        if not (in_shape and out_shape):
            return None
        k = op.attrs.get('ksize', [2, 2])
        flops = int(np.prod(out_shape[1:])) * int(np.prod(k))
        return in_shape, out_shape, 0, flops
    if op.type in ('batch_norm', 'layer_norm', 'instance_norm',
                   'group_norm'):
        in_shape = _var_shape(block, ins[0])
        if not (in_shape and out_shape):
            return None
        ch = in_shape[1] if len(in_shape) > 1 else in_shape[0]
        return in_shape, out_shape, 2 * abs(ch), \
            int(np.prod(out_shape[1:] or out_shape))
    if op.type in _ACTS or op.type.startswith('elementwise_'):
        in_shape = _var_shape(block, ins[0])
        if not (in_shape and out_shape):
            return None
        return in_shape, out_shape, 0, \
            int(np.prod(out_shape[1:] or out_shape))
    return None


def summary(main_prog):
    """Print the table of ``main_prog``'s ops and their totals; returns
    (rows, total_params, total_flops)."""
    rows, total_params, total_flops = [], 0, 0
    for block in main_prog.blocks:
        for op in block.ops:
            res = _count(block, op)
            if res is None:
                continue
            in_shape, out_shape, params, flops = res
            info = OrderedDict(type=op.type, input_shape=in_shape[1:],
                               out_shape=out_shape[1:], PARAMs=params,
                               FLOPs=flops)
            rows.append(info)
            total_params += params
            total_flops += flops
    header = f"| {'No.':>4} | {'TYPE':>12} | {'INPUT':>18} | " \
             f"{'OUTPUT':>18} | {'PARAMs':>9} | {'FLOPs':>12} |"
    sep = '+' + '-' * (len(header) - 2) + '+'
    print(sep)
    print(header)
    print(sep)
    for i, r in enumerate(rows):
        ins, outs = str(tuple(r['input_shape'])), str(tuple(r['out_shape']))
        print(f"| {i:>4} | {r['type']:>12} | {ins:>18} | {outs:>18} | "
              f"{r['PARAMs']:>9} | {r['FLOPs']:>12} |")
    print(sep)
    print(f'Total PARAMs: {total_params}({total_params / 1e9:.4f}G)')
    print(f'Total FLOPs: {total_flops}({total_flops / 1e9:.2f}G)')
    return rows, total_params, total_flops
