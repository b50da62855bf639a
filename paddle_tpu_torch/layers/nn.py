"""Neural-network layers of the static graph (counterpart of
paddle_tpu/layers/nn.py): ``fc``, ``embedding``, ``conv2d``, ``pool2d``,
``batch_norm``, ``layer_norm``, ``softmax``, ``matmul``, ``mul``,
``dropout``, ``topk``, ``one_hot``, ``split``, ``stack``, ``unstack``,
``sum``, ``autoincreased_step_counter``, ``conv3d``, ``conv2d_transpose``,
``conv3d_transpose``, ``group_norm``, ``spectral_norm``, ``prelu``,
``nce``, ``bilinear_tensor_product``, and the generated one-op layers of
the JAX package's list (every activation among them). A generated layer
whose op the port has not registered yet raises ``NotImplementedError``
when called (ROADMAP A.10), never at import."""
from __future__ import annotations

import math

from ..core import unique_name
from ..initializer import (ConstantInitializer, NormalInitializer,
                           XavierInitializer)
from ..layer_helper import LayerHelper
from ..ops.extra_ops import check_nce_defaults
from ..ops.registry import has_op
from .common import apply_op_layer, generate_layer_fn

__all__ = ['fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm', 'layer_norm',
           'dropout', 'softmax', 'matmul', 'mul', 'topk', 'one_hot',
           'autoincreased_step_counter', 'split', 'stack', 'sum', 'conv3d',
           'conv2d_transpose', 'conv3d_transpose', 'group_norm',
           'spectral_norm', 'prelu', 'nce', 'bilinear_tensor_product']


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """``mul`` of each input with its weight (in, out), summed, plus the
    bias, then ``act``."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper('fc', param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    mul_results = []
    for x in inputs:
        in_feat = math.prod(x.shape[num_flatten_dims:])
        w = helper.create_parameter(helper.param_attr, [in_feat, size],
                                    x.dtype)
        mul_results.append(apply_op_layer(
            'mul', {'x': x, 'y': w},
            {'x_num_col_dims': num_flatten_dims, 'y_num_col_dims': 1}))
    out = (mul_results[0] if len(mul_results) == 1
           else apply_op_layer('sum', {'xs': mul_results}))
    b = helper.create_parameter(helper.bias_attr, [size], 'float32',
                                is_bias=True)
    if b is not None:
        out = apply_op_layer('elementwise_add', {'x': out, 'y': b},
                             {'axis': num_flatten_dims})
    if act:
        out = apply_op_layer(act, {'x': out})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """A ``lookup_table`` op over a (vocab, dim) = ``size`` weight (Xavier
    by default); a negative ``padding_idx`` counts from the end.
    ``is_sparse=True`` (rows-only gradients) is not ported and raises."""
    if is_sparse:
        raise NotImplementedError('embedding(is_sparse=True): rows-only '
                                  'gradients are not ported yet (ROADMAP '
                                  'A.10)')
    helper = LayerHelper('embedding', param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, list(size), dtype,
                                default_initializer=XavierInitializer())
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    return apply_op_layer('lookup_table', {'w': w, 'ids': input},
                          {'padding_idx': pad, 'is_sparse': is_sparse,
                           'is_distributed': is_distributed})


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format='NCHW'):
    """A conv2d op with an OIHW weight drawn from
    Normal(0, sqrt(2 / (fh * fw * C))), plus the bias and ``act``
    (``use_cudnn`` is accepted; torch chooses)."""
    helper = LayerHelper('conv2d', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c_in = input.shape[1] if data_format == 'NCHW' else input.shape[-1]
    fs = (filter_size if isinstance(filter_size, (list, tuple))
          else (filter_size, filter_size))
    std = math.sqrt(2.0 / (fs[0] * fs[1] * c_in))
    w = helper.create_parameter(
        helper.param_attr, [num_filters, c_in // groups, fs[0], fs[1]],
        input.dtype, default_initializer=NormalInitializer(0.0, std))
    out = apply_op_layer('conv2d', {'x': input, 'weight': w},
                         {'stride': stride, 'padding': padding,
                          'dilation': dilation, 'groups': groups,
                          'data_format': data_format})
    b = helper.create_parameter(helper.bias_attr, [num_filters], 'float32',
                                is_bias=True)
    if b is not None:
        axis = 1 if data_format == 'NCHW' else 3
        out = apply_op_layer('elementwise_add', {'x': out, 'y': b},
                             {'axis': axis})
    if act:
        out = apply_op_layer(act, {'x': out})
    return out


def _conv_layer(op_type, input, num_filters, wshape, attrs, param_attr,
                bias_attr, act, name):
    """A conv-family op over a new ``wshape`` weight (Xavier, the
    input's type), then an f32 bias on dim 1 and ``act``, as the JAX
    package builds conv3d and the transposed convs."""
    helper = LayerHelper(op_type, param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    w = helper.create_parameter(helper.param_attr, wshape, input.dtype)
    out = apply_op_layer(op_type, {'x': input, 'weight': w}, attrs)
    b = helper.create_parameter(helper.bias_attr, [num_filters], 'float32',
                                is_bias=True)
    if b is not None:
        out = apply_op_layer('elementwise_add', {'x': out, 'y': b},
                             {'axis': 1})
    if act:
        out = apply_op_layer(act, {'x': out})
    return out


def _fs(filter_size, n):
    return (list(filter_size) if isinstance(filter_size, (list, tuple))
            else [filter_size] * n)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format='NCDHW'):
    """A conv3d op over an OIDHW weight (NCDHW; ``data_format`` is not
    passed on, as in the JAX package), plus the bias and ``act``."""
    return _conv_layer(
        'conv3d', input, num_filters,
        [num_filters, input.shape[1] // groups, *_fs(filter_size, 3)],
        {'stride': stride, 'padding': padding, 'dilation': dilation,
         'groups': groups}, param_attr, bias_attr, act, name)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """A conv2d_transpose op over an IOHW weight (C_in, O/groups, fh, fw),
    plus the bias and ``act``. ``filter_size`` is required (the JAX package
    raises without it) and ``output_size`` is not passed on, as there."""
    if filter_size is None:
        raise ValueError('filter_size required (output_size-only form: '
                         'provide filter_size for the TPU build)')
    return _conv_layer(
        'conv2d_transpose', input, num_filters,
        [input.shape[1], num_filters // groups, *_fs(filter_size, 2)],
        {'stride': stride, 'padding': padding, 'dilation': dilation,
         'groups': groups}, param_attr, bias_attr, act, name)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    """A conv3d_transpose op over an IODHW weight, plus the bias and
    ``act``."""
    return _conv_layer(
        'conv3d_transpose', input, num_filters,
        [input.shape[1], num_filters // groups, *_fs(filter_size, 3)],
        {'stride': stride, 'padding': padding, 'dilation': dilation,
         'groups': groups}, param_attr, bias_attr, act, name)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout='NCHW', name=None):
    """A group_norm op with its scale (ones) and bias (zeros) a channel,
    then ``act``; an NHWC layout raises when the op runs (ROADMAP C.4 item
    17)."""
    helper = LayerHelper('group_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1]
    s = helper.create_parameter(helper.param_attr, [c], input.dtype,
                                default_initializer=ConstantInitializer(1.0))
    b = helper.create_parameter(helper.bias_attr, [c], input.dtype,
                                is_bias=True)
    out = apply_op_layer('group_norm', {'x': input, 'scale': s, 'bias': b},
                         {'groups': groups, 'epsilon': epsilon,
                          'data_layout': data_layout})
    if act:
        out = apply_op_layer(act, {'x': out})
    return out


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """A spectral_norm op on ``weight``; the power iteration restarts
    from ones every run, as in the JAX package (ROADMAP C.4 item 16)."""
    return apply_op_layer('spectral_norm', {'w': weight},
                          {'dim': dim, 'power_iters': power_iters,
                           'eps': eps}, name=name)


def prelu(x, mode, param_attr=None, name=None):
    """A prelu op with its alpha (0.25): one value, one a channel, or one
    a sample's element (flat)."""
    helper = LayerHelper('prelu', param_attr=param_attr, name=name)
    if mode == 'all':
        shape = [1]
    elif mode == 'channel':
        shape = [x.shape[1]]
    else:
        shape = [math.prod(x.shape[1:])]
    alpha = helper.create_parameter(
        helper.param_attr, shape, x.dtype,
        default_initializer=ConstantInitializer(0.25))
    return apply_op_layer('prelu', {'x': x, 'alpha': alpha}, {'mode': mode})


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler='uniform',
        custom_dist=None, seed=0, is_sparse=False):
    """An nce op over a (classes, dim) weight and a (classes,) bias, 10
    negatives unless ``num_neg_samples`` says otherwise. The JAX package
    never reads ``sample_weight``, ``sampler``, ``custom_dist``, ``seed`` or
    ``is_sparse``; any value but the default raises (ROADMAP C.4 item
    14)."""
    check_nce_defaults(sample_weight=sample_weight, sampler=sampler,
                       custom_dist=custom_dist, seed=seed,
                       is_sparse=is_sparse)
    helper = LayerHelper('nce', param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(helper.param_attr, [num_total_classes, dim],
                                input.dtype)
    b = helper.create_parameter(helper.bias_attr, [num_total_classes],
                                input.dtype, is_bias=True)
    return apply_op_layer('nce', {'x': input, 'label': label, 'weight': w,
                                  'bias': b},
                          {'num_total_classes': num_total_classes,
                           'num_neg_samples': num_neg_samples or 10})


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None,
                            bias_attr=None):
    """A bilinear_tensor_product op over a (size, x dim, y dim) weight and a
    (size,) bias, then ``act``."""
    helper = LayerHelper('bilinear_tensor_product', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(helper.param_attr,
                                [size, x.shape[-1], y.shape[-1]], x.dtype)
    b = helper.create_parameter(helper.bias_attr, [size], x.dtype,
                                is_bias=True)
    out = apply_op_layer('bilinear_tensor_product',
                         {'x': x, 'y': y, 'weight': w, 'bias': b})
    if act:
        out = apply_op_layer(act, {'x': out})
    return out


def pool2d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format='NCHW'):
    return apply_op_layer('pool2d', {'x': input},
                          {'pool_size': pool_size, 'pool_type': pool_type,
                           'pool_stride': pool_stride,
                           'pool_padding': pool_padding,
                           'global_pooling': global_pooling,
                           'ceil_mode': ceil_mode, 'exclusive': exclusive,
                           'data_format': data_format}, name=name)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False, sync_stats=False):
    """A batch_norm op with its scale (ones) and bias (zeros) parameters
    and its running mean (zeros) and variance (ones), persistables that the
    op's ``MeanOut``/``VarianceOut`` write back."""
    helper = LayerHelper('batch_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1] if data_layout == 'NCHW' else input.shape[-1]
    dtype = 'float32'
    scale = helper.create_parameter(
        helper.param_attr, [c], dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, [c], dtype,
                                   is_bias=True)
    mean_name = moving_mean_name or unique_name.generate(
        helper.name + '.mean')
    var_name = moving_variance_name or unique_name.generate(
        helper.name + '.variance')

    def stat_var(nm, init_val):
        v = helper.main_program.global_block().create_var(
            name=nm, shape=[c], dtype=dtype, persistable=True,
            stop_gradient=True)
        sb = helper.startup_program.global_block()
        sv = sb.create_var(name=nm, shape=[c], dtype=dtype,
                           persistable=True, stop_gradient=True)
        ConstantInitializer(init_val)(sv, sb)
        return v

    mean = stat_var(mean_name, 0.0)
    variance = stat_var(var_name, 1.0)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='batch_norm',
        inputs={'x': input.name, 'scale': scale.name, 'bias': bias.name,
                'mean': mean.name, 'variance': variance.name},
        outputs={'Y': out.name, 'MeanOut': mean.name,
                 'VarianceOut': var_name},
        attrs={'momentum': momentum, 'epsilon': epsilon, 'is_test': is_test,
               'use_global_stats': use_global_stats,
               'data_layout': data_layout, 'sync_stats': sync_stats})
    if act:
        out = apply_op_layer(act, {'x': out})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """A layer_norm op over the dims from ``begin_norm_axis`` on, with its
    scale (ones) and shift (zeros) parameters of their flattened size."""
    helper = LayerHelper('layer_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    nshape = [math.prod(input.shape[begin_norm_axis:])]
    s = helper.create_parameter(
        helper.param_attr, nshape, input.dtype,
        default_initializer=ConstantInitializer(1.0)) if scale else None
    b = helper.create_parameter(helper.bias_attr, nshape, input.dtype,
                                is_bias=True) if shift else None
    out = apply_op_layer('layer_norm', {'x': input, 'scale': s, 'bias': b},
                         {'begin_norm_axis': begin_norm_axis,
                          'epsilon': epsilon})
    if act:
        out = apply_op_layer(act, {'x': out})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation='downgrade_in_infer'):
    return apply_op_layer('dropout', {'x': x},
                          {'dropout_prob': dropout_prob, 'is_test': is_test,
                           'dropout_implementation': dropout_implementation},
                          name=name)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    return apply_op_layer('softmax', {'x': input}, {'axis': axis}, name=name)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    return apply_op_layer('matmul', {'x': x, 'y': y},
                          {'transpose_x': transpose_x,
                           'transpose_y': transpose_y, 'alpha': alpha},
                          name=name)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return apply_op_layer('mul', {'x': x, 'y': y},
                          {'x_num_col_dims': x_num_col_dims,
                           'y_num_col_dims': y_num_col_dims}, name=name)


def topk(input, k, name=None):
    """(values, int64 indices) of the ``k`` largest of each last-dim
    row."""
    return apply_op_layer('top_k', {'x': input}, {'k': k}, name=name)


def one_hot(input, depth, allow_out_of_range=False):
    return apply_op_layer('one_hot', {'x': input},
                          {'depth': depth,
                           'allow_out_of_range': allow_out_of_range})


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 (1,) counter (``@STEP_COUNTER@`` by default)
    that starts at ``begin - step`` and that an ``increment`` op, first in
    the main program, moves by ``step`` every run."""
    helper = LayerHelper('global_step_counter')
    name = counter_name or '@STEP_COUNTER@'
    block = helper.main_program.global_block()
    if block.has_var(name):
        return block.var(name)
    counter = block.create_var(name=name, shape=[1], dtype='int64',
                               persistable=True, stop_gradient=True)
    sb = helper.startup_program.global_block()
    sv = sb.create_var(name=name, shape=[1], dtype='int64', persistable=True,
                       stop_gradient=True)
    ConstantInitializer(begin - step)(sv, sb)
    block.prepend_op(type='increment', inputs={'x': name},
                     outputs={'Out': name}, attrs={'value': float(step)})
    return counter


def split(input, num_or_sections, dim=-1, name=None):
    """The parts of ``input`` along ``dim``, a list of Variables."""
    n = (num_or_sections if isinstance(num_or_sections, int)
         else len(num_or_sections))
    out = apply_op_layer('split', {'x': input},
                         {'num_or_sections': num_or_sections, 'dim': dim},
                         name=name, n_outputs={'Out': n})
    return out if isinstance(out, list) else [out]


def stack(x, axis=0):
    return apply_op_layer('stack', {'xs': list(x)}, {'axis': axis})


def sum(x):
    xs = x if isinstance(x, (list, tuple)) else [x]
    return apply_op_layer('sum', {'xs': list(xs)})


def _not_ported(op_type, fname):
    def layer(*args, **kwargs):
        raise NotImplementedError(
            f'layers.{fname}: the op {op_type!r} is not ported yet '
            f'(ROADMAP A.10)')
    layer.__name__ = fname
    layer.__doc__ = f'Layer of the op `{op_type}`: not ported yet.'
    return layer


# the parameters each generated layer that runs takes by position after its
# input slots, in Paddle 1.7's documented order, up to the first one the
# port's op does not take (``act``, ``out``, ...)
_UNARY = ('name',)
_REDUCE = ('dim', 'keep_dim', 'name')
_POSITIONAL = {
    **dict.fromkeys(['sigmoid', 'exp', 'tanh', 'sqrt', 'ceil', 'floor',
                     'cos', 'square', 'relu', 'log', 'sign', 'mean',
                     'logsigmoid', 'atan', 'tanh_shrink', 'rsqrt', 'abs',
                     'sin', 'acos', 'asin', 'cosh', 'sinh', 'round',
                     'reciprocal', 'softplus', 'softsign'], _UNARY),
    'gelu': (), 'erf': (), 'softshrink': ('lambda_',),
    'hard_shrink': ('threshold',), 'thresholded_relu': ('threshold',),
    'relu6': ('threshold', 'name'), 'leaky_relu': ('alpha', 'name'),
    'elu': ('alpha', 'name'), 'selu': ('scale', 'alpha', 'name'),
    'brelu': ('t_min', 't_max', 'name'), 'soft_relu': ('threshold', 'name'),
    'stanh': ('scale_a', 'scale_b', 'name'),
    'hard_sigmoid': ('slope', 'offset', 'name'),
    'hard_swish': ('threshold', 'scale', 'offset', 'name'),
    'swish': ('beta', 'name'), 'maxout': ('groups', 'name', 'axis'),
    'temporal_shift': ('seg_num', 'shift_ratio', 'name'),
    **dict.fromkeys(['reduce_sum', 'reduce_mean', 'reduce_max',
                     'reduce_min'], _REDUCE),
    **dict.fromkeys(['elementwise_add', 'elementwise_sub',
                     'elementwise_mul', 'elementwise_div',
                     'elementwise_max', 'elementwise_min',
                     'elementwise_pow', 'elementwise_mod',
                     'elementwise_floordiv'], ('axis',)),
    'log_softmax': ('axis', 'name'), 'pow': ('factor', 'name'),
    'scale': ('scale', 'bias', 'bias_after_scale'),
    'clip': ('min', 'max', 'name'), 'clip_by_norm': ('max_norm', 'name'),
    'transpose': ('perm', 'name'), 'squeeze': ('axes', 'name'),
    'unsqueeze': ('axes', 'name'), 'reshape': ('shape',),
    'gather': ('overwrite',), 'expand': ('expand_times', 'name'),
    'slice': ('axes', 'starts', 'ends'), 'argmax': ('axis',),
}


def _gen(op_type, *, fname=None):
    fname = fname or op_type
    fn = (generate_layer_fn(op_type, attr_order=_POSITIONAL.get(fname, ()))
          if has_op(op_type) else _not_ported(op_type, fname))
    fn.__name__ = fname
    globals()[fname] = fn
    __all__.append(fname)
    return fn


# the JAX package's generated layers, in its order
for _op in ['sigmoid', 'logsigmoid', 'exp', 'tanh', 'atan', 'tanh_shrink',
            'sqrt', 'rsqrt', 'abs', 'ceil', 'floor', 'cos', 'sin', 'acos',
            'asin', 'cosh', 'sinh', 'round', 'reciprocal', 'square',
            'softplus', 'softsign', 'softshrink', 'hard_shrink',
            'thresholded_relu', 'log_softmax',
            'relu', 'relu6', 'leaky_relu', 'elu', 'selu', 'brelu',
            'soft_relu', 'stanh', 'hard_sigmoid', 'hard_swish', 'swish',
            'maxout', 'pow', 'gelu', 'erf', 'log', 'sign', 'mean',
            'reduce_sum', 'reduce_mean', 'reduce_max', 'reduce_min',
            'reduce_prod', 'reduce_all', 'reduce_any', 'logsumexp',
            'elementwise_add', 'elementwise_sub', 'elementwise_mul',
            'elementwise_div', 'elementwise_max', 'elementwise_min',
            'elementwise_pow', 'elementwise_mod', 'elementwise_floordiv',
            'scale', 'clip', 'clip_by_norm', 'cos_sim',
            'transpose', 'squeeze', 'unsqueeze', 'reshape', 'flatten',
            'gather', 'gather_nd', 'scatter', 'scatter_nd_add',
            'expand', 'expand_as', 'pad', 'pad2d', 'pad_constant_like',
            'label_smooth', 'shard_index', 'where',
            'space_to_depth', 'shuffle_channel', 'temporal_shift',
            'grid_sampler', 'affine_channel', 'pixel_shuffle', 'unfold',
            'add_position_encoding', 'log_loss', 'unstack',
            'uniform_random', 'gaussian_random',
            'uniform_random_batch_size_like',
            'gaussian_random_batch_size_like', 'sampling_id', 'random_crop',
            'logical_and', 'logical_or', 'logical_xor', 'logical_not',
            'has_inf', 'has_nan', 'isfinite', 'mean_iou', 'cumsum']:
    _gen(_op)

_gen('slice')
_gen('strided_slice')
_gen('fsp', fname='fsp_matrix')
_gen('arg_min', fname='argmin')
_gen('arg_max', fname='argmax')
_gen('argsort')


def unstack(x, axis=0, num=None):
    """The slices of ``x`` along ``axis``, a list of Variables."""
    n = num if num is not None else x.shape[axis]
    out = apply_op_layer('unstack', {'x': x}, {'axis': axis, 'num': num},
                         n_outputs={'Y': n})
    return out if isinstance(out, list) else [out]
