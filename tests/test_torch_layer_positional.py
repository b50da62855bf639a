"""The port's generated layers take their attributes by position (ROADMAP
C.12), on the CPU.

Each generated layer of ``paddle_tpu_torch/layers/nn.py`` whose op the
port runs is called with its attributes by position, after its input
slots, in Paddle 1.7's documented order (``reshape(x, shape)``,
``transpose(x, perm)``, ``reduce_sum(input, dim, keep_dim)``,
``scale(x, scale, bias, bias_after_scale)``, ``clip(x, min, max)``, the
``axis`` of ``elementwise_*``, ``leaky_relu(x, alpha)``,
``maxout(x, groups, name, axis)``, ``temporal_shift(x, seg_num,
shift_ratio)``, ...), in a static program and under a
``dygraph.guard``; the JAX package's layer is called on the same numpy
inputs with the attributes as keywords, in a static program (its
generated layers drop positional attributes, ROADMAP C.12). Output shapes
are equal and values within 1e-6. One positional argument past what a
layer takes raises ``TypeError`` naming the layer, and so does one given
twice. The comparisons of ``layers/control_flow.py`` take ``cond`` and
``name`` by position, and run under a guard.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.layers import nn as port_nn
from paddle_tpu_torch.ops.registry import has_op
from torch_jax_seed import jax_seed_pinned  # noqa: F401

R = np.random.RandomState(0)
X = R.randn(3, 4).astype(np.float32)
POS = (R.rand(3, 4) + 0.5).astype(np.float32)
Y3 = (R.rand(3) + 0.5).astype(np.float32)
BX = R.rand(3, 4) > 0.5
BY = R.rand(3, 4) > 0.5
UNARY = {'sigmoid': X, 'exp': X, 'tanh': X, 'sqrt': POS, 'ceil': X,
         'floor': X, 'cos': X, 'square': X, 'relu': X, 'log': POS,
         'sign': X, 'mean': X}
# the activations registered since A.4c
R1 = np.random.RandomState(1)
HALF = R1.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
CLIPS = (R1.rand(4, 4, 2, 2) - 0.5).astype(np.float32)
UNARY.update({name: X for name in (
    'logsigmoid', 'atan', 'tanh_shrink', 'abs', 'sin', 'cosh', 'sinh',
    'round', 'softplus', 'softsign')})
UNARY.update({'rsqrt': POS, 'reciprocal': POS, 'acos': HALF,
              'asin': HALF})

# layer: (inputs, attributes in positional order as (keyword, value))
CASES = {name: ((x,), (('name', f'{name}_out'),))
         for name, x in UNARY.items()}
CASES.update({
    'log_softmax': ((X,), (('axis', 0),)),
    'pow': ((POS,), (('factor', 3.0),)),
    'scale': ((X,), (('scale', 2.0), ('bias', 1.0),
                     ('bias_after_scale', False))),
    'clip': ((X,), (('min', -0.5), ('max', 0.5))),
    'clip_by_norm': ((X,), (('max_norm', 1.0),)),
    'transpose': ((X,), (('perm', [1, 0]),)),
    'squeeze': ((X.reshape(3, 1, 4),), (('axes', [1]),)),
    'unsqueeze': ((X,), (('axes', [1]),)),
    'reshape': ((X,), (('shape', [4, 3]),)),
    'gather': ((X, np.array([2, 0], np.int64)), (('overwrite', False),)),
    'expand': ((X,), (('expand_times', [2, 1]),)),
    'where': ((BX, X, POS), ()),
    'sampling_id': ((np.eye(4, dtype=np.float32)[[2, 0, 3]],), ()),
    'slice': ((X,), (('axes', [1]), ('starts', [1]), ('ends', [3]))),
    'argmax': ((X,), (('axis', 1),)),
    'logical_not': ((BX,), ()),
    'gelu': ((X,), ()), 'erf': ((X,), ()),
    'softshrink': ((X,), (('lambda_', 0.3),)),
    'hard_shrink': ((X,), (('threshold', 0.3),)),
    'thresholded_relu': ((X,), (('threshold', 0.2),)),
    'relu6': ((X,), (('threshold', 1.5),)),
    'leaky_relu': ((X,), (('alpha', 0.1),)),
    'elu': ((X,), (('alpha', 0.5),)),
    'selu': ((X,), (('scale', 1.1), ('alpha', 1.5))),
    'brelu': ((X,), (('t_min', -0.5), ('t_max', 0.7))),
    'soft_relu': ((X,), (('threshold', 1.0),)),
    'stanh': ((X,), (('scale_a', 0.5), ('scale_b', 2.0))),
    'hard_sigmoid': ((X,), (('slope', 0.3), ('offset', 0.4))),
    'hard_swish': ((X,), (('threshold', 5.0), ('scale', 4.0),
                          ('offset', 2.0))),
    'swish': ((X,), (('beta', 2.0),)),
    'maxout': ((X,), (('groups', 2), ('name', 'maxout_n'), ('axis', 1))),
    'temporal_shift': ((CLIPS,), (('seg_num', 2), ('shift_ratio', 0.25))),
})
for _name in ('reduce_sum', 'reduce_mean', 'reduce_max', 'reduce_min'):
    CASES[_name] = ((X,), (('dim', 1), ('keep_dim', True)))
for _name in ('elementwise_add', 'elementwise_sub', 'elementwise_mul',
              'elementwise_div', 'elementwise_max', 'elementwise_min',
              'elementwise_pow', 'elementwise_mod', 'elementwise_floordiv'):
    CASES[_name] = ((POS, Y3), (('axis', 0),))
for _name in ('logical_and', 'logical_or', 'logical_xor'):
    CASES[_name] = ((BX, BY), ())
NAMES = sorted(CASES)


def _dtype(a):
    return {np.float32: 'float32', np.int64: 'int64',
            np.bool_: 'bool'}[a.dtype.type]


def run_static(pkg, name, positional):
    """The layer's output in a static program of ``pkg`` (attributes by
    position, or as keywords), and its Variable."""
    inputs, attrs = CASES[name]
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        xs = [pkg.data(f'in{i}', list(a.shape), _dtype(a))
              for i, a in enumerate(inputs)]
        layer = getattr(pkg.layers, name)
        if positional:
            out = layer(*xs, *(v for _, v in attrs))
        else:
            out = layer(*xs, **dict(attrs))
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup)
    got, = exe.run(main, feed={f'in{i}': a for i, a in enumerate(inputs)},
                   fetch_list=[out])
    return np.asarray(got), out


def test_every_generated_layer_that_runs_has_a_case():
    generated = {n for n in port_nn.__all__
                 if (getattr(port_nn, n).__doc__ or '').startswith(
                     'Layer of the op') and has_op(
                         {'argmax': 'arg_max'}.get(n, n))
                 and 'not ported' not in getattr(port_nn, n).__doc__}
    assert generated == set(CASES)
    # 40, the four logical ops, and 31 over the ops registered since A.4c
    assert len(CASES) == 75


@pytest.mark.parametrize('name', NAMES)
def test_positional_attributes_match_jax_keywords_static(name):
    got, out = run_static(fluid, name, positional=True)
    want, _ = run_static(jfluid, name, positional=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), atol=1e-6, rtol=0)
    if name in UNARY:
        assert out.name.startswith(f'{name}_out')


@pytest.mark.parametrize('name', NAMES)
def test_positional_attributes_match_jax_keywords_dygraph(name):
    inputs, attrs = CASES[name]
    want, _ = run_static(jfluid, name, positional=False)
    with dygraph.guard(fluid.CPUPlace()):
        xs = [dygraph.to_variable(a) for a in inputs]
        got = getattr(fluid.layers, name)(*xs, *(v for _, v in attrs))
        got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), atol=1e-6, rtol=0)


@pytest.mark.parametrize('name', NAMES)
def test_a_surplus_positional_argument_raises(name):
    inputs, attrs = CASES[name]
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        xs = [fluid.data(f'in{i}', list(a.shape), _dtype(a))
              for i, a in enumerate(inputs)]
        layer = getattr(fluid.layers, name)
        full = [v for _, v in attrs]
        if 'name' in port_nn._POSITIONAL.get(name, ()) \
                and 'name' not in dict(attrs):
            full.append('a_name')
        with pytest.raises(TypeError, match=f'layers.{name}'):
            layer(*xs, *full, 'surplus')
        if attrs and attrs[0][0] != 'name':
            with pytest.raises(TypeError, match='multiple values'):
                layer(*xs, attrs[0][1], **{attrs[0][0]: attrs[0][1]})


def test_c12_probe_shapes():
    """The probe of ROADMAP C.12 on a static (3, 4) Variable."""
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        x = fluid.data('x', [3, 4], 'float32')
        L = fluid.layers
        assert L.reshape(x, [4, 3]).shape == (4, 3)
        assert L.transpose(x, [1, 0]).shape == (4, 3)
        assert L.unsqueeze(x, [1]).shape == (3, 1, 4)
        assert L.reduce_sum(x, 1).shape == (3,)


@pytest.mark.parametrize('name', ['less_than', 'less_equal', 'greater_than',
                                  'greater_equal', 'equal', 'not_equal'])
def test_comparisons_take_cond_and_name_by_position(name):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data('x', [3, 4], 'float32')
        y = fluid.data('y', [3, 4], 'float32')
        cond = fluid.layers.create_tensor('bool')
        out = getattr(fluid.layers, name)(x, y, cond, f'{name}_cmp')
        assert out.name == cond.name
        with pytest.raises(TypeError):
            getattr(fluid.layers, name)(x, y, cond, 'n', 'surplus')
    got, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={'x': X, 'y': POS - 0.5}, fetch_list=[out])
    want = getattr(np, {'less_than': 'less', 'greater_than': 'greater'}.get(
        name, name))(X, POS - 0.5)
    np.testing.assert_array_equal(got, want)
    with dygraph.guard(fluid.CPUPlace()):
        eager = getattr(fluid.layers, name)(dygraph.to_variable(X),
                                            dygraph.to_variable(POS - 0.5))
        np.testing.assert_array_equal(eager.numpy(), want)
