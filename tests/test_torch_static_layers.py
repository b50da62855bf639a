"""The rest of the Fluid static-graph layer surface in the port
(paddle_tpu_torch/ops/{math_ops, tensor_ops, loss_ops}.py's new ops,
layers/{tensor, nn, loss, control_flow, math_op_patch,
learning_rate_scheduler}.py, and the name table of layers/__init__.py)
against the JAX package's, on the CPU, from the same numpy inputs
(``numpy.random.RandomState``).

- Each new op against the JAX op, one parametrised test per family
  (math, tensor, loss): atol 1e-6, rtol 1e-5 (the same few f32
  operations in both; ``pow`` and ``exp`` of the same f32 inputs differ by
  an ulp at most). Integer results are compared by value: the port keeps
  int64 where the JAX package computes int32 (x64 off).
- The new layers build the same ops, slots and attrs in both packages
  and, run from the JAX startup values, give the same fetches (same
  tolerances).
- Every public name of ``paddle_tpu.layers`` exists in
  ``paddle_tpu_torch.layers``; each one the port does not run raises
  ``NotImplementedError`` naming its ROADMAP item, one case a name.
- The Variable operators append the JAX package's ops and compute its
  values.
- Each of the eight static learning-rate schedules, fetched over 25 runs
  in both packages across its boundaries: rtol 1e-6 (the same f32 ops on
  the same counter).
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.layers as jlayers
import paddle_tpu_torch as fluid
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch import layers
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.ops import registry
from torch_jax_seed import jax_seed_pinned  # noqa: F401

ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def fresh_port_programs():
    """Fresh default programs, scope and name counter of the port, as
    tests/conftest.py gives the JAX package's."""
    import paddle_tpu_torch.core.scope as scope_mod
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import unique_name
    old = (framework._main_program_, framework._startup_program_,
           scope_mod._global_scope, unique_name.generator)
    framework._main_program_ = framework.Program()
    framework._startup_program_ = framework.Program()
    scope_mod._global_scope = scope_mod.Scope()
    unique_name.generator = unique_name.UniqueNameGenerator()
    yield
    (framework._main_program_, framework._startup_program_,
     scope_mod._global_scope, unique_name.generator) = old


def run_op(name, args, attrs=None):
    """The op ``name`` of both packages on the same numpy ``args``:
    (port results, JAX results), lists of numpy arrays."""
    from paddle_tpu import ops  # noqa: F401  (registers every JAX op)
    attrs = attrs or {}
    want = jax_registry.get_op(name).fn(*args, **attrs)
    got = registry.get_op(name).fn(
        *[torch.from_numpy(np.asarray(a)) for a in args], **attrs)

    def as_list(r):
        r = r if isinstance(r, (tuple, list)) else (r,)
        return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
                for x in r]
    return as_list(got), as_list(want)


def assert_same(got, want, atol=ATOL, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind in 'biu':
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def f32(*shape, seed=0, positive=False):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


# ------------------------------------------------------------- the ops

MATH_CASES = {
    'elementwise_min': ([f32(2, 3, 4), f32(3, 4, seed=1)], {'axis': -1}),
    'elementwise_min_axis': ([f32(2, 3, 4), f32(3, seed=1)], {'axis': 1}),
    'elementwise_pow': ([f32(2, 3, positive=True), f32(2, 3, seed=1)],
                        {'axis': -1}),
    'exp': ([f32(3, 5)], {}),
    'log': ([f32(3, 5, positive=True)], {}),
    'floor': ([f32(3, 5) * 3], {}),
    'ceil': ([f32(3, 5) * 3], {}),
    'cos': ([f32(3, 5) * 3], {}),
    'pow': ([f32(3, 5, positive=True)], {'factor': -0.5}),
    'pow_int_factor': ([f32(3, 5)], {'factor': 2.0}),
    'reduce_max': ([f32(2, 3, 4)], {'dim': [1, 2]}),
    'reduce_max_all_keep': ([f32(2, 3, 4)], {'keep_dim': True}),
    'reduce_min': ([f32(2, 3, 4)], {'dim': -1, 'keep_dim': True}),
    'reduce_min_all': ([f32(2, 3, 4)], {'reduce_all': True}),
    'equal': ([np.array([1., 2., 3.], np.float32),
               np.array([1., 0., 3.], np.float32)], {}),
    'less_than': ([f32(4, 3), f32(3, seed=1)], {}),
    'less_equal': ([np.array([1., 2., 3.], np.float32),
                    np.array([2.], np.float32)], {}),
    'greater_than': ([f32(4, 3), f32(4, 3, seed=1)], {}),
    'greater_equal': ([np.array([5.], np.float32),
                       np.array([2., 5., 9.], np.float32)], {}),
    'increment': ([np.array([-1], np.int64)], {'value': 1.0}),
    'increment_f32': ([f32(3)], {'value': 2.5}),
}


def _op_name(case):
    """The op a case id names: itself, or its longest op-name prefix."""
    if case in registry.all_ops():
        return case
    return max((n for n in registry.all_ops() if case.startswith(n)),
               key=len)


@pytest.mark.parametrize('case', sorted(MATH_CASES))
def test_math_op_matches_jax(case):
    args, attrs = MATH_CASES[case]
    name = _op_name(case)
    got, want = run_op(name, args, attrs)
    assert_same(got, want)
    if name == 'increment':
        assert got[0].dtype == args[0].dtype


TENSOR_CASES = {
    'concat': ([[f32(2, 3), f32(2, 5, seed=1)]], {'axis': 1}),
    'split': ([f32(6, 4)], {'num_or_sections': 3, 'dim': 0}),
    'split_sections': ([f32(2, 9)], {'num_or_sections': [2, -1, 3],
                                     'dim': -1}),
    'stack': ([[f32(2, 3), f32(2, 3, seed=1)]], {'axis': 1}),
    'unstack': ([f32(3, 2, 4)], {'axis': 1}),
    'squeeze': ([f32(2, 1, 3, 1)], {'axes': [1, -1]}),
    'squeeze_all': ([f32(2, 1, 3, 1)], {}),
    'unsqueeze': ([f32(2, 3)], {'axes': [0, 2]}),
    'gather': ([f32(5, 3), np.array([4, 0, 2], np.int64)], {}),
    'gather_n1': ([f32(5, 3), np.array([[1], [3]], np.int32)], {}),
    'expand': ([f32(2, 3)], {'expand_times': [2, 3]}),
    'assign': ([f32(2, 3)], {}),
    'fill_constant_batch_size_like': ([f32(7, 2)], {
        'shape': [-1, 3], 'value': 1.5, 'dtype': 'float32'}),
    'fill_constant_batch_size_like_idx': ([f32(2, 7)], {
        'shape': [4, -1], 'value': 2, 'dtype': 'int64',
        'input_dim_idx': 1, 'output_dim_idx': 1}),
    'fill_zeros_like': ([f32(2, 3)], {}),
    'fill_any_like': ([f32(2, 3)], {'value': 1.0}),
    'top_k': ([f32(4, 10)], {'k': 5}),
    'range': ([], {'start': 0, 'end': 10, 'step': 3, 'dtype': 'int64'}),
    'range_f32': ([], {'start': 0.5, 'end': 3.0, 'step': 0.5,
                       'dtype': 'float32'}),
}


@pytest.mark.parametrize('case', sorted(TENSOR_CASES))
def test_tensor_op_matches_jax(case):
    args, attrs = TENSOR_CASES[case]
    from paddle_tpu import ops  # noqa: F401
    name = _op_name(case)
    want = jax_registry.get_op(name).fn(*args, **attrs)
    port_args = [[torch.from_numpy(x) for x in a] if isinstance(a, list)
                 else torch.from_numpy(a) for a in args]
    got = registry.get_op(name).fn(*port_args, **attrs)
    flat = (lambda r: [np.asarray(x) for x in r]
            if isinstance(r, (list, tuple)) else [np.asarray(r)])
    assert_same(flat(got), flat(want))


LOSS_CASES = {
    'cross_entropy': lambda: ([_probs(6, 5), np.array(
        [[0], [4], [2], [1], [3], [0]], np.int64)], {}),
    'cross_entropy_ignore': lambda: ([_probs(6, 5), np.array(
        [[0], [-100], [2], [1], [3], [-100]], np.int64)], {}),
    'cross_entropy_soft': lambda: ([_probs(4, 5), _probs(4, 5, seed=2)],
                                   {'soft_label': True}),
    'sigmoid_cross_entropy_with_logits': lambda: (
        [f32(4, 3) * 4, (f32(4, 3, seed=1) > 0).astype(np.float32)], {}),
    'sigmoid_cross_entropy_with_logits_norm': lambda: (
        [f32(4, 3) * 4, np.array([[1, 0, -1], [0, 1, 1], [-1, -1, 0],
                                  [1, 1, 1]], np.float32)],
        {'ignore_index': -1, 'normalize': True}),
    'square_error_cost': lambda: ([f32(4, 3), f32(4, 3, seed=1)], {}),
}


def _probs(n, c, seed=0):
    e = np.exp(f32(n, c, seed=seed))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize('case', sorted(LOSS_CASES))
def test_loss_op_matches_jax(case):
    args, attrs = LOSS_CASES[case]()
    assert_same(*run_op(_op_name(case), args, attrs))


# ------------------------------------------------------------ the layers

def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items()
              if k != 'initializer' and not isinstance(v, np.ndarray)})
            for op in program.global_block().ops]


def build_and_run(builder, feed):
    """``builder(pkg, x)`` -> fetch Variables in both packages, on the fed
    f32 ``x`` (shape of ``feed['x']``): asserts the same programs, runs
    the JAX startup, carries its values into the port and returns (port
    fetches, JAX fetches)."""
    out = {}
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.data('x', list(feed['x'].shape), 'float32')
            fetch = builder(pkg, x)
        out[pkg] = main, startup, fetch
    (jm, js, jf), (tm, ts, tf) = out[jfluid], out[fluid]
    assert _ops(tm) == _ops(jm)
    assert [(v.name, v.shape, v.persistable) for v in tm.list_vars()] == \
        [(v.name, v.shape, v.persistable) for v in jm.list_vars()]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle(
        {v.name: np.asarray(jscope.find(v.name)).astype(v.dtype)
         for v in tm.list_vars() if v.persistable}, tscope,
        fluid.CPUPlace(), program=tm)
    want = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
    got = texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)
    return got, want


def _layer_cases():
    ids = np.array([[1], [4], [0], [3]], np.int64)
    return {
        'concat': lambda p, x: [p.layers.concat([x, x * 2.0], axis=1)],
        'sums': lambda p, x: [p.layers.sums([x, x, x])],
        'assign_array': lambda p, x: [
            p.layers.assign(np.arange(6, dtype='float32').reshape(2, 3))],
        'zeros_ones': lambda p, x: [p.layers.zeros([2, 3], 'float32'),
                                    p.layers.ones([3], 'int64')],
        'zeros_ones_like': lambda p, x: [p.layers.zeros_like(x),
                                         p.layers.ones_like(x)],
        'fill_constant_batch_size_like': lambda p, x: [
            p.layers.fill_constant_batch_size_like(x, [-1, 7], 'float32',
                                                   0.5)],
        'range': lambda p, x: [p.layers.range(0, 10, 2, 'int64')],
        'embedding': lambda p, x: [p.layers.embedding(
            p.layers.assign(ids), size=[5, 3], padding_idx=-2)],
        'layer_norm': lambda p, x: [p.layers.layer_norm(x,
                                                        begin_norm_axis=1)],
        'one_hot': lambda p, x: [p.layers.one_hot(p.layers.assign(ids), 5)],
        'split': lambda p, x: p.layers.split(x, 2, dim=1),
        'stack': lambda p, x: [p.layers.stack([x, x], axis=0)],
        'topk': lambda p, x: list(p.layers.topk(x, 2)),
        'squeeze_unsqueeze': lambda p, x: [p.layers.squeeze(
            p.layers.unsqueeze(x, axes=[0]), axes=[0])],
        'cross_entropy': lambda p, x: [p.layers.cross_entropy(
            p.layers.softmax(x), p.layers.assign(ids))],
        'square_error_cost': lambda p, x: [p.layers.square_error_cost(
            x, x * 0.5)],
        'mse_loss': lambda p, x: [p.layers.mse_loss(x, x * 0.5)],
        'sigmoid_cross_entropy_with_logits': lambda p, x: [
            p.layers.sigmoid_cross_entropy_with_logits(
                x, p.layers.cast(x > 0.0, 'float32'))],
        'comparisons': lambda p, x: [
            f(x, x * 0.5) for f in (p.layers.less_than, p.layers.less_equal,
                                    p.layers.greater_than,
                                    p.layers.greater_equal, p.layers.equal,
                                    p.layers.not_equal)],
        'increment': lambda p, x: [p.layers.increment(
            p.layers.fill_constant([1], 'float32', 2.0), 3.0,
            in_place=False)],
        'autoincreased_step_counter': lambda p, x: [
            p.layers.autoincreased_step_counter(begin=5)],
    }


LAYER_CASES = _layer_cases()


@pytest.mark.parametrize('case', sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    x = f32(4, 6, seed=3)
    got, want = build_and_run(LAYER_CASES[case], {'x': x})
    assert_same([np.asarray(g) for g in got], [np.asarray(w) for w in want])


def test_unstack_gives_one_variable_a_slice():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data('x', [3, 4], 'float32')
        parts = fluid.layers.unstack(x, axis=1)
    assert len(parts) == 4
    x_np = f32(3, 4)
    got = fluid.Executor(fluid.CPUPlace()).run(main, feed={'x': x_np},
                                               fetch_list=parts)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, x_np[:, i])


def test_embedding_is_sparse_raises():
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        ids = fluid.data('ids', [4, 1], 'int64')
        with pytest.raises(NotImplementedError, match='A.10'):
            fluid.layers.embedding(ids, [5, 3], is_sparse=True)


# ----------------------------------------------- every name of the layers

PUBLIC = sorted(n for n in dir(jlayers) if not n.startswith('_'))


@pytest.mark.parametrize('name', PUBLIC)
def test_every_jax_layers_name_exists_in_the_port(name):
    """Each name exists; one the port does not run raises naming its
    ROADMAP item when called (or, for a module, on any attribute)."""
    assert hasattr(layers, name)
    obj = getattr(layers, name)
    item = layers.NOT_PORTED.get(name)
    if isinstance(getattr(jlayers, name), types.ModuleType):
        assert isinstance(obj, types.ModuleType)
        if name in ('detection', 'distributions', 'sequence_lod'):
            with pytest.raises(NotImplementedError, match='A.10'):
                getattr(obj, 'anything')
        if name == 'sequence_lod':
            # its one ported layer (tests/test_torch_seq2seq.py runs it)
            assert obj.sequence_mask is layers.sequence_mask
        return
    assert callable(obj)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item.replace('.',
                                                                   r'\.')):
            obj()


def test_the_not_ported_table_shadows_nothing_the_port_runs():
    """No name of the table is defined by a module the port runs, and
    each names one of the three items."""
    import importlib
    from paddle_tpu_torch.layers import (control_flow, learning_rate_scheduler,
                                         loss, nn, sequence_lod, tensor)
    rnn = importlib.import_module('paddle_tpu_torch.layers.rnn')
    defined = set()
    for mod in (control_flow, learning_rate_scheduler, loss, nn, rnn,
                sequence_lod, tensor):
        defined |= set(mod.__all__)
    assert not defined & set(layers.NOT_PORTED)
    assert set(layers.NOT_PORTED.values()) == {'A.10', 'A.11'}


def test_the_control_flow_module_holds_its_a_8a_names():
    """Every name of the JAX package's control_flow module is on the
    port's: the A.8a constructs are its own and run
    (tests/test_torch_control_flow.py runs each), and the three names it
    does not run raise their item."""
    from paddle_tpu.layers import control_flow as jcf
    from paddle_tpu_torch.layers import control_flow
    not_run = {}
    for name in jcf.__all__:
        assert hasattr(control_flow, name), name
        item = layers.NOT_PORTED.get(name)
        if item is None:
            assert name in control_flow.__all__, name
            assert getattr(layers, name) is getattr(control_flow, name)
        else:
            not_run[name] = item
            with pytest.raises(NotImplementedError,
                               match=item.replace('.', r'\.')):
                getattr(control_flow, name)()
    assert not_run == {'Print': 'A.11', 'lod_rank_table': 'A.10',
                       'reorder_lod_tensor_by_rank': 'A.10'}


def test_a_generated_layer_over_an_unregistered_op_raises_a_10():
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        x = fluid.data('x', [2, 3], 'float32')
        # a generated layer whose op the port does not register
        with pytest.raises(NotImplementedError, match='A.10'):
            fluid.layers.logsumexp(x)


# ------------------------------------------------- Variable operators

OPERATORS = {
    'add': lambda x, y: x + y, 'radd': lambda x, y: 2.0 + x,
    'sub': lambda x, y: x - y, 'rsub': lambda x, y: 1.0 - x,
    'mul': lambda x, y: x * 3.0, 'rmul': lambda x, y: 0.5 * y,
    'div': lambda x, y: x / y, 'rdiv': lambda x, y: 1.0 / y,
    'pow': lambda x, y: y ** x, 'neg': lambda x, y: -x,
    'eq': lambda x, y: x == y, 'ne': lambda x, y: x != y,
    'lt': lambda x, y: x < y, 'le': lambda x, y: x <= y,
    'gt': lambda x, y: x > 0.0, 'ge': lambda x, y: x >= y,
    'astype': lambda x, y: (x * 4.0).astype('int64'),
}


@pytest.mark.parametrize('name', sorted(OPERATORS))
def test_variable_operator_matches_jax(name):
    x = np.round(f32(3, 4) * 2).astype(np.float32)
    y = np.round(f32(3, 4, seed=1) * 2).astype(np.float32)
    y = np.where(y == 0, 1.0, np.abs(y) + 0.5).astype(np.float32)
    out = {}
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            xv = pkg.data('x', [3, 4], 'float32')
            yv = pkg.data('y', [3, 4], 'float32')
            res = OPERATORS[name](xv, yv)
        out[pkg] = main, res
    assert _ops(out[fluid][0]) == _ops(out[jfluid][0])
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        out[jfluid][0], feed={'x': x, 'y': y}, fetch_list=[out[jfluid][1]])
    got = fluid.Executor(fluid.CPUPlace()).run(
        out[fluid][0], feed={'x': x, 'y': y}, fetch_list=[out[fluid][1]])
    assert_same([np.asarray(got[0])], [np.asarray(want[0])])


def test_variable_hash_is_identity_and_eq_appends_an_op():
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        x = fluid.data('x', [3], 'float32')
        y = fluid.data('y', [3], 'float32')
        assert len({x, y, x}) == 2
        n = len(fluid.default_main_program().global_block().ops)
        eq = x == y
        assert isinstance(eq, fluid.Variable)
        assert fluid.default_main_program().global_block().ops[n].type == \
            'equal'


# -------------------------------------------------------- the schedules

SCHEDULES = {
    'exponential_decay': lambda L: L.exponential_decay(0.1, 5, 0.5),
    'exponential_decay_staircase': lambda L: L.exponential_decay(
        0.1, 5, 0.5, staircase=True),
    'natural_exp_decay': lambda L: L.natural_exp_decay(0.1, 5, 0.3, True),
    'inverse_time_decay': lambda L: L.inverse_time_decay(0.1, 4, 0.5),
    'polynomial_decay': lambda L: L.polynomial_decay(0.1, 10, 0.001,
                                                     power=2.0),
    'polynomial_decay_cycle': lambda L: L.polynomial_decay(
        0.1, 7, 0.001, power=1.0, cycle=True),
    'piecewise_decay': lambda L: L.piecewise_decay([3, 8, 20],
                                                   [1.0, 0.5, 0.1, 0.01]),
    'noam_decay': lambda L: L.noam_decay(64, 10),
    'cosine_decay': lambda L: L.cosine_decay(0.1, 3, 6),
    'linear_lr_warmup': lambda L: L.linear_lr_warmup(0.5, 10, 0.0, 0.5),
    'linear_lr_warmup_of_a_schedule': lambda L: L.linear_lr_warmup(
        L.piecewise_decay([12, 18], [0.4, 0.2, 0.1]), 6, 0.01, 0.4),
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_static_schedule_matches_jax_over_25_runs(name):
    rates = {}
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            lr = SCHEDULES[name](pkg.layers)
        if pkg is jfluid:
            exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        else:
            exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        rates[pkg] = [float(np.asarray(exe.run(main, fetch_list=[lr],
                                               scope=scope)[0]).reshape(-1)[0])
                      for _ in range(25)]
        if pkg is fluid:
            assert exe.lowering_count(main) == 1
            counters = [v for v in main.list_vars()
                        if v.name.startswith('lr_decay_counter')]
            assert counters and all(v.belong_to_optimizer and v.dtype ==
                                    'int64' for v in counters)
    port, ref = np.asarray(rates[fluid]), np.asarray(rates[jfluid])
    if name == 'polynomial_decay_cycle':
        # ROADMAP C.8: at a step that is a multiple of decay_steps (21 of
        # 7) XLA's division rounds 21 / 7 to 3.0000002, whose ceil starts
        # the next cycle; the port divides exactly, as Paddle's op does.
        # Those steps are held to Paddle's formula, the rest to the JAX
        # package
        step = np.arange(25.0)
        ds = 7 * np.maximum(np.ceil(step / 7), 1)
        formula = (0.1 - 0.001) * (1 - step / ds) + 0.001
        np.testing.assert_allclose(port, formula, rtol=1e-6)
        exact = (step % 7 == 0) & (step > 0)
        port, ref = port[~exact], ref[~exact]
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    assert len(set(rates[fluid])) > 1      # the rate moved across the runs


def test_piecewise_decay_takes_each_value_at_its_boundary():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        lr = fluid.layers.piecewise_decay([2, 5], [1.0, 0.5, 0.25])
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    got = [float(exe.run(main, fetch_list=[lr])[0][0]) for _ in range(7)]
    assert got == [1.0, 1.0, 0.5, 0.5, 0.5, 0.25, 0.25]


def test_schedules_under_a_dygraph_guard_are_the_dygraph_schedules():
    from paddle_tpu_torch.dygraph import learning_rate_scheduler as dy_lr
    with fluid.dygraph.guard(fluid.CPUPlace()):
        assert isinstance(fluid.layers.piecewise_decay([2], [1.0, 0.5]),
                          dy_lr.PiecewiseDecay)
        assert isinstance(fluid.layers.cosine_decay(0.1, 3, 6),
                          dy_lr.CosineDecay)
        assert isinstance(fluid.layers.noam_decay(64, 10), dy_lr.NoamDecay)


def test_momentum_takes_a_schedule_variable_in_the_static_graph_only():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data('x', [4, 3], 'float32')
        loss = fluid.layers.mean(fluid.layers.fc(x, 2))
        lr = fluid.layers.piecewise_decay([2], [0.1, 0.01])
        opt = fluid.optimizer.Momentum(lr, momentum=0.9)
        opt.minimize(loss)
    assert opt.get_lr_var() is lr
    moms = [op for op in main.global_block().ops if op.type == 'momentum']
    assert moms and all(op.inputs['lr'] == [lr.name] for op in moms)
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.ones(2)
    with pytest.raises(TypeError, match='static-graph Variable'):
        fluid.optimizer.Momentum(lr, momentum=0.9, parameter_list=[p]).step()
