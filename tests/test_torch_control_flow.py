"""The static control flow of the port (paddle_tpu_torch/layers/
control_flow.py and the executor's control-flow ops) against the JAX
package's, on the CPU, from the same numpy inputs.

Each construct of tests/layers/test_control_flow.py, the Switch, IfElse
and DynamicRNN cases of tests/layers/test_decoders_and_legacy_cf.py and
test_static_autodiff.py's differentiable while loop is built by the same
code in both packages:

- the programs hold the same ops in every block (types, slots, attrs);
- every fetch equals the JAX package's within atol 1e-6, rtol 1e-6 (the
  same few f32 operations; counts and integer results exactly), and the
  value the construct computes by hand;
- the gradient through a bounded ``while_loop`` equals the JAX package's
  (its masked scan) and 2^k, exactly.

Errors: a loop carry that changes type raises ``TypeError`` in both; an
unbounded ``while_loop`` under a backward raises in both (the port names
``maximum_trip_count``); a branch returning None against a value raises
``ValueError``. Dropout inside a ``StaticRNN`` step draws a new mask each
step. Under a ``dygraph.guard`` the functional forms and the tensor arrays
run as Python control flow and equal the JAX package's dygraph results.
A program with ``__scan__``, ``__cond__`` and ``__while__`` saved as an
inference model by either package runs in the other (and through the
port's ``Predictor``, equal to the loaded program); the port's prune
keeps a producer that only a branch reads.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from torch_jax_seed import jax_seed_pinned  # noqa: F401

ATOL = RTOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_port_programs():
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


def names_of(pkg):
    from paddle_tpu.core import unique_name as jnames
    from paddle_tpu_torch.core import unique_name as tnames
    return jnames if pkg is jfluid else tnames


def build(pkg, fn):
    main, start = pkg.Program(), pkg.Program()
    with names_of(pkg).guard(), pkg.program_guard(main, start):
        fetch = fn(pkg, pkg.layers)
    return main, start, fetch


def run(pkg, main, start, feed, fetch):
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(start)
        return [np.asarray(o) for o in exe.run(main, feed=feed,
                                               fetch_list=fetch)]


def ops(program):
    return [(b.idx, b.parent_idx, op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items()
              if k != 'initializer' and not isinstance(v, np.ndarray)})
            for b in program.blocks for op in b.ops]


def data(L, name, shape, dtype='float32'):
    return L.data(name, shape=shape, dtype=dtype, append_batch_size=False)


# ------------------------------------------------- the constructs

def cond_static(pkg, L):
    x = data(L, 'x', [3])
    return [L.cond(L.reduce_sum(x) > 1.0, lambda: x * 2.0,
                   lambda: x - 1.0)]


def cond_multiple_outputs(pkg, L):
    x = data(L, 'x', [3])
    a, b = L.cond(L.reduce_sum(x) > 0.0, lambda: (x + 1.0, x + 2.0),
                  lambda: (x * 0.0, x * 3.0))
    return [a, b]


def cond_parent_var_write(pkg, L):
    x = data(L, 'x', [3])
    acc = L.fill_constant([3], 'float32', 0.0)
    L.cond(L.reduce_sum(x) > 0.0,
           lambda: L.assign(x * 10.0, output=acc),
           lambda: L.assign(x * -1.0, output=acc))
    return [acc]


def case(pkg, L):
    x = data(L, 'x', [3])
    s = L.reduce_sum(x)
    return [L.case(
        [(s < 0.0, lambda: L.fill_constant([1], 'float32', -1.0)),
         (s < 10.0, lambda: L.fill_constant([1], 'float32', 0.5))],
        default=lambda: L.fill_constant([1], 'float32', 99.0))]


def switch_case(pkg, L):
    i = data(L, 'i', [1], 'int32')
    return [L.switch_case(
        i, {1: lambda: L.fill_constant([2], 'float32', 1.0),
            3: lambda: L.fill_constant([2], 'float32', 3.0)},
        default=lambda: L.fill_constant([2], 'float32', -1.0))]


def while_loop(pkg, L):
    i = L.fill_constant([1], 'int32', 0)
    acc = L.fill_constant([1], 'float32', 0.0)
    limit = data(L, 'n', [1], 'int32')
    return L.while_loop(lambda i, a: L.less_than(i, limit),
                        lambda i, a: [i + 1, a + 2.0], [i, acc])


def while_loop_bounded(pkg, L):
    """The same loop with a trip bound above and below the trips run."""
    limit = data(L, 'n', [1], 'int32')
    outs = []
    for bound in (8, 3):
        i = L.fill_constant([1], 'int32', 0)
        acc = L.fill_constant([1], 'float32', 0.0)
        outs += L.while_loop(lambda i, a: L.less_than(i, limit),
                             lambda i, a: [i + 1, a + 2.0], [i, acc],
                             maximum_trip_count=bound)
    return outs


def while_legacy(pkg, L):
    n = L.fill_constant([1], 'int64', 4)
    i = L.fill_constant([1], 'int64', 0)
    total = L.fill_constant([1], 'int64', 0)
    cond_var = L.less_than(i, n)
    w = L.While(cond_var)
    with w.block():
        L.assign(total + i, total)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=cond_var)
    return [total, i]


def static_rnn(pkg, L):
    x = data(L, 'xs', [4, 2, 3])
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(shape=[2, 3], batch_ref=x, init_value=0.0)
        h = h_prev + x_t
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    return [rnn()]


def tensor_array(pkg, L):
    x = data(L, 'x', [3])
    arr = L.create_array('float32')
    i0 = L.fill_constant([1], 'int64', 0)
    i1 = L.fill_constant([1], 'int64', 1)
    L.array_write(x, i0, arr)
    L.array_write(x * 2.0, i1, arr)
    return [L.array_read(arr, i1), L.array_length(arr),
            L.is_empty(x)]


def switch(pkg, L):
    x = data(L, 'x', [3])
    out = L.create_global_var([1], 0.0, 'float32', persistable=True)
    one = L.fill_constant([1], 'float32', 1.0)
    two = L.fill_constant([1], 'float32', 2.0)
    three = L.fill_constant([1], 'float32', 3.0)
    with L.Switch() as sw:
        with sw.case(L.reduce_sum(x) > 10.0):
            L.assign(one, output=out)
        with sw.case(L.reduce_sum(x) > 5.0):
            L.assign(two, output=out)
        with sw.default():
            L.assign(three, output=out)
    return [out]


def ifelse(pkg, L):
    x = L.data('xb', shape=[1], dtype='float32')
    c = L.greater_than(x, L.fill_constant([1], 'float32', 0.0))
    ie = L.IfElse(c)
    with ie.true_block():
        ie.output(ie.input(x) * 2.0)
    with ie.false_block():
        ie.output(ie.input(x) - 1.0)
    return [ie()[0]]


def dynamic_rnn(pkg, L):
    x = L.data('xd', shape=[3, 2], dtype='float32')
    lens = L.data('lens', shape=[1], dtype='int64')
    drnn = L.DynamicRNN()
    with drnn.block():
        step = drnn.step_input(x, sequence_length=lens)
        acc = drnn.memory(shape=[2], value=0.0)
        new = acc + step
        drnn.update_memory(acc, new)
        drnn.output(new)
    return [drnn()]


def rnn_dropout(pkg, L):
    x = data(L, 'xr', [3, 2, 64])
    rnn = L.StaticRNN()
    with rnn.step():
        rnn.step_output(L.dropout(rnn.step_input(x), dropout_prob=0.5))
    return [rnn()]


X3 = {k: {'x': np.array(v, np.float32)} for k, v in
      (('pos', [1.0, 2.0, 3.0]), ('neg', [-3.0, -1.0, 0.5]),
       ('mid', [1.0, 2.0, 4.0]), ('big', [20.0, 1.0, 0.0]))}
CASES = {
    # name: (construct, feeds, the values it computes by hand)
    'cond_static': (cond_static, [X3['pos'], X3['neg']],
                    [[[2, 4, 6]], [[-4, -2, -0.5]]]),
    'cond_multiple_outputs': (cond_multiple_outputs, [X3['pos'], X3['neg']],
                              [[[2, 3, 4], [3, 4, 5]],
                               [[0, 0, 0], [-9, -3, 1.5]]]),
    'cond_parent_var_write': (cond_parent_var_write, [X3['pos'], X3['neg']],
                              [[[10, 20, 30]], [[3, 1, -0.5]]]),
    'case': (case, [X3['neg'], X3['pos'], X3['big']],
             [[[-1]], [[0.5]], [[99]]]),
    'switch_case': (switch_case, [{'i': np.array([k], np.int32)}
                                  for k in (1, 3, 7)],
                    [[[1, 1]], [[3, 3]], [[-1, -1]]]),
    'while_loop': (while_loop, [{'n': np.array([5], np.int32)},
                                {'n': np.array([0], np.int32)}],
                   [[[5], [10]], [[0], [0]]]),
    'while_loop_bounded': (while_loop_bounded,
                           [{'n': np.array([5], np.int32)}],
                           [[[5], [10], [3], [6]]]),
    'while_legacy': (while_legacy, [{}], [[[6], [4]]]),
    'tensor_array': (tensor_array, [X3['pos']],
                     [[[2, 4, 6], 2, False]]),
    'switch': (switch, [X3['big'], X3['mid'], X3['neg']],
               [[[1]], [[2]], [[3]]]),
    'ifelse': (ifelse, [{'xb': np.array([[1.0], [-2.0], [3.0]],
                                        np.float32)}],
               [[[[2.0], [-3.0], [6.0]]]]),
    'dynamic_rnn': (dynamic_rnn, [{'xd': np.ones((2, 3, 2), np.float32),
                                   'lens': np.array([3, 1], np.int64)}],
                    [[[[[1, 1], [2, 2], [3, 3]],
                       [[1, 1], [2, 2], [2, 2]]]]]),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_construct_matches_jax(name):
    fn, feeds, by_hand = CASES[name]
    jm, js, jf = build(jfluid, fn)
    tm, ts, tf = build(fluid, fn)
    assert ops(tm) == ops(jm)
    for feed, hand in zip(feeds, by_hand):
        want = run(jfluid, jm, js, feed, jf)
        got = run(fluid, tm, ts, feed, tf)
        for g, w, h in zip(got, want, hand):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(g.astype(np.float64),
                                       np.asarray(h, np.float64).reshape(
                                           g.shape), atol=ATOL, rtol=RTOL)


def test_static_rnn_matches_jax_and_the_cumulative_sum():
    xv = np.random.RandomState(0).randn(4, 2, 3).astype(np.float32)
    jm, js, jf = build(jfluid, static_rnn)
    tm, ts, tf = build(fluid, static_rnn)
    assert ops(tm) == ops(jm)
    got, = run(fluid, tm, ts, {'xs': xv}, tf)
    want, = run(jfluid, jm, js, {'xs': xv}, jf)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.cumsum(xv, axis=0), atol=1e-5)


def differentiable_while(pkg, L, k=4):
    x = L.data('x', [3], dtype='float32')
    i = L.fill_constant([1], 'int64', 0)
    n = L.fill_constant([1], 'int64', k)
    _, out = L.while_loop(
        lambda i, v: L.less_than(i, n),
        lambda i, v: [L.increment(i, in_place=False), L.scale(v, scale=2.0)],
        [i, x], maximum_trip_count=8)
    loss = L.reduce_sum(out)
    gx, = pkg.gradients([loss], [x])
    return [loss, gx]


def test_while_loop_backward_bounded_matches_jax():
    xv = np.array([[1., 2., 3.]], np.float32)
    jm, js, jf = build(jfluid, differentiable_while)
    tm, ts, tf = build(fluid, differentiable_while)
    want = run(jfluid, jm, js, {'x': xv}, jf)
    got = run(fluid, tm, ts, {'x': xv}, tf)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], 16.0 * xv.sum())
    np.testing.assert_array_equal(got[1], np.full_like(xv, 16.0))


def unbounded_while_under_backward(pkg, L):
    x = L.data('x', [3], dtype='float32')
    i = L.fill_constant([1], 'int64', 0)
    n = L.fill_constant([1], 'int64', 2)
    _, out = L.while_loop(
        lambda i, v: L.less_than(i, n),
        lambda i, v: [L.increment(i, in_place=False), L.scale(v, scale=2.0)],
        [i, x])
    loss = L.reduce_sum(out)
    return [loss, pkg.gradients([loss], [x])[0]]


def test_unbounded_while_under_backward_raises_in_both():
    xv = np.ones((1, 3), np.float32)
    jm, js, jf = build(jfluid, unbounded_while_under_backward)
    with pytest.raises(Exception):
        run(jfluid, jm, js, {'x': xv}, jf)
    tm, ts, tf = build(fluid, unbounded_while_under_backward)
    with pytest.raises(ValueError, match='maximum_trip_count'):
        run(fluid, tm, ts, {'x': xv}, tf)
    # without the backward the same loop runs, in both
    fetch_loss = tf[:1]
    got, = run(fluid, tm.clone(for_test=True), ts, {'x': xv}, fetch_loss)
    assert float(got) == 12.0


def carry_changes_type(pkg, L):
    i = L.fill_constant([1], 'int32', 0)
    limit = L.fill_constant([1], 'int32', 3)
    return L.while_loop(lambda i: L.less_than(i, limit),
                        lambda i: [L.cast(i, 'float32') + 1.0], [i])


def test_a_carry_that_changes_type_raises_type_error_in_both():
    for pkg in (jfluid, fluid):
        m, s, f = build(pkg, carry_changes_type)
        with pytest.raises(TypeError, match='carry'):
            run(pkg, m, s, {}, f)


def test_a_branch_returning_none_against_a_value_raises():
    def fn(pkg, L):
        x = data(L, 'x', [1])
        with pytest.raises(ValueError, match='None'):
            L.cond(L.reduce_sum(x) > 0.0, lambda: x, lambda: None)
        return []
    build(fluid, fn)


def test_dropout_in_a_step_draws_a_new_mask_each_step():
    m, s, f = build(fluid, rnn_dropout)
    r, = run(fluid, m, s, {'xr': np.ones((3, 2, 64), np.float32)}, f)
    masks = r != 0
    assert not np.array_equal(masks[0], masks[1])
    assert not np.array_equal(masks[1], masks[2])
    # kept entries are scaled by 1 / (1 - p) for downgrade_in_infer's
    # counterpart at train time: x itself, and about half are kept
    np.testing.assert_array_equal(r[masks], 1.0)
    assert 0.35 < masks.mean() < 0.65


# ------------------------------------------------- dygraph

def dygraph_constructs(pkg):
    L = pkg.layers
    with pkg.dygraph.guard(pkg.CPUPlace()):
        x = pkg.dygraph.to_variable(np.array([1.0, 2.0, 3.0], np.float32))
        c = L.cond(L.reduce_sum(x) > 1.0, lambda: x * 2.0, lambda: x - 1.0)
        i = pkg.dygraph.to_variable(np.array([0], np.int32))
        acc = pkg.dygraph.to_variable(np.array([0.0], np.float32))
        w = L.while_loop(lambda i, a: i < 3, lambda i, a: [i + 1, a + 5.0],
                         [i, acc])
        s = L.switch_case(pkg.dygraph.to_variable(np.array([3], np.int32)),
                          {1: lambda: x * 0.0, 3: lambda: x + 1.0})
        arr = L.create_array('float32')
        L.array_write(x, pkg.dygraph.to_variable(np.array([0], np.int64)),
                      arr)
        L.array_write(x * 3.0, pkg.dygraph.to_variable(
            np.array([1], np.int64)), arr)
        stacked, _ = L.tensor_array_to_tensor(arr, axis=0)
        return [o.numpy() for o in (c, w[0], w[1], s, L.array_read(
            arr, pkg.dygraph.to_variable(np.array([1], np.int64))),
            L.array_length(arr), stacked, L.is_empty(x))]


def test_dygraph_control_flow_matches_jax():
    got, want = dygraph_constructs(fluid), dygraph_constructs(jfluid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), atol=ATOL)
    np.testing.assert_allclose(got[6], [[1, 2, 3], [3, 6, 9]])


# ------------------------------------------------- save and load

def served(pkg, L, scaled_outside=False):
    """A scan, a cond and a while, feeding one output; with
    ``scaled_outside`` the branches read a value made outside them that
    nothing else reads."""
    x = data(L, 'xs', [4, 2, 3])
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(shape=[2, 3], batch_ref=x, init_value=0.0)
        h = L.tanh(h_prev + x_t)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    seq = rnn()
    total = L.reduce_sum(seq)
    if scaled_outside:
        scaled = seq * 3.0
        picked = L.cond(total > 0.0, lambda: scaled + 1.0,
                        lambda: scaled - 1.0)
    else:
        picked = L.cond(total > 0.0, lambda: seq * 3.0 + 1.0,
                        lambda: seq * 3.0 - 1.0)
    i = L.fill_constant([1], 'int64', 0)
    # the bound is made inside the condition block: the JAX package's
    # prune would drop an outer one only that block reads
    _, out = L.while_loop(
        lambda i, v: L.less_than(i, L.fill_constant([1], 'int64', 3)),
        lambda i, v: [L.increment(i, in_place=False), L.sigmoid(v)],
        [i, picked])
    return [out]


@pytest.mark.parametrize('saver', ['port', 'jax'])
def test_control_flow_inference_model_runs_in_the_other_package(tmp_path,
                                                                saver):
    src, dst = (fluid, jfluid) if saver == 'port' else (jfluid, fluid)
    xv = np.random.RandomState(3).randn(4, 2, 3).astype(np.float32)
    main, start, fetch = build(src, served)
    exe = src.Executor(src.CPUPlace())
    with src.scope_guard(src.Scope()):
        exe.run(start)
        want = np.asarray(exe.run(main, feed={'xs': xv},
                                  fetch_list=fetch)[0])
        src.io.save_inference_model(str(tmp_path), ['xs'], fetch, exe,
                                    main_program=main)
    dexe = dst.Executor(dst.CPUPlace())
    with dst.scope_guard(dst.Scope()):
        prog, feeds, fetches = dst.io.load_inference_model(str(tmp_path),
                                                           dexe)
        got = np.asarray(dexe.run(prog, feed={'xs': xv},
                                  fetch_list=fetches)[0])
    types = {op.type for b in prog.blocks for op in b.ops}
    assert {'__scan__', '__cond__', '__while__'} <= types
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if dst is fluid:
        # and through the port's Predictor, bit for bit with the program
        from paddle_tpu_torch import inference
        pred = inference.Predictor(str(tmp_path),
                                   fluid.Executor(fluid.CPUPlace()))
        np.testing.assert_array_equal(pred.run([xv])[0], got)


def test_prune_keeps_the_producer_a_branch_reads(tmp_path):
    """``scaled`` is read only inside the branches; the port's prune keeps
    its producer (the JAX package's follows declared inputs only)."""
    main, start, fetch = build(
        fluid, lambda pkg, L: served(pkg, L, scaled_outside=True))
    pruned = main.clone(for_test=True)._prune(fetch)
    kept = [op.type for op in pruned.global_block().ops]
    assert kept.count('elementwise_mul') == 1        # seq * 3.0
    assert len(pruned.global_block().ops) == len(main.global_block().ops)
    exe = fluid.Executor(fluid.CPUPlace())
    xv = np.random.RandomState(3).randn(4, 2, 3).astype(np.float32)
    want, = exe.run(main, feed={'xs': xv}, fetch_list=fetch)
    got, = exe.run(pruned, feed={'xs': xv}, fetch_list=fetch)
    np.testing.assert_array_equal(got, want)
