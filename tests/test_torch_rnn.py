"""The recurrent cells and layers of the port (paddle_tpu_torch/layers/
rnn.py: ``GRUCell``, ``LSTMCell``, ``rnn``, ``birnn``, ``lstm``) against
the JAX package's, on the CPU, from the same numpy inputs
(``numpy.random.RandomState``) and the JAX package's startup values
carried across by name. Sizes: batch 3, 5 steps, input 4, hidden 6.

- Static programs: ``rnn`` over each cell, batch-major and time-major,
  forward and reversed, with and without ``sequence_length``; ``birnn``;
  ``lstm`` of 2 layers with per-layer initial states and of 1
  bidirectional layer. The programs hold the same ops in every block, and
  the outputs, final states and the gradients of ``reduce_sum`` of the
  outputs with respect to every cell weight and the input agree within
  atol 1e-5, rtol 1e-5 (the same f32 products, summed in another order).
- Numerics of tests/layers/test_rnn_numeric.py: ``rnn`` over a
  ``GRUCell`` of constant weights against a numpy recurrence (2e-4, that
  file's tolerance); past a row's ``sequence_length`` the outputs are zero
  and the final state is the last valid step's; a ``StaticRNN`` reusing
  the cell equals ``rnn`` (1e-5).
- ``lstm``'s ``default_initializer`` reaches the cell weights (the JAX
  package's leaves it unused).
- Dygraph: the same cells and layers under ``dygraph.guard(CPUPlace())``
  (weights set to the JAX package's startup values by name) equal the
  JAX package's static results within the same tolerance; their weights
  are dygraph Parameters and take gradients. The JAX package's cells do
  not run in dygraph (its LayerHelper makes static Parameters there).
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.convert import scope_from_paddle
from torch_jax_seed import jax_seed_pinned  # noqa: F401

B, T, D, H = 3, 5, 4, 6
ATOL = RTOL = 1e-5
RNG = np.random.RandomState(7)
X = RNG.randn(B, T, D).astype(np.float32)
LENS = np.array([2, 5, 3], np.int64)


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


def ops(program):
    return [(b.idx, op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items()
              if k != 'initializer' and not isinstance(v, np.ndarray)})
            for b in program.blocks for op in b.ops]


def layer_cases():
    """{name: (cell class name, rnn() keywords)}."""
    cases = {}
    for cell in ('GRUCell', 'LSTMCell'):
        for mode, kw in (('plain', {}), ('lens', {'lens': True}),
                         ('reverse', {'is_reverse': True}),
                         ('reverse_lens', {'is_reverse': True,
                                           'lens': True}),
                         ('time_major', {'time_major': True})):
            cases[f'{cell}-{mode}'] = (cell, kw)
    return cases


CELL_CASES = layer_cases()


def run_cell_case(L, cell, kw, x, lens):
    kw = dict(kw)
    use_lens = kw.pop('lens', False)
    xin = L.transpose(x, perm=[1, 0, 2]) if kw.get('time_major') else x
    out, st = L.rnn(getattr(L, cell)(H, name='c'), xin,
                    sequence_length=lens if use_lens else None, **kw)
    if kw.get('time_major'):
        out = L.transpose(out, perm=[1, 0, 2])
    return [out] + L.utils.flatten(st)


def birnn_case(L, x, lens):
    out, (fw, bw) = L.birnn(L.LSTMCell(H, name='fw'), L.GRUCell(H, name='bw'),
                            x, sequence_length=lens)
    return [out] + L.utils.flatten(fw) + [bw]


def lstm_case(L, x, h0, c0):
    xt = L.transpose(x, perm=[1, 0, 2])
    out, h, c = L.lstm(xt, [h0[0], h0[1]], [c0[0], c0[1]], T, H, 2)
    out2, h2, c2 = L.lstm(xt, None, None, T, H, 1, is_bidirec=True,
                          name='bi')
    return [out, h, c, out2, h2, c2]


def static_run(pkg, fn, grads=True):
    """Build ``fn`` over the feeds in ``pkg``, run the JAX startup values
    (carried into the port), return (program, fetched values, names)."""
    L = pkg.layers
    main, start = pkg.Program(), pkg.Program()
    with names_of(pkg).guard(), pkg.program_guard(main, start):
        x = L.data('x', [B, T, D], 'float32', append_batch_size=False)
        x.stop_gradient = False
        lens = L.data('lens', [B], 'int64', append_batch_size=False)
        h0 = [L.data(f'h{i}', [B, H], 'float32', append_batch_size=False)
              for i in range(2)]
        c0 = [L.data(f'c{i}', [B, H], 'float32', append_batch_size=False)
              for i in range(2)]
        outs = fn(L, x, lens, h0, c0)
        params = sorted(p.name for p in main.all_parameters())
        gs = []
        if grads:
            loss = L.reduce_sum(outs[0])
            gs = pkg.gradients([loss], [x] + [main.global_block().var(n)
                                              for n in params])
    return main, start, outs + gs, params


FEED = {'x': X, 'lens': LENS,
        **{f'h{i}': RNG.randn(B, H).astype(np.float32) for i in range(2)},
        **{f'c{i}': RNG.randn(B, H).astype(np.float32) for i in range(2)}}


def jax_values(fn, grads=True):
    main, start, fetch, params = static_run(jfluid, fn, grads)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in params}
    got = exe.run(main, feed=FEED, fetch_list=fetch, scope=scope)
    return main, init, [np.asarray(g) for g in got]


def port_values(fn, init, grads=True):
    main, start, fetch, params = static_run(fluid, fn, grads)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle(init, scope, fluid.CPUPlace(), program=main)
    return main, exe.run(main, feed=FEED, fetch_list=fetch, scope=scope)


def assert_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


STATIC = {name: (lambda L, x, lens, h0, c0, c=c, kw=kw:
                 run_cell_case(L, c, kw, x, lens))
          for name, (c, kw) in CELL_CASES.items()}
STATIC['birnn'] = lambda L, x, lens, h0, c0: birnn_case(L, x, lens)
STATIC['lstm'] = lambda L, x, lens, h0, c0: lstm_case(L, x, h0, c0)


@pytest.mark.parametrize('name', sorted(STATIC))
def test_static_matches_jax(name):
    jmain, init, want = jax_values(STATIC[name])
    tmain, got = port_values(STATIC[name], init)
    assert ops(tmain) == ops(jmain)
    assert_close(got, want)


def test_sequence_length_freezes_the_state_and_zeroes_the_outputs():
    _, init, _ = jax_values(STATIC['LSTMCell-lens'], grads=False)
    _, (out, h, c) = port_values(STATIC['LSTMCell-lens'], init, grads=False)
    for b, n in enumerate(LENS):
        np.testing.assert_array_equal(out[b, n:], 0.0)
        assert not np.allclose(out[b, :n], 0.0)
        np.testing.assert_allclose(h[b], out[b, n - 1], rtol=1e-6)


def test_rnn_over_grucell_matches_a_numpy_recurrence():
    const = fluid.ParamAttr(
        initializer=fluid.initializer.ConstantInitializer(0.1))
    zero = fluid.ParamAttr(
        initializer=fluid.initializer.ConstantInitializer(0.0))
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        xv = fluid.data('x', [B, T, D], 'float32')
        out, final = fluid.layers.rnn(
            fluid.layers.GRUCell(H, param_attr=const, bias_attr=zero), xv)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(start)
    out, final = exe.run(main, feed={'x': X}, fetch_list=[out, final])
    wg = np.full((D + H, 2 * H), 0.1, 'float32')
    wc = np.full((D + H, H), 0.1, 'float32')
    h = np.zeros((B, H), 'float32')
    for t in range(T):
        g = 1 / (1 + np.exp(-(np.concatenate([X[:, t], h], 1) @ wg)))
        u, r = g[:, :H], g[:, H:]
        c = np.tanh(np.concatenate([X[:, t], r * h], 1) @ wc)
        h = u * h + (1 - u) * c
        np.testing.assert_allclose(out[:, t], h, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final, h, rtol=2e-4, atol=2e-4)


def test_static_rnn_reusing_the_cell_matches_rnn():
    main, start = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, start):
        xv = fluid.data('x', [B, T, D], 'float32')
        cell = L.GRUCell(H, name='shared')
        out1, _ = L.rnn(cell, xv)
        xt = L.transpose(xv, perm=[1, 0, 2])
        srnn = L.StaticRNN()
        with srnn.step():
            w = srnn.step_input(xt)
            pre = srnn.memory(batch_ref=xv, shape=[-1, H],
                              ref_batch_dim_idx=0)
            _, new = cell.call(w, pre)
            srnn.update_memory(pre, new)
            srnn.step_output(new)
        out2 = L.transpose(srnn(), perm=[1, 0, 2])
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(start)
    a, b = exe.run(main, feed={'x': X}, fetch_list=[out1, out2])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_lstm_gives_its_default_initializer_to_the_cell_weights():
    L = fluid.layers
    main, start = fluid.Program(), fluid.Program()
    uniform = fluid.initializer.UniformInitializer(-0.5, 0.5)
    with fluid.program_guard(main, start):
        xt = L.data('xt', [T, B, D], 'float32', append_batch_size=False)
        L.lstm(xt, None, None, T, H, 2, default_initializer=uniform)
    inits = {op.outputs['Out'][0]: op.attrs['initializer']
             for op in start.global_block().ops}
    for name, init in inits.items():
        want = ('UniformInitializer' if name.endswith('.w_0')
                else 'ConstantInitializer')
        assert type(init).__name__ == want, name
    assert sum(n.endswith('.w_0') for n in inits) == 2
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(start)
    w = fluid.global_scope().find('lstm_l0_0.w_0').numpy()
    assert 0.3 < np.abs(w).max() <= 0.5


# ------------------------------------------------- dygraph

def dygraph_values(fn, init):
    """``fn`` under guard(CPUPlace()), each weight set to ``init`` by name
    as the cell makes it; its outputs and the gradients of reduce_sum of
    its first output."""
    # layers.rnn is the function; the module is by its full name
    rnn_mod = importlib.import_module('paddle_tpu_torch.layers.rnn')
    L = fluid.layers
    made = {}
    orig = rnn_mod._parameter

    def set_as_made(*a, **k):
        p = orig(*a, **k)
        assert isinstance(p, fluid.dygraph.Parameter)
        p.set_value(init[p.name].copy())
        made[p.name] = p
        return p

    rnn_mod._parameter = set_as_made
    try:
        with fluid.unique_name.guard(), fluid.dygraph.guard(fluid.CPUPlace()):
            feeds = {k: fluid.dygraph.to_variable(v) for k, v in FEED.items()}
            feeds['x'].stop_gradient = False
            outs = fn(L, feeds['x'], feeds['lens'],
                      [feeds['h0'], feeds['h1']], [feeds['c0'], feeds['c1']])
            assert sorted(made) == sorted(init)
            wrt = [feeds['x']] + [made[n] for n in sorted(made)]
            gs = torch.autograd.grad(L.reduce_sum(outs[0]), wrt,
                                     allow_unused=True)
            # a weight the first output does not reach: zeros, as the
            # static gradients give it
            return [o.numpy() for o in outs] + [
                np.zeros(w.shape, np.float32) if g is None else g.numpy()
                for g, w in zip(gs, wrt)]
    finally:
        rnn_mod._parameter = orig


DYGRAPH = ['GRUCell-lens', 'LSTMCell-plain', 'LSTMCell-reverse_lens',
           'GRUCell-time_major', 'birnn', 'lstm']


@pytest.mark.parametrize('name', DYGRAPH)
def test_dygraph_matches_jax_static(name):
    _, init, want = jax_values(STATIC[name])
    assert_close(dygraph_values(STATIC[name], init), want)
