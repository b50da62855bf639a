"""PaddleNLP's PTB LSTM language model (paddle_tpu_torch/tools/
static_ptb_lm.py) built by both packages and trained through the port's
``CompiledProgram`` against the JAX package's Executor, on the CPU, by
both routes (``padding``: ``StaticRNN``; ``static``: ``layers.lstm``).

Size: vocabulary 50, hidden 16, 2 layers, 5 steps, batch 4;
``numpy.random.RandomState`` ids and initial states; the JAX package's
startup values carried across by name.

- The train, startup and test programs hold the same ops in every block
  (slots, attrs) and variables in both; the startup programs' initializers
  are the same kinds, except ``lstm``'s weights, which take the recipe's
  ``default_initializer`` in the port and Xavier in the JAX package (which
  leaves the argument unused). At ``LARGE`` both routes have the model's
  66,022,000 parameters.
- Dropout off: the first step's loss within 1e-5 relative, every gradient
  within 1e-5 of its largest entry; then 3 SGD steps with the global-norm
  clip and the schedule, each feeding the fetched ``last_hidden`` and
  ``last_cell`` back: losses within 1e-5 relative, fetched states and
  every parameter after each step within 1e-5 of its largest entry; the
  last loss below the first where the JAX package's is (three different
  batches: at some JAX seeds, 1 and 6 of 0-9, the loss rises in both
  packages). One lowering of the train program.
- The rate: ``piecewise_decay``'s, also across boundaries moved to steps 2
  and 4.
- Dropout on (0.65, ``upscale_in_train``): the mask of the step's last
  output differs between time steps and between runs, keeps a share of
  entries within 0.1 of 0.35 (320 entries a run: 4 standard deviations),
  and scales what it keeps by 1 / 0.35.
- The inference model the port saves (the test program pruned to the loss
  and last states) runs in the JAX package and gives the port's values.
  The other way does not run: the JAX package's prune drops the weights
  that only the step block reads (ROADMAP C.10).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.tools import static_ptb_lm
from torch_jax_seed import jax_seed_pinned  # noqa: F401

KW = dict(vocab_size=50, hidden_size=16, num_layers=2, num_steps=5,
          batch_size=4, dropout=0.0)
ROUTES = ['padding', 'static']
STEPS = 3
RTOL = 1e-5


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


def build(pkg, route, **kw):
    from paddle_tpu.core import unique_name as jnames
    from paddle_tpu_torch.core import unique_name as tnames
    with (jnames if pkg is jfluid else tnames).guard():
        return static_ptb_lm.build(pkg, route, **{**KW, **kw})


def batches(n=STEPS):
    rng = np.random.RandomState(0)
    b, s, v, h = (KW['batch_size'], KW['num_steps'], KW['vocab_size'],
                  KW['hidden_size'])
    out = [{'x': rng.randint(0, v, (b, s, 1)).astype(np.int64),
            'y': rng.randint(0, v, (b * s, 1)).astype(np.int64)}
           for _ in range(n)]
    state = rng.standard_normal((2, KW['num_layers'], b, h)).astype(
        np.float32) * 0.1
    return out, state[0], state[1]


def _ops(program):
    return [(b.idx, b.parent_idx, op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items()
              if k != 'initializer' and not isinstance(v, np.ndarray)})
            for b in program.blocks for op in b.ops]


def _vars(program):
    return [(b.idx, v.name, v.shape, v.dtype, v.persistable, v.is_data,
             type(v).__name__) for b in program.blocks
            for v in b.vars.values()]


@pytest.mark.parametrize('route', ROUTES)
def test_programs_match_jax(route):
    jp, tp = build(jfluid, route), build(fluid, route)
    for idx in range(3):
        assert _ops(tp[idx]) == _ops(jp[idx]), idx
        assert _vars(tp[idx]) == _vars(jp[idx]), idx
    types = {op.type for b in tp[0].blocks for op in b.ops}
    assert '__scan__' in types and 'sgd' in types
    assert len(tp[0].blocks) == (2 if route == 'padding' else 3)
    for jop, top in zip(jp[1].global_block().ops, tp[1].global_block().ops):
        want = type(jop.attrs['initializer']).__name__
        got = type(top.attrs['initializer']).__name__
        if route == 'static' and top.outputs['Out'][0].endswith('.w_0'):
            assert (want, got) == ('XavierInitializer', 'UniformInitializer')
        else:
            assert got == want
    test_types = [op.type for b in tp[2].blocks for op in b.ops]
    assert '__backward__' not in test_types and 'sgd' not in test_types


@pytest.mark.parametrize('route', ROUTES)
def test_large_has_the_published_size(route):
    main = static_ptb_lm.build(fluid, route)[0]
    n = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    assert n == 66022000
    assert static_ptb_lm.EPOCH_SIZE == 1327
    assert len(static_ptb_lm.BOUNDARIES) == 54
    np.testing.assert_allclose(static_ptb_lm.VALUES[:14], 1.0)
    np.testing.assert_allclose(static_ptb_lm.VALUES[14], 1 / 1.15)


def jax_run(route):
    main, startup, test, v = build(jfluid, route)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    persist = sorted(x.name for x in main.list_vars() if x.persistable)
    start = {n: np.asarray(scope.find(n)) for n in persist}
    params = sorted(p.name for p in main.all_parameters())
    return main, exe, scope, v, start, params


def train(pkg, exe, step, scope, v, params, first_fetch):
    data, h, c = batches()
    out = []
    for i, feed in enumerate(data):
        feed = {**feed, 'init_hidden': h, 'init_cell': c}
        fetch = [v['loss'], v['last_hidden'], v['last_cell'], v['lr']]
        if i == 0:
            fetch += first_fetch
        got = [np.asarray(g) for g in exe.run(step, feed=feed,
                                              fetch_list=fetch, scope=scope)]
        h, c = got[1], got[2]
        out.append((got, {n: np.asarray(scope.find(n) if pkg is jfluid
                                        else scope.find(n).numpy())
                          for n in params}))
    return out


def close_to_largest(got, want, what):
    err = np.abs(got - want).max()
    assert err <= RTOL * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize('route', ROUTES)
def test_three_steps_match_jax(route):
    jmain, jexe, jscope, jv, start, params = jax_run(route)
    grads = [n + '@GRAD' for n in params]
    want = train(jfluid, jexe, jmain, jscope, jv, params, grads)
    main, startup, test, v = build(fluid, route)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({n: a.astype(main.global_block().var(n).dtype)
                       for n, a in start.items()}, scope, fluid.CPUPlace(),
                      program=main)
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    got = train(fluid, exe, step, scope, v, params, grads)
    assert exe.lowering_count(main) == 1
    (g_first, _), (w_first, _) = got[0], want[0]
    for n, g, w in zip(grads, g_first[4:], w_first[4:]):
        assert np.abs(w).max() > 0, n
        close_to_largest(g, w, n)
    for s, ((g_out, g_state), (w_out, w_state)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g_out[0], w_out[0], rtol=RTOL)
        np.testing.assert_allclose(g_out[3], 1.0, rtol=1e-7)
        for k, what in ((1, 'last_hidden'), (2, 'last_cell')):
            close_to_largest(g_out[k], w_out[k], f'{what} {s}')
        for n in params:
            assert not np.array_equal(w_state[n], start[n]), n
            close_to_largest(g_state[n], w_state[n], f'{n} {s}')
    # the loss moves the reference's way over the three batches
    assert ((got[-1][0][0] < got[0][0][0])
            == (want[-1][0][0] < want[0][0][0]))


def test_the_rate_follows_the_schedule_across_moved_boundaries(monkeypatch):
    monkeypatch.setattr(static_ptb_lm, 'BOUNDARIES', [2, 4])
    monkeypatch.setattr(static_ptb_lm, 'VALUES', [1.0, 0.5, 0.25])
    main, startup, test, v = build(fluid, 'padding')
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    data, h, c = batches(6)
    rates = [float(exe.run(step, feed={**f, 'init_hidden': h,
                                       'init_cell': c},
                           fetch_list=[v['lr']])[0][0]) for f in data]
    assert rates == [1.0, 1.0, 0.5, 0.5, 0.25, 0.25]
    assert exe.lowering_count(main) == 1


def test_dropout_masks_move_between_steps_and_keep_their_share():
    p = 0.65
    main, startup, test, v = build(fluid, 'padding', dropout=p)
    scan = next(op for op in main.global_block().ops
                if op.type == '__scan__')
    dropped, last_m = scan.outputs['Out'][-1], scan.outputs['Out'][-3]
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    data, h, c = batches(2)
    runs = [exe.run(main, feed={**f, 'init_hidden': h, 'init_cell': c},
                    fetch_list=[dropped, last_m]) for f in data[:1] * 2]
    masks = [r[0] != 0 for r in runs]
    for (out, m), mask in zip(runs, masks):
        assert not np.array_equal(mask[0], mask[1])
        assert abs(mask.mean() - (1 - p)) < 0.1, mask.mean()
        np.testing.assert_allclose(out[mask], m[mask] / (1 - p), rtol=1e-6)
    assert not np.array_equal(masks[0], masks[1])
    # the test program keeps every entry, unscaled
    out, m = exe.run(test, feed={**data[0], 'init_hidden': h,
                                 'init_cell': c},
                     fetch_list=[dropped, last_m])
    np.testing.assert_array_equal(out, m)


def test_the_saved_inference_model_runs_in_jax(tmp_path):
    main, startup, test, v = build(fluid, 'padding')
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    data, h, c = batches(1)
    feed = {**data[0], 'init_hidden': h, 'init_cell': c}
    targets = [v['loss'], v['last_hidden'], v['last_cell']]
    want = exe.run(test, feed=feed, fetch_list=targets)
    fluid.io.save_inference_model(str(tmp_path), list(feed), targets, exe,
                                  main_program=main)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        prog, feeds, fetches = jfluid.io.load_inference_model(str(tmp_path),
                                                              jexe)
        got = jexe.run(prog, feed=feed, fetch_list=fetches)
    assert sorted(feeds) == sorted(feed)
    assert '__scan__' in {op.type for op in prog.global_block().ops}
    for g, w in zip(got, want):
        close_to_largest(np.asarray(g), w, 'inference')
