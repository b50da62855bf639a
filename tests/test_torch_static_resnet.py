"""PaddleCV's static ResNet recipe (paddle_tpu_torch/tools/static_resnet.py)
built by both packages and trained through the port's ``CompiledProgram``
against the JAX package's Executor, on the CPU.

Size: ``blocks=[1, 1, 1, 1]`` (one bottleneck a stage), ``width_div=16``,
10 classes, 32x32 images, batch 4 of ``numpy.random.RandomState`` data;
the recipe's optimizer (Momentum 0.9 on ``piecewise_decay`` from 0.1,
L2Decay 1e-4). The JAX side runs its plain Executor: its
``with_data_parallel`` would shard a batch of 4 over the 8 virtual CPU
devices that tests/conftest.py sets up.

- The train, startup and test programs hold the same ops (slots and
  attrs) and variables (names, shapes, types, persistability) in both.
- From the JAX startup values (``convert.scope_from_paddle``), the first
  step's loss within rtol 1e-5, top-1 and top-5 equal, each parameter's
  update within 1e-3 of the reference's relative to its norm (measured
  2.7e-5).
- At lr 0.1 on 4 images the steps leave the linear regime (the loss moves
  by a unit) and the trajectory is chaotic in both packages, as
  tests/test_torch_resnet.py documents for its ResNet-50. So each f32 run
  is measured against a float64 witness: the port's train and test
  programs cloned to float64 (``tools/witness.as_float64``) and run from
  the same startup values on the same batches. After each step the loss
  and each kind of state taken whole (the L2 norm over the parameters,
  over the velocities, over the BN running statistics) of the port lie
  no further from the witness than twice the JAX package's distance from
  it, plus a floor: 1e-6 of the witness's value after the first step;
  after a later step, what the witness itself moved in that step, since
  from the second step on either package's f32 run can cross a ReLU near
  tie that the other does not (JAX seed 5: one pre-activation of 2.7e-5
  at ``res4a``'s residual add changes sign in the port's f32 second step
  and in neither other run; the port then lies 12x the JAX package's
  distance from the witness; at seed 6 the JAX package is 8x the port's).
  A first step whose update is 0.9x the port's reads 570-8377x its bound
  (JAX seeds 0-9); the port reads at most 0.59 of its bounds there.
  Top-1 and top-5 are compared as counts: equal to the JAX package's or
  to the witness's.
- The test program's logits (running statistics, no backward, no step
  counter) from the JAX startup values: atol 1e-5, rtol 1e-4; after the
  three steps, max |diff| from the witness's within twice the JAX
  package's plus what the witness's logits moved over the three steps.
- The JAX package's seed is pinned to 0 for each test
  (tests/torch_jax_seed.py): its startup values come from a process-wide
  generator that other test files seed.
- One lowering of the train program for the three steps; the rate
  fetched each step is ``piecewise_decay``'s. With the boundaries moved to
  steps 2, 4 and 6, eight steps fetch each of the four rates twice, the
  counter reads 7 and the test program leaves it alone.
"""
import functools

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.tools import static_resnet
from paddle_tpu_torch.tools.witness import as_float64
from torch_jax_seed import jax_seed_pinned  # noqa: F401

KW = dict(class_dim=10, image_shape=(3, 32, 32), blocks=[1, 1, 1, 1],
          width_div=16)
BATCH, STEPS = 4, 3


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


def batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS + 1):
        x = rng.standard_normal((BATCH,) + KW['image_shape']).astype(
            np.float32)
        y = rng.randint(0, KW['class_dim'], (BATCH, 1)).astype(np.int64)
        out.append({'image': x, 'label': y})
    return out


def build(pkg):
    from paddle_tpu.core import unique_name as jnames
    from paddle_tpu_torch.core import unique_name as tnames
    names = jnames if pkg is jfluid else tnames
    with names.guard():
        return static_resnet.build(pkg, **KW)


def persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


@functools.lru_cache(maxsize=None)
def jax_run():
    """The reference's startup values and its three steps: (start, [per
    step: fetches, state], test-program logits before and after)."""
    main, startup, test, v = build(jfluid)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    names = persistables(main)
    start = {n: np.asarray(scope.find(n)) for n in names}
    data = batches()
    fetch = [v['loss'], v['acc1'], v['acc5'], v['lr']]
    eval_before = np.asarray(exe.run(test, feed=data[-1],
                                     fetch_list=[v['logits']],
                                     scope=scope)[0])
    steps = []
    for feed in data[:STEPS]:
        out = [np.asarray(o) for o in exe.run(main, feed=feed,
                                              fetch_list=fetch, scope=scope)]
        steps.append((out, {n: np.asarray(scope.find(n)) for n in names}))
    eval_after = np.asarray(exe.run(test, feed=data[-1],
                                    fetch_list=[v['logits']],
                                    scope=scope)[0])
    return start, steps, eval_before, eval_after


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items()
              if k != 'initializer' and not isinstance(v, np.ndarray)})
            for op in program.global_block().ops]


def _vars(program):
    return [(v.name, v.shape, v.dtype, v.persistable, v.is_data,
             type(v).__name__) for v in program.list_vars()]


@pytest.mark.parametrize('which', ['train', 'startup', 'test'])
def test_programs_match_jax(which):
    idx = {'train': 0, 'startup': 1, 'test': 2}[which]
    jp, tp = build(jfluid)[idx], build(fluid)[idx]
    assert _ops(tp) == _ops(jp)
    assert _vars(tp) == _vars(jp)
    types = [op.type for op in tp.global_block().ops]
    if which == 'test':
        assert '__backward__' not in types and 'increment' not in types
        assert not any(n.startswith('lr_decay_counter')
                       for n in persistables(tp))
    if which == 'startup':
        for jop, top in zip(jp.global_block().ops, tp.global_block().ops):
            assert (type(top.attrs['initializer']).__name__
                    == type(jop.attrs['initializer']).__name__)


def test_full_depth_has_the_published_size():
    main = static_resnet.build(fluid)[0]
    n = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    assert n == 25557032          # ResNet-50 at 1000 classes
    assert sum(op.type == 'conv2d' for op in main.global_block().ops) == 53


def port_run():
    """The port's three steps through CompiledProgram from the
    reference's startup values."""
    main, startup, test, v = build(fluid)
    start = jax_run()[0]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({n: a.astype(main.global_block().var(n).dtype)
                       for n, a in start.items()}, scope, fluid.CPUPlace(),
                      program=main)
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    data = batches()
    fetch = [v['loss'], v['acc1'], v['acc5'], v['lr']]
    eval_before = exe.run(test, feed=data[-1], fetch_list=[v['logits']],
                          scope=scope)[0]
    steps = []
    for feed in data[:STEPS]:
        out = exe.run(step, feed=feed, fetch_list=fetch, scope=scope)
        steps.append((out, {n: scope.find(n).numpy() for n in start}))
    eval_after = exe.run(test, feed=data[-1], fetch_list=[v['logits']],
                         scope=scope)[0]
    return exe, main, steps, eval_before, eval_after


def witness_run(start):
    """The witness: the port's train and test programs cloned to float64
    (``as_float64``), run from the same startup values on the same three
    batches on the CPU. Returns ([per step: fetches, state], test-program
    logits before and after)."""
    main, startup, test, v = build(fluid)
    main64, test64 = as_float64(main), as_float64(test)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({n: a.astype(main64.global_block().var(n).dtype)
                       for n, a in start.items()}, scope, fluid.CPUPlace(),
                      program=main64)
    step = fluid.CompiledProgram(main64).with_data_parallel(
        loss_name=v['loss'].name)
    data = batches()
    fetch = [v['loss'], v['acc1'], v['acc5'], v['lr']]
    eval_before = exe.run(test64, feed=data[-1], fetch_list=[v['logits']],
                          scope=scope)[0]
    steps = []
    for feed in data[:STEPS]:
        out = exe.run(step, feed=feed, fetch_list=fetch, scope=scope)
        steps.append((out, {n: scope.find(n).numpy() for n in start}))
    eval_after = exe.run(test64, feed=data[-1], fetch_list=[v['logits']],
                         scope=scope)[0]
    return steps, eval_before, eval_after


def norm(arrays):
    """The L2 norm of a set of arrays taken together, in f64."""
    return np.sqrt(sum(float(np.sum(np.square(a, dtype=np.float64)))
                       for a in arrays.values()))


def state_kinds(main, names):
    """The persistables by kind, as tests/test_torch_resnet.py holds them:
    parameters, Momentum's velocities, BatchNorm's running statistics."""
    params = {p.name for p in main.all_parameters()}
    kinds = {'parameters': [], 'velocities': [], 'running statistics': []}
    for n in names:
        if n in params:
            kinds['parameters'].append(n)
        elif '_velocity_' in n:
            kinds['velocities'].append(n)
        elif n.endswith(('_mean', '_variance')):
            kinds['running statistics'].append(n)
    return kinds


def witness_readings(kinds, start, got, want, wit, evals):
    """(what, port's distance from the witness, bound) of every witness
    check: after each step, the loss and each kind of state taken whole
    (L2 over its tensors); after the three steps, the test program's
    logits (max |diff|). The bound is twice the JAX package's distance
    from the witness plus a floor: 1e-6 of the witness's value after the
    first step; after a later one, what the witness itself moved in that
    step, since from the second step on either f32 run can cross a ReLU
    near tie that the other does not (ROADMAP C.11); for the logits, what
    the witness's logits moved over the three steps."""
    out = []
    prev = start
    for s in range(STEPS):
        g, w, x = got[s][1], want[s][1], wit[s][1]
        gl, wl, xl = (float(np.asarray(r[s][0][0]).reshape(-1)[0])
                      for r in (got, want, wit))
        if s == 0:
            floor_loss = 1e-6 * abs(xl)
        else:
            floor_loss = abs(xl - float(np.asarray(wit[s - 1][0][0])
                                        .reshape(-1)[0]))
        out.append((f'loss {s}', abs(gl - xl),
                    2 * abs(wl - xl) + floor_loss))
        for kind, names in kinds.items():
            floor = (1e-6 * norm({n: x[n] for n in names}) if s == 0 else
                     norm({n: x[n] - prev[n] for n in names}))
            out.append((f'{kind} {s}', norm({n: g[n] - x[n] for n in names}),
                        2 * norm({n: w[n] - x[n] for n in names}) + floor))
        prev = x
    got_eval, jax_eval, wit_before, wit_after = evals
    out.append(('eval logits', np.abs(got_eval - wit_after).max(),
                2 * np.abs(jax_eval - wit_after).max()
                + np.abs(wit_after - wit_before).max()))
    return out


def test_three_compiled_steps_match_jax():
    start, want, jeval0, jeval1 = jax_run()
    exe, main, got, eval0, eval1 = port_run()
    wit, weval0, weval1 = witness_run(start)
    assert exe.lowering_count(main) == 1
    # the first step: tight
    (g_out, g_state), (w_out, w_state) = got[0], want[0]
    np.testing.assert_allclose(g_out[0], w_out[0], rtol=1e-5)
    for k in (1, 2):
        assert float(g_out[k]) == float(w_out[k])
    for n in start:
        if n.startswith('lr_decay_counter'):
            continue
        du = (g_state[n] - start[n]) - (w_state[n] - start[n])
        moved_by = np.linalg.norm(w_state[n] - start[n])
        if moved_by > 0:
            assert np.linalg.norm(du) <= 1e-3 * moved_by, n
    # every step: the rate, the counter, top-1 and top-5 counts
    for s in range(STEPS):
        (g_out, g_state), (w_out, w_state) = got[s], want[s]
        np.testing.assert_allclose(g_out[3], w_out[3], rtol=1e-7)
        np.testing.assert_allclose(g_out[3], 0.1, rtol=1e-7)
        for k in (1, 2):
            assert float(g_out[k]) in (float(w_out[k]),
                                       float(wit[s][0][k])), (s, k)
        for n in start:
            if n.startswith('lr_decay_counter'):
                assert int(g_state[n][0]) == s
    np.testing.assert_allclose(eval0, jeval0, atol=1e-5, rtol=1e-4)
    # the state, the loss and the logits against the float64 witness
    kinds = state_kinds(main, start)
    evals = (eval1, jeval1, weval0, weval1)
    for what, reading, bound in witness_readings(kinds, start, got, want,
                                                 wit, evals):
        assert reading <= bound, (what, reading, bound)
    # a first step whose update is 0.9x the port's fails the check
    wrong = [(got[0][0], {n: start[n] + 0.9 * (got[0][1][n] - start[n])
                          for n in start})] + got[1:]
    failed = {what for what, reading, bound in witness_readings(
        kinds, start, wrong, want, wit, evals) if reading > bound}
    assert {'parameters 0', 'velocities 0'} <= failed, failed


def test_the_rate_follows_the_schedule_across_its_boundaries(monkeypatch):
    # the recipe's boundaries (epochs 30, 60, 90 of ImageNet) moved to
    # steps 2, 4 and 6, so that eight steps cross all three
    monkeypatch.setattr(static_resnet, 'BOUNDARIES', [2, 4, 6])
    main, startup, test, v = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    feed = batches()[0]
    rates = []
    for _ in range(8):
        rates.append(float(exe.run(step, feed=feed, fetch_list=[v['lr']])[0]
                           [0]))
        exe.run(test, feed=feed, fetch_list=[v['prob']])  # no counter here
    # the test program never moves the counter
    np.testing.assert_allclose(
        rates, np.repeat(static_resnet.VALUES, 2), rtol=1e-7)
    np.testing.assert_allclose(rates[::2], [0.1, 0.01, 0.001, 0.0001],
                               rtol=1e-6)
    assert int(fluid.global_scope().find(
        'lr_decay_counter_0').numpy()[0]) == 7
    assert exe.lowering_count(main) == 1
