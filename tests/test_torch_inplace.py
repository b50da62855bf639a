"""In-place state and early freeing in the port's executor (ROADMAP A.8f,
executor.py, core/scope.py), on the CPU.

- A value that left the executor keeps its contents after later runs: a
  fetched value (numpy or tensor), a persistable read through
  ``scope.find(...).numpy()`` or ``scope.var``, a fetched persistable, a
  feed that shares a persistable's memory. On the CPU a ``.numpy()`` shares
  the tensor's memory, so each of these would see an in-place write.
- In-place on and off give the same bits over three steps (Momentum, with
  a schedule's step counter and batch norm's running statistics).
- The state keeps its memory (``data_ptr``) from step to step where nothing
  was handed out; a handed-out tensor's successor is a new tensor, which
  the run after writes in place again.
- ``PADDLE_TPU_DONATE=0``, ``enable_inplace=False`` and
  ``memory_optimize=False`` each turn the in-place writes off.
- Two persistables sharing one tensor are not written in place.
- Early freeing lowers the plan's env high-water on a small program, and
  gives the same bits as a plan that frees nothing.
- A recompute program (checkpoints, dropout) with in-place writes, early
  freeing and the passes gives the bits of the plain program with all
  three off.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import executor
from paddle_tpu_torch.core.random import default_generator
from test_torch_static_recompute import batch as recompute_batch
from test_torch_static_recompute import build as recompute_build
import torch_jax_seed  # noqa: F401  (caps torch's threads)

CPU = fluid.CPUPlace()


def momentum_prog(depth=3, width=16):
    """An MLP with batch norm under Momentum on ``piecewise_decay`` (its
    int64 step counter is written by ``increment``)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data('x', [width], dtype='float32')
        y = L.data('y', [1], dtype='float32')
        h = x
        for _ in range(depth):
            h = L.batch_norm(L.fc(h, size=width), act='relu')
        pred = L.fc(h, size=1)
        loss = L.reduce_mean(L.square_error_cost(pred, y))
        lr = L.piecewise_decay([2], [0.1, 0.01])
        fluid.optimizer.Momentum(lr, momentum=0.9).minimize(loss)
    return main, startup, loss


def feed(step, width=16):
    rng = np.random.RandomState(step)
    return {'x': rng.randn(8, width).astype(np.float32),
            'y': rng.randn(8, 1).astype(np.float32)}


def persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def fresh(main, startup):
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope


def ptrs(scope, names):
    """Each persistable's memory, read without handing it out."""
    return {n: scope._find(n).data_ptr() for n in names}


def test_values_handed_out_keep_their_contents():
    main, startup, loss = momentum_prog()
    exe, scope = fresh(main, startup)
    w = main.all_parameters()[0].name
    velocity = next(n for n in persistables(main) if 'velocity' in n)
    found = scope.find(w).numpy()
    via_var = scope.var(velocity).numpy()
    found0, via_var0 = found.copy(), via_var.copy()
    got = exe.run(main, feed=feed(0), fetch_list=[loss, w], scope=scope)
    got0 = [g.copy() for g in got]
    tensors = exe.run(main, feed=feed(1), fetch_list=[loss, w],
                      scope=scope, return_numpy=False)
    tensors0 = [t.clone() for t in tensors]
    for s in range(2, 5):
        exe.run(main, feed=feed(s), fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(found, found0)
    np.testing.assert_array_equal(via_var, via_var0)
    for g, g0 in zip(got, got0):
        np.testing.assert_array_equal(g, g0)
    for t, t0 in zip(tensors, tensors0):
        assert torch.equal(t, t0)
    # and the state did move
    assert not np.array_equal(scope.find(w).numpy(), got0[1])
    assert not np.array_equal(scope.find(velocity).numpy(), via_var0)


def run_steps(monkeypatch, donate, bs=None, steps=3):
    """``steps`` steps of momentum_prog from startup seed 0: the fetched
    losses, the persistables after, and whether each step kept every
    persistable's memory."""
    if donate is None:
        monkeypatch.delenv('PADDLE_TPU_DONATE', raising=False)
    else:
        monkeypatch.setenv('PADDLE_TPU_DONATE', donate)
    main, startup, loss = momentum_prog()
    default_generator.seed(0)
    exe, scope = fresh(main, startup)
    names = persistables(main)
    prog = main if bs is None else fluid.CompiledProgram(
        main, build_strategy=bs)
    losses, kept = [], []
    for s in range(steps):
        before = ptrs(scope, names)
        losses.append(exe.run(prog, feed=feed(s), fetch_list=[loss],
                              scope=scope)[0])
        kept.append(ptrs(scope, names) == before)
    state = {n: scope._find(n).clone() for n in names}
    return losses, state, kept


def test_inplace_on_and_off_give_the_same_bits(monkeypatch):
    on = run_steps(monkeypatch, None)
    off = run_steps(monkeypatch, '0')
    for a, b in zip(on[0], off[0]):
        np.testing.assert_array_equal(a, b)
    for n in on[1]:
        assert torch.equal(on[1][n], off[1][n]), n
    assert on[2] == [True] * 3 and off[2] == [False] * 3


def test_state_memory_is_reused_until_handed_out():
    main, startup, loss = momentum_prog()
    exe, scope = fresh(main, startup)
    names = persistables(main)
    objs = {n: scope._find(n) for n in names}
    first = ptrs(scope, names)
    for s in range(3):
        exe.run(main, feed=feed(s), fetch_list=[loss], scope=scope)
    assert ptrs(scope, names) == first
    assert all(scope._find(n) is objs[n] for n in names)
    w = main.all_parameters()[0].name
    held = scope.find(w).numpy()
    held0 = held.copy()
    exe.run(main, feed=feed(3), fetch_list=[loss], scope=scope)
    after = ptrs(scope, names)
    assert after[w] != first[w]                 # a new tensor
    assert {n: p for n, p in after.items() if n != w} == {
        n: p for n, p in first.items() if n != w}
    exe.run(main, feed=feed(4), fetch_list=[loss], scope=scope)
    assert ptrs(scope, names) == after          # in place again
    np.testing.assert_array_equal(held, held0)


def inplace_off(bs_knob):
    bs = fluid.compiler.BuildStrategy()
    setattr(bs, bs_knob, False)
    return bs


@pytest.mark.parametrize('switch', ['PADDLE_TPU_DONATE=0',
                                    'enable_inplace=False',
                                    'memory_optimize=False'])
def test_each_switch_turns_inplace_off(switch, monkeypatch):
    if switch.startswith('PADDLE'):
        got = run_steps(monkeypatch, '0')
    else:
        got = run_steps(monkeypatch, None, inplace_off(switch.split('=')[0]))
    assert got[2] == [False] * 3
    # and a CompiledProgram with the knobs unset or True keeps it on
    bs = fluid.compiler.BuildStrategy()
    bs.enable_inplace = True
    assert run_steps(monkeypatch, None, bs)[2] == [True] * 3
    assert run_steps(monkeypatch, None,
                     fluid.compiler.BuildStrategy())[2] == [True] * 3


def test_a_fetched_persistable_and_a_shared_tensor_stay_apart(monkeypatch):
    """A fetched persistable is not written in place (its successor is
    fresh), and neither are two persistables that share one tensor; the
    values equal the run with in-place off."""
    got = {}
    for donate in (None, '0'):
        if donate is None:
            monkeypatch.delenv('PADDLE_TPU_DONATE', raising=False)
        else:
            monkeypatch.setenv('PADDLE_TPU_DONATE', donate)
        main, startup, loss = momentum_prog()
        default_generator.seed(0)
        exe, scope = fresh(main, startup)
        # batch_norm_0's scale and shift velocities, both (16,) zeros
        v0, v1 = [n for n in persistables(main) if 'velocity' in n][:2]
        shared = scope._find(v0).clone()
        scope._put(v0, shared)
        scope._put(v1, shared)
        w = main.all_parameters()[0].name
        fetched = exe.run(main, feed=feed(0), fetch_list=[w], scope=scope,
                          return_numpy=False)[0]
        assert scope._find(v0) is not shared
        assert scope._find(v1) is not shared
        assert scope._find(w) is fetched
        snap = fetched.clone()
        exe.run(main, feed=feed(1), fetch_list=[loss], scope=scope)
        assert torch.equal(fetched, snap)
        got[donate] = {n: scope._find(n).clone() for n in persistables(main)}
    for n in got[None]:
        assert torch.equal(got[None][n], got['0'][n]), n


def test_a_feed_sharing_a_persistable_keeps_its_contents():
    main, startup, loss = momentum_prog()
    exe, scope = fresh(main, startup)
    # the step counter is a persistable a program can also be fed
    counter = next(n for n in persistables(main)
                   if n.startswith('lr_decay_counter'))
    main.global_block().var(counter).is_data = True
    fed = scope._find(counter)
    fed0 = fed.clone()
    exe.run(main, feed={**feed(0), counter: fed}, fetch_list=[loss],
            scope=scope)
    assert torch.equal(fed, fed0)


def test_early_freeing_lowers_the_env_high_water(monkeypatch):
    """A deeper MLP: the plan's env high-water with early freeing against
    the same plan freeing nothing, and the same bits from both."""
    out = {}
    for free in (True, False):
        if not free:
            monkeypatch.setattr(executor, '_free_lists',
                                lambda touched, keep: [()] * len(touched))
        main, startup, loss = momentum_prog(depth=6, width=64)
        default_generator.seed(0)
        exe, scope = fresh(main, startup)
        exe._watch_env = True
        losses = [exe.run(main, feed=feed(s, 64), fetch_list=[loss],
                          scope=scope)[0] for s in range(2)]
        out[free] = (exe._env_high_water(main), losses,
                     {n: scope._find(n).clone() for n in persistables(main)})
    (hw_free, l_free, s_free), (hw_all, l_all, s_all) = out[True], out[False]
    assert 0 < hw_free < hw_all, (hw_free, hw_all)
    for a, b in zip(l_free, l_all):
        np.testing.assert_array_equal(a, b)
    for n in s_free:
        assert torch.equal(s_free[n], s_all[n]), n


def test_a_recompute_program_gives_its_values(monkeypatch):
    """RecomputeOptimizer with dropout, with in-place writes, early
    freeing and the passes on, against the plain program with all three
    off: three steps' fetches and state bit for bit."""
    got = []
    for remat, env in ((True, {'PADDLE_TPU_PASSES': '1'}),
                       (False, {'PADDLE_TPU_PASSES': '0',
                                'PADDLE_TPU_DONATE': '0'})):
        monkeypatch.delenv('PADDLE_TPU_DONATE', raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        if not remat:
            monkeypatch.setattr(executor, '_free_lists',
                                lambda touched, keep: [()] * len(touched))
        main, startup, loss, _, _ = recompute_build(fluid, remat,
                                                    dropout=0.5)
        default_generator.seed(0)
        exe, scope = fresh(main, startup)
        params = [p.name for p in main.all_parameters()]
        fetch = [loss.name] + [n + '@GRAD' for n in params]
        bs = fluid.compiler.BuildStrategy()
        bs.fuse_elewise_add_act_ops = bs.fuse_all_optimizer_ops = True
        prog = fluid.CompiledProgram(main, build_strategy=bs)
        out = [exe.run(prog, feed=recompute_batch(s), fetch_list=fetch,
                       scope=scope) for s in range(3)]
        got.append((out, {n: scope._find(n).clone()
                          for n in persistables(main)}))
    (a, sa), (b, sb) = got
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert sa.keys() == sb.keys()
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n
