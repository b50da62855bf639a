"""Recompute in the port's static graph (``append_backward(checkpoints=)``,
``optimizer.RecomputeOptimizer``, executor.py's segments), on the CPU.

- The port with checkpoints against the port without, on the JAX
  package's ``tests/framework/test_static_autodiff.py`` MLP (three ``fc``
  blocks, each output a checkpoint) with dropout 0.5 after each block:
  three SGD steps give the same losses, gradients and parameters bit for
  bit (the recomputed segments draw the masks the first run drew), and
  the generator's next draw is the same afterwards. The cut static
  ResNet-50 (``tools/static_resnet.py``, checkpoints at the bottleneck
  outputs) keeps every persistable bit for bit over two steps, its
  running statistics (written inside recomputed segments) included.
- The port against the JAX package's ``RecomputeOptimizer`` with dropout
  off, from the JAX startup values: the same marker (its checkpoint names)
  and the same segments (the JAX package's ``_remat_segments`` on the
  same op list); the first step's loss within rtol 1e-5 and gradients
  within atol 1e-6 / rtol 1e-4, three steps' losses within rtol 1e-5 and
  atol 1e-6 (the JAX package's own recompute test's tolerance).
- A fetch of a variable inside a segment that no later op reads still
  comes back (the fetches stay live).
- A persistable that a recomputed segment reads and a later segment
  overwrites (an in-place ``increment``) is recomputed from the value the
  first run read: three steps' losses, gradients and state equal the
  plain run's bit for bit.
- ``_set_checkpoints`` and ``minimize`` raise the reference's errors, word
  for word: not a list, an entry neither a Variable nor a name, a name
  twice, a name the program does not declare.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.executor import _remat_segments as jax_segments
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.core.random import default_generator
from paddle_tpu_torch.executor import _remat_segments
from paddle_tpu_torch.tools import static_resnet
from torch_jax_seed import jax_seed_pinned  # noqa: F401

STEPS = 3


def mlp(pkg, dropout=0.0, n_blocks=3):
    """The JAX package's ``_deep_mlp_with_checkpoints``, with dropout
    after each block when ``dropout`` > 0."""
    L = pkg.layers
    x = L.data('x', [8], dtype='float32')
    label = L.data('y', [1], dtype='float32')
    h, ckpts = x, []
    for _ in range(n_blocks):
        h = L.fc(h, size=8, act='tanh')
        if dropout:
            h = L.dropout(h, dropout_prob=dropout)
        ckpts.append(h)
    pred = L.fc(h, size=1)
    loss = L.reduce_mean(L.square_error_cost(pred, label))
    return loss, ckpts, pred


def build(pkg, recompute, dropout=0.0):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss, ckpts, pred = mlp(pkg, dropout)
        sgd = pkg.optimizer.SGD(learning_rate=0.1)
        if recompute:
            opt = pkg.optimizer.RecomputeOptimizer(sgd)
            opt._set_checkpoints(ckpts)
            opt.minimize(loss)
        else:
            sgd.minimize(loss)
    return main, startup, loss, ckpts, pred


def batch(seed):
    rng = np.random.RandomState(seed)
    return {'x': rng.randn(4, 8).astype(np.float32),
            'y': rng.randn(4, 1).astype(np.float32)}


def port_run(main, startup, loss, steps=STEPS, extra=()):
    """``steps`` steps on a fresh scope from generator seed 0: each step's
    fetches (loss, gradients, ``extra``), the persistables after, and the
    generator's next draw."""
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    default_generator.seed(0)
    exe.run(startup, scope=scope)
    params = [p.name for p in main.all_parameters()]
    fetch = [loss.name] + [n + '@GRAD' for n in params] + list(extra)
    out = [exe.run(main, feed=batch(s), fetch_list=fetch, scope=scope)
           for s in range(steps)]
    state = {v.name: scope.find(v.name).clone() for v in main.list_vars()
             if v.persistable}
    nxt = torch.rand(4, generator=default_generator.generator(
        torch.device('cpu')))
    return out, state, nxt, exe.lowering_count(main)


def test_recompute_equals_the_plain_run_with_dropout_bit_for_bit():
    plain = port_run(*(lambda m, s, l, c, p: (m, s, l))(
        *build(fluid, False, dropout=0.5)))
    remat = port_run(*(lambda m, s, l, c, p: (m, s, l))(
        *build(fluid, True, dropout=0.5)))
    for a, b in zip(plain[0], remat[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert plain[1].keys() == remat[1].keys()
    for n in plain[1]:
        assert torch.equal(plain[1][n], remat[1][n]), n
    assert torch.equal(plain[2], remat[2])
    assert remat[3] == 1
    # dropout drew: two steps' losses on one batch would differ
    assert len({float(r[0]) for r in remat[0]}) == STEPS


def test_recompute_keeps_a_fetched_intermediate():
    main, startup, loss, ckpts, pred = build(fluid, True)
    inner = main.global_block().ops[0].outputs['Out'][0]   # fc's mul
    out, _, _, _ = port_run(main, startup, loss, steps=1,
                            extra=[inner, pred.name])
    plain = port_run(*build(fluid, False)[:3], steps=1,
                     extra=[inner, pred.name])[0]
    np.testing.assert_array_equal(out[0][-2], plain[0][-2])
    np.testing.assert_array_equal(out[0][-1], plain[0][-1])


def build_overwritten(recompute):
    """An MLP whose first block is scaled by a persistable ``c`` that a
    later block increments in place; both blocks' outputs checkpoints."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data('x', [8], dtype='float32')
        label = L.data('y', [1], dtype='float32')
        c = L.create_global_var([1], 2.0, 'float32', persistable=True,
                                name='c')
        h1 = L.elementwise_mul(L.fc(x, size=8, act='tanh'), c)
        L.increment(c, 1.0)
        h2 = L.fc(h1, size=8, act='tanh')
        loss = L.reduce_mean(L.square_error_cost(L.fc(h2, size=1), label))
        sgd = fluid.optimizer.SGD(learning_rate=0.1)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(sgd)
            opt._set_checkpoints([h1, h2])
            opt.minimize(loss)
        else:
            sgd.minimize(loss)
    return main, startup, loss


def test_recompute_reads_a_later_overwritten_persistable_as_first_read():
    plain = port_run(*build_overwritten(False))
    remat = port_run(*build_overwritten(True))
    for a, b in zip(plain[0], remat[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert plain[1].keys() == remat[1].keys()
    for n in plain[1]:
        assert torch.equal(plain[1][n], remat[1][n]), n
    assert float(remat[1]['c']) == 2.0 + STEPS


def test_recompute_keeps_the_resnet_state_bit_for_bit():
    cut = dict(class_dim=10, image_shape=(3, 32, 32), blocks=[1, 1, 1, 1],
               width_div=16)
    rng = np.random.RandomState(0)
    feed = {'image': rng.randn(4, 3, 32, 32).astype(np.float32),
            'label': rng.randint(0, 10, (4, 1)).astype(np.int64)}
    states = []
    for recompute in (False, True):
        with fluid.unique_name.guard():
            main, startup, _, v = static_resnet.build(
                fluid, recompute=recompute, **cut)
        marker = next(op for op in main.global_block().ops
                      if op.type == '__backward__')
        assert marker.attrs['checkpoints'] == (
            [c.name for c in v['checkpoints']] if recompute else [])
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        default_generator.seed(0)
        exe.run(startup, scope=scope)
        losses = [exe.run(main, feed=feed, fetch_list=[v['loss']],
                          scope=scope)[0] for _ in range(2)]
        states.append((losses, {x.name: scope.find(x.name).clone()
                                for x in main.list_vars() if x.persistable}))
    (l0, s0), (l1, s1) = states
    assert len(v['checkpoints']) == 4
    np.testing.assert_array_equal(l0, l1)
    assert s0.keys() == s1.keys()
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n


def test_recompute_matches_jax_without_dropout():
    jm, js, jl, jc, _ = build(jfluid, True)
    tm, _, tl, tc, _ = build(fluid, True)
    jmarker, tmarker = (next(op for op in m.global_block().ops
                             if op.type == '__backward__') for m in (jm, tm))
    assert tmarker.attrs['checkpoints'] == jmarker.attrs['checkpoints'] == \
        [c.name for c in tc]
    fwd = list(tm.global_block().ops)[:tm.global_block().ops.index(tmarker)]
    assert _remat_segments(fwd, tmarker.attrs['checkpoints']) == \
        jax_segments(fwd, jmarker.attrs['checkpoints'])
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({v.name: np.asarray(jscope.find(v.name))
                       for v in jm.list_vars() if v.persistable}, tscope,
                      fluid.CPUPlace(), program=tm)
    params = [p.name for p in tm.all_parameters()]
    fetch = [tl.name] + [n + '@GRAD' for n in params]
    for s in range(STEPS):
        j = jexe.run(jm, feed=batch(s), fetch_list=fetch, scope=jscope)
        p = texe.run(tm, feed=batch(s), fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(p[0], j[0], rtol=1e-5, atol=1e-6)
        if s == 0:
            for g, w in zip(p[1:], j[1:]):
                np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4)


def _errors(pkg):
    """The messages of the four misuses, in ``pkg``."""
    out = []
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss, ckpts, _ = mlp(pkg)
        opt = pkg.optimizer.RecomputeOptimizer(pkg.optimizer.SGD(0.1))
        for bad in (ckpts[0], [ckpts[0], 3], [ckpts[0], ckpts[0].name]):
            with pytest.raises(ValueError) as e:
                opt._set_checkpoints(bad)
            out.append(str(e.value))
        opt._set_checkpoints([ckpts[0], 'no_such_var'])
        with pytest.raises(ValueError) as e:
            opt.minimize(loss)
        out.append(str(e.value))
        opt._set_checkpoints(None)
        assert opt._checkpoints is None
    return out


def test_set_checkpoints_raises_the_reference_errors():
    assert _errors(fluid) == _errors(jfluid)
