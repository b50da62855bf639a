"""The port's IR passes (paddle_tpu_torch/ir/) and the ops they emit
(ops/fused_ops.py) against the JAX package's, on the CPU.

- Each pass (``constant_fold``, ``dce``, ``fuse_elewise_add_act``,
  ``fuse_all_optimizer_ops``) applied alone to the same program built in
  both packages (an MLP under Adam, a ResNet bottleneck under Momentum, a
  dropout program with dead ops, a bf16 AMP program, a constant chain)
  leaves the same sequence of op types, but for the port's own rule:
  ``dce`` never drops an op that draws random numbers (the JAX package
  drops a dead ``dropout``; its keys are salted with op positions, the
  port's ops draw in turn from one generator).
- Passes on against passes off in the port, bitwise, over three steps
  from the same state and seed: the fetched loss and every persistable.
  The AMP program keeps ``fuse_act`` off. Each knob alone, set, runs and
  gives the values of the knob off.
- The port with the passes on against the JAX package with them on:
  LeNet over three steps under SGD, Momentum and Adam, held to the float64
  witness as ``test_torch_static_graph.py``'s
  ``test_lenet_three_steps_match_jax`` holds it (same bounds).
- The fused ops take the JAX package's parameters and give the bits of
  the per-parameter ops (and their gradient, for the add + activation).
- The pipeline's wiring: ``PADDLE_TPU_PASSES``, the signature in the plan
  key, the passes never touching the caller's program, the manager's
  counts, a fetch of a value the passes removed.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import ir as jir
from paddle_tpu.compiler import BuildStrategy as JBuildStrategy
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.ops import fused_ops as jfused
from paddle_tpu_torch import ir
from paddle_tpu_torch.compiler import BuildStrategy
from paddle_tpu_torch.contrib import mixed_precision as mp
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.ir.dce import draws_random
from paddle_tpu_torch.ops import fused_ops, optimizer_ops
from paddle_tpu_torch.ops.math_ops import elementwise_add
from test_torch_static_graph import (batch, carried_across,  # noqa: F401
                                     fresh_port_programs, lenet_readings,
                                     lenet_witness, persistables)
from torch_jax_seed import jax_seed_pinned  # noqa: F401

CPU = fluid.CPUPlace()
PASSES = ('constant_fold', 'dce', 'fuse_elewise_add_act',
          'fuse_all_optimizer_ops')


def fused_bs(pkg, act=True, opt=True):
    bs = (JBuildStrategy if pkg is jfluid else BuildStrategy)()
    bs.fuse_elewise_add_act_ops = act
    bs.fuse_all_optimizer_ops = opt
    return bs


# ----------------------------------------------------------------- programs
# each: pkg -> (main, startup, fetch names, feed)

def mlp_adam(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data('x', [16], dtype='float32')
        label = L.data('label', [1], dtype='int64')
        h = x
        for _ in range(3):
            h = L.fc(h, size=16, act='relu')
        logits = L.fc(h, size=4)
        loss = L.reduce_mean(L.softmax_with_cross_entropy(logits, label))
        L.accuracy(L.softmax(logits), label)     # dead unless fetched
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    rng = np.random.RandomState(0)
    feed = {'x': rng.randn(8, 16).astype(np.float32),
            'label': rng.randint(0, 4, (8, 1)).astype(np.int64)}
    return main, startup, [loss.name], feed


def resnet_block(pkg):
    """The JAX package's ``tools/bench_passes.build_resnet_block`` at its
    smoke size: a bottleneck (1x1, 3x3, 1x1 convolutions with batch norm),
    the shortcut add + relu, under Momentum."""
    L = pkg.layers
    ch, hw = 8, 6
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data('x', [ch, hw, hw], dtype='float32')
        y = L.data('y', [1], dtype='float32')

        def conv_bn(inp, ch_out, k, act=None):
            c = L.conv2d(inp, ch_out, k, padding=(k - 1) // 2,
                         bias_attr=False)
            return L.batch_norm(c, act=act)

        h = conv_bn(x, ch // 2, 1, act='relu')
        h = conv_bn(h, ch // 2, 3, act='relu')
        h = conv_bn(h, ch, 1)
        h = L.relu(L.elementwise_add(h, x))
        pred = L.fc(L.reduce_mean(h, dim=[2, 3]), size=1)
        loss = L.reduce_mean(L.square_error_cost(pred, y))
        pkg.optimizer.Momentum(learning_rate=1e-2,
                               momentum=0.9).minimize(loss)
    rng = np.random.RandomState(1)
    feed = {'x': rng.randn(2, ch, hw, hw).astype(np.float32),
            'y': rng.randn(2, 1).astype(np.float32)}
    return main, startup, [loss.name], feed


def dropout_prog(pkg):
    """A dead scale and a dead dropout before a live dropout."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data('x', [16], dtype='float32')
        y = L.data('y', [1], dtype='float32')
        L.scale(x, scale=3.0)
        L.dropout(x, dropout_prob=0.5)
        h = L.fc(x, size=16, act='relu')
        h = L.dropout(h, dropout_prob=0.5)
        pred = L.fc(h, size=1)
        loss = L.reduce_mean(L.square_error_cost(pred, y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    rng = np.random.RandomState(2)
    feed = {'x': rng.randn(8, 16).astype(np.float32),
            'y': rng.randn(8, 1).astype(np.float32)}
    return main, startup, [loss.name], feed


def amp_prog(pkg):
    """test_amp.py's MLP under ``decorate(Momentum, dtype='bfloat16')``."""
    L = pkg.layers
    amp = jmp if pkg is jfluid else mp
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data('x', [8], dtype='float32')
        y = L.data('y', [1], dtype='float32')
        h = L.fc(x, size=16, act='relu')
        pred = L.fc(h, size=1)
        loss = L.reduce_mean(L.square_error_cost(pred, y))
        amp.decorate(pkg.optimizer.Momentum(0.01, momentum=0.9),
                     dtype='bfloat16').minimize(loss)
    rng = np.random.RandomState(3)
    feed = {'x': rng.randn(8, 8).astype(np.float32),
            'y': rng.randn(8, 1).astype(np.float32)}
    return main, startup, [loss.name], feed


def const_prog(pkg):
    """test_ir_passes.py's fill_constant -> scale -> cast chain."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data('x', [4], dtype='float32')
        c = L.tensor.fill_constant([4], 'float32', 2.0)
        s = L.scale(c, scale=3.0, bias=1.0)
        y = L.elementwise_add(x, L.cast(s, 'float32'))
        out = L.reduce_sum(y)
    return main, startup, [out.name], {'x': np.ones((2, 4), np.float32)}


PROGRAMS = {'mlp_adam': mlp_adam, 'resnet_block': resnet_block,
            'dropout': dropout_prog, 'amp': amp_prog, 'const': const_prog}


def types(program):
    return [op.type for op in program.global_block().ops]


# ------------------------------------------------------ each pass vs JAX

def expected_port_types(jopt, port_main, pass_name):
    """The JAX package's result, with the ops its DCE dropped that draw
    random numbers put back (the port's rule): the JAX package stamps
    each op with its original position (``_rng_salt``)."""
    jops = [(op.attrs['_rng_salt'], op.type)
            for op in jopt.global_block().ops]
    kept = {salt for salt, _ in jops}
    ops = port_main.global_block().ops
    back = [(i, op.type) for i, op in enumerate(ops)
            if pass_name == 'dce' and i not in kept and draws_random(op)]
    return [t for _, t in sorted(jops + back)], back


@pytest.mark.parametrize('pass_name', PASSES)
@pytest.mark.parametrize('prog', sorted(PROGRAMS))
def test_each_pass_matches_jax(prog, pass_name):
    jm, _, jfetch, _ = PROGRAMS[prog](jfluid)
    tm, _, tfetch, _ = PROGRAMS[prog](fluid)
    assert types(tm) == types(jm)
    jopt, jctx = jir.PassManager([jir.get_pass(pass_name)]).apply(
        jm, jir.PassContext(fetch_names=jfetch,
                            build_strategy=fused_bs(jfluid)))
    topt, tctx = ir.PassManager([ir.get_pass(pass_name)]).apply(
        tm, ir.PassContext(fetch_names=tfetch,
                           build_strategy=fused_bs(fluid)))
    want, back = expected_port_types(jopt, tm, pass_name)
    assert types(topt) == want
    # the stated difference: the dropout program's dead dropout alone
    if prog == 'dropout' and pass_name == 'dce':
        assert [t for _, t in back] == ['dropout']
    else:
        assert back == []
    assert tctx.stats.get(pass_name) == jctx.stats.get(pass_name) or (
        prog == 'dropout' and pass_name == 'dce')
    if pass_name == 'fuse_elewise_add_act' and prog in (
            'mlp_adam', 'resnet_block', 'dropout'):
        assert 'fused_elemwise_add_activation' in types(topt)
    if prog == 'amp':
        assert 'fused_elemwise_add_activation' not in types(topt)


# ------------------------------------------- passes on against passes off

def start_values(main, startup):
    """The port's startup values, as numpy."""
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    return {n: scope.find(n).numpy().copy() for n in persistables(main)}


def port_steps(main, fetch, feed, start, monkeypatch, passes, bs,
               steps=3, seed=5):
    """``steps`` runs of ``CompiledProgram(main, bs)`` from ``start`` with
    the generator seeded ``seed``: [(fetched, {persistable: value})]."""
    monkeypatch.setenv('PADDLE_TPU_PASSES', passes)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    scope_from_paddle(start, scope, CPU, program=main)
    fluid.seed(seed)
    prog = fluid.CompiledProgram(main, build_strategy=bs)
    out = []
    for _ in range(steps):
        got = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        out.append((got, {n: scope.find(n).numpy().copy()
                          for n in start}))
    return out


def assert_bitwise(a, b):
    for s, ((fa, sa), (fb, sb)) in enumerate(zip(a, b)):
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y, err_msg=f'step {s}')
        for n in sa:
            np.testing.assert_array_equal(sa[n], sb[n],
                                          err_msg=f'{n} at step {s}')


@pytest.mark.parametrize('prog', ['mlp_adam', 'resnet_block', 'dropout',
                                  'amp'])
def test_passes_on_and_off_give_the_same_bits(prog, monkeypatch):
    main, startup, fetch, feed = PROGRAMS[prog](fluid)
    start = start_values(main, startup)
    off = port_steps(main, fetch, feed, start, monkeypatch, '0',
                     fused_bs(fluid))
    on = port_steps(main, fetch, feed, start, monkeypatch, '1',
                    fused_bs(fluid))
    assert_bitwise(off, on)
    opt, ctx = ir.apply_pipeline(main, fetch, build_strategy=fused_bs(fluid))
    if prog == 'amp':
        assert 'fuse_elewise_add_act' not in ctx.stats
        assert 'fused_elemwise_add_activation' not in types(opt)
    else:
        assert ctx.stats['fuse_elewise_add_act']['fused_pairs'] >= 1
    assert ctx.stats['fuse_all_optimizer_ops']['fused_groups'] == 1
    if prog == 'dropout':
        assert types(opt).count('dropout') == 2
        assert ctx.stats['dce']['removed_ops'] == 1     # the dead scale


@pytest.mark.parametrize('knob', ['fuse_elewise_add_act_ops',
                                  'fuse_all_optimizer_ops'])
@pytest.mark.parametrize('prog', ['mlp_adam', 'resnet_block'])
def test_fuse_knob_runs_and_keeps_the_values(prog, knob, monkeypatch):
    """The knob set on a ``CompiledProgram``: the run is done with its
    pass, and gives the values of the knob off."""
    main, startup, fetch, feed = PROGRAMS[prog](fluid)
    start = start_values(main, startup)
    bs = fused_bs(fluid, act=knob == 'fuse_elewise_add_act_ops',
                  opt=knob == 'fuse_all_optimizer_ops')
    fused = 'fused_elemwise_add_activation' if knob.startswith(
        'fuse_elewise') else ('fused_adam' if prog == 'mlp_adam'
                              else 'fused_momentum')
    opt, _ = ir.apply_pipeline(main, fetch, build_strategy=bs)
    assert fused in types(opt)
    off = port_steps(main, fetch, feed, start, monkeypatch, '1',
                     fused_bs(fluid, act=False, opt=False))
    on = port_steps(main, fetch, feed, start, monkeypatch, '1', bs)
    assert_bitwise(off, on)


# ------------------------------------------ the port against JAX, passes on

@pytest.mark.parametrize('opt,param_atol', [('sgd', 1e-5),
                                            ('momentum', 1e-5),
                                            ('adam', 1e-4)])
def test_lenet_three_fused_steps_match_jax(opt, param_atol):
    """Both packages run LeNet through ``CompiledProgram`` with both fuse
    knobs set (their default pipelines on), held to the float64 witness
    with ``test_lenet_three_steps_match_jax``'s bounds."""
    (jexe, jscope, jm, jl, _, _), (texe, tscope, tm, tl, _, _) = \
        carried_across(opt)
    names = persistables(tm)
    start = {n: tscope.find(n).numpy().copy() for n in names}
    wexe, wm, wscope = lenet_witness(tm, start)
    jprog = jfluid.CompiledProgram(jm, build_strategy=fused_bs(jfluid))
    tprog = fluid.CompiledProgram(tm, build_strategy=fused_bs(fluid))
    want, got = [], []
    states = {'jax': [], 'port': [], 'witness': []}
    for step in range(3):
        x, y = batch(10 + step)
        want.append(jexe.run(jprog, feed={'img': x, 'label': y},
                             fetch_list=[jl], scope=jscope)[0])
        got.append(texe.run(tprog, feed={'img': x, 'label': y},
                            fetch_list=[tl], scope=tscope)[0])
        wexe.run(wm, feed={'img': x, 'label': y}, fetch_list=[tl.name],
                 scope=wscope)
        states['jax'].append({n: np.asarray(jscope.find(n)) for n in names})
        states['port'].append({n: tscope.find(n).numpy().copy()
                               for n in names})
        states['witness'].append({n: wscope.find(n).numpy().copy()
                                  for n in names})
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for name in names:
        np.testing.assert_allclose(
            states['port'][0][name], states['jax'][0][name],
            atol=param_atol, rtol=0, err_msg=name)
    for s, name, reading, bound in lenet_readings(
            states['port'], states['jax'], states['witness'], start,
            param_atol / 10):
        assert reading <= bound, (s, name, reading, bound)
    opt_prog, ctx = ir.apply_pipeline(tm, [tl.name],
                                      build_strategy=fused_bs(fluid))
    assert ctx.stats['fuse_elewise_add_act']['fused_pairs'] == 3
    assert types(opt_prog).count(f'fused_{opt}') == 1
    assert texe.lowering_count(tm) == 1


# ------------------------------------------------------------ the fused ops

@pytest.mark.parametrize('name', ['fused_elemwise_add_activation',
                                  'fused_sgd', 'fused_momentum',
                                  'fused_lars_momentum', 'fused_adam'])
def test_fused_ops_take_the_jax_parameters(name):
    assert (inspect.signature(getattr(fused_ops, name))
            == inspect.signature(getattr(jfused, name)))


SHAPES = [(3, 4), (5,), (2, 3, 4), (1,)]


def rand(gen, shape):
    return torch.randn(shape, generator=gen)


@pytest.mark.parametrize('nesterov', [False, True])
def test_fused_momentum_gives_the_per_parameter_bits(nesterov):
    g = torch.Generator().manual_seed(0)
    p, gr, v = ([rand(g, s) for s in SHAPES] for _ in range(3))
    lr = torch.tensor([0.05])
    before = [t.clone() for t in p + v]
    fp, fv = fused_ops.fused_momentum(p, gr, v, lr, mu=0.9,
                                      use_nesterov=nesterov)
    for i in range(len(SHAPES)):
        wp, wv = optimizer_ops._momentum_out(p[i], gr[i], v[i], lr, mu=0.9,
                                             use_nesterov=nesterov)
        assert torch.equal(fp[i], wp) and torch.equal(fv[i], wv)
    assert all(torch.equal(a, b) for a, b in zip(p + v, before))


def test_fused_adam_gives_the_per_parameter_bits():
    """Each parameter's own step size, also where the pows differ."""
    g = torch.Generator().manual_seed(1)
    p, gr, m1 = ([rand(g, s) for s in SHAPES] for _ in range(3))
    m2 = [rand(g, s).abs() for s in SHAPES]
    b1 = [torch.tensor([0.9 ** k]) for k in (1, 2, 3, 7)]
    b2 = [torch.tensor([0.999 ** k]) for k in (1, 2, 3, 7)]
    lr = torch.tensor([1e-3])
    got = fused_ops.fused_adam(p, gr, m1, m2, b1, b2, lr)
    for i in range(len(SHAPES)):
        want = optimizer_ops._adam_out(p[i], gr[i], m1[i], m2[i], b1[i],
                                       b2[i], lr)
        for slot, w in zip(got, want):
            assert torch.equal(slot[i], w), i


def test_fused_sgd_gives_the_per_parameter_bits():
    g = torch.Generator().manual_seed(2)
    p, gr = ([rand(g, s) for s in SHAPES] for _ in range(2))
    lr = torch.tensor([0.1])
    for got, a, b in zip(fused_ops.fused_sgd(p, gr, lr), p, gr):
        assert torch.equal(got, optimizer_ops.sgd(a, b, lr))


@pytest.mark.parametrize('functor', ['relu', 'sigmoid', 'tanh'])
def test_fused_add_activation_gives_the_pair_bits(functor):
    """Values and gradients of the fused op against the add then the
    activation, ``y`` aligned from ``axis`` 1 (a conv bias)."""
    g = torch.Generator().manual_seed(3)
    x0, y0 = rand(g, (2, 3, 4, 4)), rand(g, (3,))
    xs = [x0.clone().requires_grad_(True) for _ in range(2)]
    ys = [y0.clone().requires_grad_(True) for _ in range(2)]
    got = fused_ops.fused_elemwise_add_activation(xs[0], ys[0],
                                                  functor=functor, axis=1)
    want = getattr(torch, functor)(elementwise_add(xs[1], ys[1], axis=1))
    assert torch.equal(got, want)
    w = rand(g, tuple(got.shape))
    (got * w).sum().backward()
    (want * w).sum().backward()
    assert torch.equal(xs[0].grad, xs[1].grad)
    assert torch.equal(ys[0].grad, ys[1].grad)


# ------------------------------------------------------------------ wiring

def test_the_caller_program_is_left_as_it_was():
    main, _, fetch, _ = mlp_adam(fluid)
    before = [(op.type, dict(op.inputs), dict(op.outputs))
              for op in main.global_block().ops]
    version = main._version
    opt, _ = ir.apply_pipeline(main, fetch, build_strategy=fused_bs(fluid))
    assert opt is not main and len(types(opt)) < len(before)
    assert [(op.type, dict(op.inputs), dict(op.outputs))
            for op in main.global_block().ops] == before
    assert main._version == version


def test_the_manager_counts_and_a_second_pass_is_a_fixpoint():
    main, _, fetch, _ = mlp_adam(fluid)
    mgr = ir.build_pipeline()
    ctx = ir.PassContext(fetch_names=fetch, build_strategy=fused_bs(fluid))
    once, _ = mgr.apply(main, ctx)
    twice, ctx2 = mgr.apply(once, ir.PassContext(
        fetch_names=fetch, build_strategy=fused_bs(fluid)))
    assert mgr.names() == ('constant_fold', 'fuse_elewise_add_act',
                           'fuse_all_optimizer_ops', 'dce')
    assert dict(mgr.applied) == dict.fromkeys(mgr.names(), 2)
    assert set(mgr.elapsed) == set(mgr.names())
    assert all(t >= 0 for t in mgr.elapsed.values())
    assert types(twice) == types(once)
    assert ctx2.stats['dce'] == {'removed_ops': 0, 'removed_vars': 0}


def test_passes_env_selects_the_pipeline(monkeypatch):
    main, _, fetch, _ = mlp_adam(fluid)
    monkeypatch.setenv('PADDLE_TPU_PASSES', '0')
    opt, ctx = ir.apply_pipeline(main, fetch, build_strategy=fused_bs(fluid))
    assert opt is main and ctx.stats == {}
    assert ir.pipeline_signature(fused_bs(fluid)) == ()
    monkeypatch.setenv('PADDLE_TPU_PASSES', 'dce,constant_fold')
    assert ir.build_pipeline().names() == ('constant_fold', 'dce')
    assert ir.pipeline_signature(None) == ('dce', 'constant_fold')
    monkeypatch.setenv('PADDLE_TPU_PASSES', '1')
    assert ir.pipeline_signature(None) == ('constant_fold', 'dce')
    assert ir.pipeline_signature(fused_bs(fluid)) == (
        'constant_fold', 'fuse_elewise_add_act', 'fuse_all_optimizer_ops',
        'dce')


@pytest.mark.parametrize('name,item', [('bucket_allreduce', 'A.9'),
                                       ('auto_remat', 'A.11')])
def test_a_pass_not_ported_yet_raises(name, item, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_PASSES', f'dce,{name}')
    with pytest.raises(NotImplementedError, match=item):
        ir.build_pipeline()


def test_a_flipped_knob_builds_a_new_plan():
    main, startup, fetch, feed = mlp_adam(fluid)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    for bs in (None, None, fused_bs(fluid), fused_bs(fluid),
               fused_bs(fluid, act=False)):
        prog = main if bs is None else fluid.CompiledProgram(
            main, build_strategy=bs)
        exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    assert exe.lowering_count(main) == 3


def test_a_fetch_the_passes_removed_builds_the_plan_again(monkeypatch):
    """DCE drops the accuracy when the loss alone is fetched; a later run
    that fetches it gets it, from a plan built for both fetches."""
    main, startup, fetch, feed = mlp_adam(fluid)
    acc = next(op.outputs['Out'][0] for op in main.global_block().ops
               if op.type == 'accuracy')
    start = start_values(main, startup)
    got = {}
    for passes in ('0', '1'):
        monkeypatch.setenv('PADDLE_TPU_PASSES', passes)
        exe, scope = fluid.Executor(CPU), fluid.Scope()
        scope_from_paddle(start, scope, CPU, program=main)
        runs = [exe.run(main, feed=feed, fetch_list=f, scope=scope)
                for f in (fetch, [acc], fetch + [acc], [acc])]
        got[passes] = (runs, exe.lowering_count(main))
    assert got['0'][1] == 1 and got['1'][1] == 2
    for a, b in zip(got['0'][0], got['1'][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _guard_program(pkg, guard):
    """An add feeding a relu, where ``guard`` keeps them apart."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.data('x', [8], dtype='float32')
        y = L.data('y', [8], dtype='float32')
        mid = L.elementwise_add(x, y)
        out = L.relu(mid)
        fetch = [out.name]
        if guard == 'fetched':
            fetch.append(mid.name)
        elif guard == 'another reader':
            fetch.append(L.scale(mid, scale=2.0).name)
        elif guard == 'persistable':
            main.global_block().var(mid.name).persistable = True
        elif guard == 'checkpoint':
            w = L.create_parameter([8], 'float32', name='w')
            loss = L.reduce_mean(L.elementwise_mul(out, w))
            pkg.backward.append_backward(loss, checkpoints=[mid])
            fetch = [loss.name]
    return main, fetch


@pytest.mark.parametrize('guard', ['none', 'fetched', 'another reader',
                                   'persistable', 'checkpoint'])
def test_fuse_act_guards_match_jax(guard):
    got = []
    for pkg, mod in ((jfluid, jir), (fluid, ir)):
        main, fetch = _guard_program(pkg, guard)
        opt, _ = mod.PassManager([mod.get_pass('fuse_elewise_add_act')]
                                 ).apply(main, mod.PassContext(
                                     fetch_names=fetch,
                                     build_strategy=fused_bs(pkg)))
        got.append(types(opt))
    assert got[1] == got[0]
    assert ('fused_elemwise_add_activation' in got[1]) == (guard == 'none')
