"""Static mixed precision in the port (contrib/mixed_precision.py's static
``minimize``, executor.py's casts, ``Program.clone``, ``Config.enable_bf16``)
against the JAX package's, on the CPU.

- The decorated programs of both packages hold the same ops, in order,
  and record the same cast lists; fp16 adds the reference's loss-scaling
  ops (``elementwise_mul`` of the scale, ``check_finite_and_unscale``,
  the skip counter, ``update_loss_scaling``, ``logical_not`` and the
  ``__cond__`` around the update).
- bf16 on four programs (the JAX package's ``tests/framework/test_amp.py``
  model, the static LeNet, ``tools/static_resnet.py`` cut to one block a
  stage at a sixteenth of the width on 32x32 images, and
  ``tools/static_seq2seq.py`` at ``tests/test_torch_static_seq2seq.py``'s
  sizes, whose casts run inside ``__scan__``'s sub-blocks), from the JAX
  startup values. The yardstick is a float64 witness: the port's program
  without casts (``tools/witness.as_float64``) run from the same values.
  Each package's bf16 error is its distance from the witness, and the
  port's must be at most ``3 * jax + 2u``, with u = 2**-8 bf16's unit
  round-off: for the first step's loss (absolute, ``2u`` times the
  witness's loss), for each gradient (relative L2) of the three nets
  without batch norm and for the cut ResNet's head (the fc's weight and
  bias), and for the losses of three steps (the largest distance over the
  steps); over all gradients of a net, the root mean square of the
  per-gradient errors, at most ``2 * jax + 2u`` and at least a third of
  the JAX package's (the port does compute in bf16). The same check of the
  port's gradients scaled by 0.9 must fail. A factor of 3 per gradient:
  each package's error per tensor is noise of its roundings (LeNet's
  ratios lie within 0.6-1.6). Below its head, the cut ResNet's bf16
  gradients are mostly that noise: both packages' first-step gradients
  lie 4-180% (L2) from the witness, and one package's error on a tensor
  is 8x the other's either way (bn2a_branch2a_offset, bn_conv1_offset),
  at 32x32 as at 128x128 and batch 16; so there only their mean is held,
  and a 0.9x scale hides in the noise where the head catches it. After
  the first update both trajectories part from the witness's by up to
  0.3 in the loss.
- fp16 with dynamic loss scaling (``decr_every_n_nan_or_inf=2``,
  ``incr_every_n_steps=3``) over 6 steps with an inf fed at the second
  and third: the scale, the good and bad counts and the skip counter
  equal the JAX package's exactly after every step (the scale falls at
  the third step, grows at the sixth), and so do ``get_loss_scaling`` and
  ``overflow_steps``; each skipped step leaves every parameter bit for
  bit; the parameters lie within 1e-6 of the JAX package's (f32 sums in
  another order differ in the last bit, so exact equality of parameters
  is not asked).
- ``clone(for_test=True)`` of a decorated program keeps its cast lists:
  its logits equal the JAX package's clone's within the bf16 bound and
  differ from the uncast program's.
- The casts reach sub-blocks: a ``StaticRNN`` step's product comes out
  in bf16, as the JAX package's, and values agree within the bound.
- An op outside both lists computes in the promoted type of its floating
  inputs, as ``jnp`` does; integer inputs are never cast.
- ``Config.enable_bf16``: the port's Predictor and the JAX package's on
  one saved model (the port's LeNet) agree within 1e-5 (both compute in
  f32 on bf16-rounded feeds), equal the f32 Predictor fed the rounded
  images, and differ from it on the raw ones.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.models.lenet import build_static_lenet as jax_lenet
from paddle_tpu_torch.contrib import mixed_precision as mp
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.executor import _amp_cast_args
from paddle_tpu_torch.models.lenet import build_static_lenet
from paddle_tpu_torch.tools import static_resnet, static_seq2seq
from paddle_tpu_torch.tools.witness import as_float64, rel_l2
from test_torch_static_seq2seq import KW as S2S, batches as s2s_batches
from torch_jax_seed import jax_seed_pinned  # noqa: F401

U = 2.0 ** -8                       # bf16's unit round-off
CUT = dict(class_dim=10, image_shape=(3, 32, 32), blocks=[1, 1, 1, 1],
           width_div=16)
STEPS = 3


def _mlp(pkg, amp_mp, dtype, **kw):
    """The JAX package's tests/framework/test_amp.py model under
    ``decorate(SGD(0.1))``."""
    L = pkg.layers
    x = L.data('x', [8], dtype='float32')
    y = L.data('y', [1], dtype='float32')
    h = L.fc(x, size=16, act='relu')
    pred = L.fc(h, size=1)
    loss = L.reduce_mean(L.square_error_cost(pred, y))
    opt = amp_mp.decorate(pkg.optimizer.SGD(learning_rate=0.1), dtype=dtype,
                          **kw)
    opt.minimize(loss)
    return loss, pred, opt


def _lenet(pkg, amp_mp, dtype, **kw):
    img = pkg.layers.data('img', [1, 28, 28], dtype='float32')
    label = pkg.layers.data('label', [1], dtype='int64')
    builder = jax_lenet if pkg is jfluid else build_static_lenet
    loss, _, logits = builder(img, label)
    opt = amp_mp.decorate(pkg.optimizer.Momentum(0.01, momentum=0.9),
                          dtype=dtype, **kw)
    opt.minimize(loss)
    return loss, logits, opt


def build(pkg, model, dtype='bfloat16', **kw):
    """(main, startup, loss, logits, optimizer) of ``model`` in ``pkg``,
    under fresh names."""
    amp_mp = jmp if pkg is jfluid else mp
    with pkg.unique_name.guard():
        if model == 'resnet':
            main, startup, _, v = static_resnet.build(pkg, amp=dtype, **CUT)
            return main, startup, v['loss'], v['logits'], v['optimizer']
        if model == 's2s':
            main, startup, v = static_seq2seq.build(pkg, amp=dtype, **S2S)
            return main, startup, v['loss'], None, None
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            loss, logits, opt = (_mlp if model == 'mlp' else _lenet)(
                pkg, amp_mp, dtype, **kw)
    return main, startup, loss, logits, opt


def feeds(model, seed):
    rng = np.random.RandomState(seed)
    if model == 'mlp':
        return {'x': rng.randn(16, 8).astype(np.float32),
                'y': rng.randn(16, 1).astype(np.float32)}
    if model == 's2s':
        return s2s_batches()[seed]
    if model == 'lenet':
        return {'img': rng.rand(8, 1, 28, 28).astype(np.float32),
                'label': rng.randint(0, 10, (8, 1)).astype(np.int64)}
    return {'image': rng.randn(8, 3, 32, 32).astype(np.float32),
            'label': rng.randint(0, 10, (8, 1)).astype(np.int64)}


def jax_host(jm, js):
    """The JAX startup's persistables, numpy by name (the schedule's
    counter made int64, the port's type)."""
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    host = {v.name: np.asarray(jscope.find(v.name)) for v in jm.list_vars()
            if v.persistable}
    return jexe, jscope, {n: (a.astype(np.int64) if 'counter' in n else a)
                          for n, a in host.items()}


def port_scope(program, host, cast=np.float32):
    scope = fluid.Scope()
    scope_from_paddle({n: a.astype(cast) if a.dtype == np.float32 else a
                       for n, a in host.items()}, scope, fluid.CPUPlace(),
                      program=program)
    return scope


def run_steps(exe, program, scope, fetch, model, steps=STEPS):
    return [exe.run(program, feed=feeds(model, s), fetch_list=fetch,
                    scope=scope) for s in range(steps)]


# ------------------------------------------------------------ the programs

@pytest.mark.parametrize('dtype', ['bfloat16', 'float16'])
def test_decorated_programs_match_jax_op_for_op(dtype):
    jm, _, _, _, jopt = build(jfluid, 'mlp', dtype)
    tm, _, _, _, topt = build(fluid, 'mlp', dtype)
    for jb, tb in zip(jm.blocks, tm.blocks):
        assert [(o.type, o.inputs, o.outputs) for o in jb.ops] == \
            [(o.type, o.inputs, o.outputs) for o in tb.ops]
        assert sorted(jb.vars) == sorted(tb.vars)
    assert len(jm.blocks) == len(tm.blocks)
    ja, ta = jm._amp_config, tm._amp_config
    assert (ja['white'], ja['black']) == (ta['white'], ta['black'])
    assert ta['dtype'] == getattr(torch, dtype)
    types = [o.type for o in tm.global_block().ops]
    if dtype == 'float16':
        assert types[-6:] == ['check_finite_and_unscale', 'cast',
                              'elementwise_add', 'update_loss_scaling',
                              'logical_not', '__cond__']
        assert topt._scale_var.name == jopt._scale_var.name
    else:
        assert types[-1] == 'sgd' and '__cond__' not in types


# ----------------------------------------------------------------- bf16

@pytest.mark.parametrize('model', ['mlp', 'lenet', 'resnet', 's2s'])
def test_bf16_steps_match_jax_within_its_own_bf16_error(model):
    jm, js, jl, _, _ = build(jfluid, model)
    tm, _, tl, _, _ = build(fluid, model)
    jexe, jscope, host = jax_host(jm, js)
    texe = fluid.Executor(fluid.CPUPlace())
    params = [p.name for p in tm.all_parameters()]
    fetch = [tl.name] + [n + '@GRAD' for n in params]
    jax = run_steps(jexe, jm, jscope, fetch, model)
    port = run_steps(texe, tm, port_scope(tm, host), fetch, model)
    tm64 = as_float64(tm)
    wit = run_steps(texe, tm64, port_scope(tm64, host, np.float64), fetch,
                    model)
    assert tm._amp_config['dtype'] == torch.bfloat16

    def err(x, w):
        return rel_l2(np.asarray(x, np.float64), np.asarray(w, np.float64))

    # the first step's loss and gradients
    lp, lj, lw = (float(r[0][0]) for r in (port, jax, wit))
    assert abs(lp - lw) <= 3 * abs(lj - lw) + 2 * U * abs(lw), (lp, lj, lw)
    errs = {n: (err(p, w), err(j, w),
                err(np.float64(0.9) * np.asarray(p, np.float64), w))
            for n, p, j, w in zip(params, port[0][1:], jax[0][1:],
                                  wit[0][1:])}
    held = params[-2:] if model == 'resnet' else params
    ratios = {n: errs[n][0] / (3 * errs[n][1] + 2 * U) for n in held}
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= 1, (worst, ratios[worst])
    assert any(errs[n][2] > 3 * errs[n][1] + 2 * U for n in held), \
        'a 0.9x gradient passes the check'
    rms = np.sqrt(np.mean(np.square(list(errs.values())), axis=0))
    assert rms[1] / 3 <= rms[0] <= 2 * rms[1] + 2 * U, rms   # and it casts
    # the three steps' losses
    losses = {k: np.array([float(x[0]) for x in r])
              for k, r in (('port', port), ('jax', jax), ('wit', wit))}
    assert np.isfinite(losses['port']).all()
    dp = np.abs(losses['port'] - losses['wit']).max()
    dj = np.abs(losses['jax'] - losses['wit']).max()
    assert dp <= 3 * dj + 2 * U * np.abs(losses['wit']).max(), losses


# ----------------------------------------------------------------- fp16

FP16 = dict(init_loss_scaling=2.0 ** 10, decr_every_n_nan_or_inf=2,
            incr_every_n_steps=3)
INF_AT = (1, 2)                 # the second and third of six steps


def test_fp16_loss_scaling_state_matches_jax_step_for_step():
    jm, js, jl, _, jopt = build(jfluid, 'mlp', 'float16', **FP16)
    tm, _, tl, _, topt = build(fluid, 'mlp', 'float16', **FP16)
    jexe, jscope, host = jax_host(jm, js)
    texe, tscope = fluid.Executor(fluid.CPUPlace()), port_scope(tm, host)
    names = [topt._scale_var.name] + [
        v.name for v in tm.list_vars()
        if v.name.startswith(('loss_scaling_good', 'loss_scaling_bad',
                              'loss_scaling_skips'))]
    assert len(names) == 4
    params = [p.name for p in tm.all_parameters()]
    states, before = [], None
    for s in range(6):
        feed = feeds('mlp', s)
        if s in INF_AT:
            feed['x'][0, 0] = np.inf
        jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        loss, = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        got = {n: tscope.find(n).numpy().copy() for n in names + params}
        want = {n: np.asarray(jscope.find(n)) for n in names + params}
        for n in names:
            assert got[n].dtype == want[n].dtype, n
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        for n in params:
            np.testing.assert_allclose(got[n], want[n], atol=1e-6, rtol=0)
        if s in INF_AT:
            assert not np.isfinite(loss).all()
            for n in params:
                np.testing.assert_array_equal(got[n], before[n])
        elif before is not None:
            assert any(not np.array_equal(got[n], before[n])
                       for n in params)
        assert topt.get_loss_scaling(tscope) == \
            jopt.get_loss_scaling(jscope)
        assert topt.overflow_steps(tscope) == jopt.overflow_steps(jscope)
        states.append(tuple(float(got[n][0]) for n in names))
        before = got
    # (scale, good, bad, skips): the scale falls at the second bad step
    # and grows at the third good one after it
    assert states == [(1024.0, 1, 0, 0), (1024.0, 0, 1, 1),
                      (819.2000122070312, 0, 0, 2), (819.2000122070312, 1,
                                                     0, 2),
                      (819.2000122070312, 2, 0, 2),
                      (1638.4000244140625, 0, 0, 2)]


# ------------------------------------------------- the clone, sub-blocks

def test_clone_for_test_keeps_the_casts():
    outs = {}
    for pkg in (jfluid, fluid):
        main, startup, _, logits, _ = build(pkg, 'lenet')
        test = main.clone(for_test=True)
        assert test._amp_config is main._amp_config
        outs[pkg] = (main, startup, test, logits)
    jm, js, jt, jlog = outs[jfluid]
    tm, _, tt, tlog = outs[fluid]
    jexe, jscope, host = jax_host(jm, js)
    texe = fluid.Executor(fluid.CPUPlace())
    feed = feeds('lenet', 0)
    j = np.asarray(jexe.run(jt, feed=feed, fetch_list=[jlog.name],
                            scope=jscope)[0], np.float64)
    p = texe.run(tt, feed=feed, fetch_list=[tlog.name],
                 scope=port_scope(tm, host))[0]
    tt64 = as_float64(tt)
    w = texe.run(tt64, feed=feed, fetch_list=[tlog.name],
                 scope=port_scope(tt64, host, np.float64))[0]
    assert rel_l2(p, j) <= 2 * rel_l2(j, w) + 2 * U
    uncast = tt.clone()
    uncast.__dict__.pop('_amp_config')
    f = texe.run(uncast, feed=feed, fetch_list=[tlog.name],
                 scope=port_scope(tm, host))[0]
    assert rel_l2(f, w) < 1e-5 < rel_l2(p, w)


def _rnn(pkg, amp_mp):
    """A StaticRNN whose step multiplies by a weight (a white-list
    ``matmul`` in a sub-block), under ``decorate(SGD)``."""
    L = pkg.layers
    x = L.data('x', [4, 2, 3], dtype='float32', append_batch_size=False)
    w = L.create_parameter([3, 3], 'float32', name='rnn_w')
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(shape=[2, 3], batch_ref=xt, init_value=0.0)
        prod = L.matmul(xt, w)
        nh = L.tanh(prod + h)
        rnn.update_memory(h, nh)
        rnn.step_output(prod)
        rnn.step_output(nh)
    prods, hs = rnn()
    loss = L.reduce_mean(hs)
    amp_mp.decorate(pkg.optimizer.SGD(0.1)).minimize(loss)
    return prods, hs


def test_the_casts_reach_sub_blocks():
    out = {}
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            prods, hs = _rnn(pkg, jmp if pkg is jfluid else mp)
        out[pkg] = (main, startup, prods, hs)
    jm, js, jp, jh = out[jfluid]
    tm, _, tp, th = out[fluid]
    jexe, jscope, host = jax_host(jm, js)
    feed = {'x': np.random.RandomState(0).randn(4, 2, 3).astype(np.float32)}
    j = jexe.run(jm, feed=feed, fetch_list=[jp.name, jh.name], scope=jscope)
    texe = fluid.Executor(fluid.CPUPlace())
    p = texe.run(tm, feed=feed, fetch_list=[tp.name, th.name],
                 scope=port_scope(tm, host), return_numpy=False)
    assert str(np.asarray(j[0]).dtype) == 'bfloat16'
    assert p[0].dtype == torch.bfloat16 and p[1].dtype == torch.float32
    for got, want in zip(p, j):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 * U, atol=2 * U)


def test_an_op_outside_both_lists_computes_in_the_promoted_type():
    bf = torch.ones(3, dtype=torch.bfloat16)
    f32 = torch.tensor(0.5)
    ids = torch.arange(3)
    # torch alone keeps bf16 against an f32 0-d tensor; jnp gives f32
    assert (bf + f32).dtype == torch.bfloat16
    args = _amp_cast_args([bf, f32, ids, [bf, None]], 'promote')
    assert [a.dtype for a in args[:3]] == [torch.float32, torch.float32,
                                           torch.int64]
    assert args[3][0].dtype == torch.float32 and args[3][1] is None
    same = [bf, bf]
    assert _amp_cast_args(same, 'promote') is same
    white = _amp_cast_args([f32, ids], torch.bfloat16)
    assert [a.dtype for a in white] == [torch.bfloat16, torch.int64]


# --------------------------------------------------------- enable_bf16

def test_enable_bf16_predictor_matches_jax(tmp_path):
    from paddle_tpu import inference as jinf
    from paddle_tpu_torch import inference
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data('img', [1, 28, 28], dtype='float32')
        label = fluid.layers.data('label', [1], dtype='int64')
        _, _, logits = build_static_lenet(img, label)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(tmp_path), ['img'], [logits], exe,
                                      main_program=main)
    x = feeds('lenet', 1)['img']
    rounded = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert not np.array_equal(rounded, x)
    cfg = inference.Config(str(tmp_path)).enable_bf16()
    pred = inference.Predictor(cfg, fluid.Executor(fluid.CPUPlace()))
    f32 = inference.Predictor(inference.Config(str(tmp_path)),
                              fluid.Executor(fluid.CPUPlace()))
    jpred = jinf.Predictor(jinf.Config(str(tmp_path)).enable_bf16(),
                           jfluid.Executor(jfluid.CPUPlace()))
    got = pred.run([x])[0]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jpred.run([x])[0]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got, f32.run([rounded])[0])
    assert not np.array_equal(got, f32.run([x])[0])
    assert pred.executor.lowering_count(pred.program) == 1
