"""The rest of the port's optimizer surface (paddle_tpu_torch/
{optimizer, ops/optimizer_ops, ops/fused_ops, ir/fuse_optimizer}.py,
contrib/extend_optimizer) against the JAX package's, on the CPU.

- Each update op the slice adds (``lars_momentum``, ``adamax``,
  ``adagrad``, ``decayed_adagrad``, ``rmsprop`` plain and centered,
  ``adadelta``, ``ftrl`` at ``lr_power`` -0.5 and -0.7, ``lamb``,
  ``dpsgd`` at ``sigma`` 0, ``dgc_momentum``) against the JAX op on the
  same numpy inputs: random tensors, a parameter at zero and a gradient at
  zero. atol 1e-6 and rtol 1e-5: the same f32 operations in the same
  order, but for the norms (the port's ``torch.linalg.vector_norm``
  against ``jnp.sqrt(jnp.sum(jnp.square(x)))``, which sum in another
  order) and ``pow``/``sqrt`` (a last bit apart). DGC's threshold keeps
  every entry that ties the k-th magnitude, in both packages: exactly.
- Each multi-tensor form against its per-parameter op, over parameters of
  several shapes with one at zero (a bias's first step) and one with a
  zero gradient: bit for bit on the CPU, where ``torch._foreach_norm`` is
  ``torch.linalg.vector_norm`` and the other ``_foreach`` ops are the
  per-tensor ones.
- Dpsgd's noise differs from the JAX PRNG by design: at ``sigma`` > 0 the
  clip is exact and the noise's mean and deviation are held (atol 0.05 of
  the deviation on 200,000 draws, five times the standard errors).
- Each rule's class, three dygraph ``minimize`` steps of a small MLP (4
  -> 3 relu -> 2, biases starting at 0) against the JAX package's: atol
  1e-5 (adaptive steps move with round-off in small gradients), rtol 0.
  LARS and Lamb with an ``exclude_from_weight_decay_fn`` on the biases.
  Dpsgd against the JAX package's SGD with ``GradientClipByNorm`` at
  ``sigma`` 0 (the JAX package's dygraph Dpsgd raises: it passes no PRNG
  key, ROADMAP C.16).
- Each rule with an update op, three static LeNet steps against the JAX
  package's, as ``test_torch_static_graph.py``'s
  ``test_lenet_three_steps_match_jax`` holds Adam: the same program op for
  op, losses rtol 1e-4, the first step's persistables within atol 1e-4,
  every step within twice the JAX package's distance from the float64
  witness plus a floor.
- ``fuse_all_optimizer_ops`` on a LARS program with excluded biases: two
  ``fused_lars_momentum`` groups (the excluded parameters apart), bit for
  bit the plain ops over three steps.
- ``extend_with_decoupled_weight_decay(Adam)`` in both modes, Lookahead
  over SGD, ``ModelAverage`` and ``ExponentialMovingAverage`` after k
  steps, the static ``GradientMergeOptimizer`` (passes on and off, bit for
  bit), ``state_dict``/``set_dict`` from the JAX package's slot names, and
  BERT-tiny with LAMB through ``TrainStep`` for three steps.
"""
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
import test_torch_static_graph as tsg
from paddle_tpu import dygraph as jdy
from paddle_tpu import layers as jlayers
from paddle_tpu.contrib import extend_optimizer as jext
from paddle_tpu.ops import optimizer_ops as jops
from paddle_tpu_torch import dygraph, layers
from paddle_tpu_torch.compiler import BuildStrategy
from paddle_tpu_torch.contrib import extend_optimizer as ext
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.ops import fused_ops
from paddle_tpu_torch.ops import optimizer_ops as ops
from test_torch_ir_passes import assert_bitwise, port_steps
from test_torch_ir_passes import types as op_types
from test_torch_static_graph import (batch, carried_across,  # noqa: F401
                                     fresh_port_programs, lenet_readings,
                                     lenet_witness, persistables)
from torch_jax_seed import jax_seed_pinned  # noqa: F401

CPU = fluid.CPUPlace()
ATOL, RTOL = 1e-6, 1e-5

# op -> its attrs in the tests
OP_ATTRS = {
    'lars_momentum': {'mu': 0.9, 'lars_coeff': 0.001,
                      'lars_weight_decay': 0.0005, 'epsilon': 1e-9},
    'adamax': {},
    'adagrad': {'epsilon': 1e-6},
    'decayed_adagrad': {'decay': 0.9},
    'rmsprop': {'momentum': 0.9},
    'rmsprop_centered': {'momentum': 0.9, 'centered': True},
    'adadelta': {'rho': 0.9},
    'ftrl': {'l1': 0.01, 'l2': 0.1, 'lr_power': -0.5},
    'ftrl_power_0.7': {'l1': 0.01, 'l2': 0.1, 'lr_power': -0.7},
    'lamb': {'weight_decay': 0.01},
    'dpsgd': {'clip': 1.0, 'batch_size': 4.0, 'sigma': 0.0},
    'dgc_momentum': {'mu': 0.9, 'sparsity': 0.75},
}
# slots that hold squares, norms or sums of them: positive
POSITIVE = {'moment2', 'inf_norm', 'mean_square', 'avg_squared_grad',
            'avg_squared_update', 'squared_accum'}


def op_name(case):
    return case.split('_centered')[0].split('_power')[0]


def op_inputs(case, shape, rng, zero=None):
    """The op's inputs in order, as numpy: the parameter and the gradient
    (``zero``: the one that is all zeros), the slots, the rate."""
    name = op_name(case)
    fn = getattr(ops, name)
    out = []
    for slot in list(inspect.signature(fn).parameters)[:-1]:
        p = inspect.signature(fn).parameters[slot]
        if p.kind is not p.POSITIONAL_OR_KEYWORD:
            break
        if slot == 'lr':
            out.append(np.asarray([0.01], np.float32))
        elif slot in ('beta1_pow', 'beta2_pow'):
            out.append(np.asarray([(0.9 if slot == 'beta1_pow' else 0.999)
                                   ** 3], np.float32))
        elif slot == zero:
            out.append(np.zeros(shape, np.float32))
        elif slot in POSITIVE or (slot == 'moment' and 'adagrad' in name):
            v = np.abs(rng.standard_normal(shape)) + 0.1
            out.append((v + (1.0 if slot == 'mean_square' else 0.0))
                       .astype(np.float32))
        else:
            scale = 1.0 if slot in ('param', 'grad') else 0.1
            out.append((rng.standard_normal(shape) * scale)
                       .astype(np.float32))
    return out


def jax_op(case, args):
    kw = dict(OP_ATTRS[case])
    if op_name(case) == 'dpsgd':
        kw['key'] = jax.random.PRNGKey(0)
    res = getattr(jops, op_name(case))(*[jnp.asarray(a) for a in args], **kw)
    return [np.asarray(r) for r in (res if isinstance(res, tuple)
                                    else (res,))]


def port_op(case, args):
    kw = dict(OP_ATTRS[case])
    if op_name(case) == 'dpsgd':
        kw['key'] = torch.Generator().manual_seed(0)
    res = getattr(ops, op_name(case))(*[torch.from_numpy(a) for a in args],
                                      **kw)
    return [r.numpy() for r in (res if isinstance(res, tuple) else (res,))]


@pytest.mark.parametrize('zero', [None, 'param', 'grad'],
                         ids=['random', 'zero_param', 'zero_grad'])
@pytest.mark.parametrize('case', list(OP_ATTRS))
def test_update_op_matches_jax(case, zero):
    rng = np.random.default_rng(len(case))
    args = op_inputs(case, (6, 5), rng, zero)
    want, got = jax_op(case, args), port_op(case, args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    if zero == 'param' and case in ('lars_momentum', 'lamb'):
        # the guard: the plain rate (LARS) or a trust ratio of 1 (Lamb)
        assert np.abs(got[0]).max() > 0


def test_dgc_keeps_every_tie_at_the_threshold():
    """k = max(1, int(8 * 0.75)) = 2, and three entries tie at the second
    largest magnitude: all three are kept, in both packages."""
    g = np.asarray([[4.0, -3.0, 3.0, 1.0], [0.5, -3.0, 0.25, 2.0]],
                   np.float32)
    z = np.zeros_like(g)
    args = [z, g, z, z, np.asarray([0.1], np.float32)]
    want = jax_op('dgc_momentum', args)
    got = port_op('dgc_momentum', args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    kept = got[1] != 0                      # the velocity: the kept part
    assert kept.sum() == 4                  # 4.0 and the three 3.0s
    np.testing.assert_array_equal(got[2][kept], 0)
    np.testing.assert_array_equal(got[2][~kept], g[~kept])


SHAPES = [(3, 4), (5,), (2, 3, 4), (1,), (4,)]


@pytest.mark.parametrize('case', list(OP_ATTRS))
def test_multi_tensor_form_gives_the_per_parameter_bits(case):
    """Parameter 3 starts at zero and parameter 4 has a zero gradient."""
    rng = np.random.default_rng(7)
    inputs = [op_inputs(case, s, rng, {3: 'param', 4: 'grad'}.get(i))
              for i, s in enumerate(SHAPES)]
    kw = dict(OP_ATTRS[case])
    name = op_name(case)
    if name == 'dpsgd':
        kw['sigma'] = 1.0
    plain = []
    gen = torch.Generator().manual_seed(3)
    for args in inputs:
        if name == 'dpsgd':
            kw['key'] = gen
        res = getattr(ops, name)(*[torch.from_numpy(a) for a in args], **kw)
        plain.append(res if isinstance(res, tuple) else (res,))
    lists = [[torch.from_numpy(a.copy()) for a in col]
             for col in zip(*inputs)]
    if name == 'dpsgd':
        kw['key'] = torch.Generator().manual_seed(3)
    has_lr = 'lr' in inspect.signature(getattr(ops, name)).parameters
    args = lists[:-1] + [lists[-1][0]] if has_lr else lists
    getattr(ops, f'multi_tensor_{name}')(*args, **kw)
    # the multi-tensor form updates the parameters and the slots in place,
    # in the order of the op's outputs
    updated = [lists[0]] + lists[2:]
    for i, outs in enumerate(plain):
        for k, out in enumerate(outs):
            assert torch.equal(updated[k][i], out), (i, k)
    assert not torch.equal(lists[0][3], torch.zeros(SHAPES[3])) or \
        name == 'ftrl'


def test_dpsgd_noise_has_the_stated_deviation():
    n, clip, batch_size, sigma = 200_000, 1.0, 4.0, 2.0
    rng = np.random.default_rng(0)
    p = np.zeros(n, np.float32)
    g = (rng.standard_normal(n) * 0.01).astype(np.float32)   # norm ~4.5
    lr = np.asarray([1.0], np.float32)
    kw = {'clip': clip, 'batch_size': batch_size, 'sigma': sigma}
    jp = np.asarray(jops.dpsgd(p, g, lr, key=jax.random.PRNGKey(1), **kw))
    tp = ops.dpsgd(torch.from_numpy(p), torch.from_numpy(g),
                   torch.from_numpy(lr),
                   key=torch.Generator().manual_seed(1), **kw).numpy()
    clipped = g / max(1.0, np.linalg.norm(g.astype(np.float64)) / clip)
    dev = sigma * clip / batch_size
    for new in (jp, tp):
        noise = -new - clipped
        assert abs(noise.mean()) < 0.05 * dev
        assert abs(noise.std() - dev) < 0.05 * dev
    assert not np.allclose(jp, tp)


# ------------------------------------------------------- dygraph, the rules

def bias(p):
    """A bias: a static layer's ``.b_0``, a dygraph Linear's ``.w_1``."""
    return p.name.endswith(('.b_0', '.w_1'))


# rule -> (class, rate, keywords)
RULES = {
    'lars': ('LarsMomentum', 0.1, {'exclude_from_weight_decay_fn': bias}),
    'adamax': ('Adamax', 0.01, {}),
    'adagrad': ('Adagrad', 0.1, {'initial_accumulator_value': 0.1}),
    'decayed_adagrad': ('DecayedAdagrad', 0.05, {}),
    'rmsprop': ('RMSProp', 0.01, {}),
    'rmsprop_centered': ('RMSProp', 0.01, {'centered': True,
                                           'momentum': 0.9}),
    'adadelta': ('Adadelta', 1.0, {}),
    'ftrl': ('Ftrl', 0.1, {'l1': 0.001, 'l2': 0.01}),
    'lamb': ('Lamb', 0.01, {'exclude_from_weight_decay_fn': bias}),
    'dgc': ('DGCMomentumOptimizer', 0.1, {'sparsity': [0.5]}),
}
STEPS = 3


def mlp_data():
    rng = np.random.default_rng(11)
    w1 = rng.standard_normal((4, 3)).astype(np.float32)
    w2 = rng.standard_normal((3, 2)).astype(np.float32)
    xs = [rng.standard_normal((5, 4)).astype(np.float32) * 2
          for _ in range(STEPS)]
    return w1, w2, xs


def mlp_run(pkg, make_opt, each_step=None, steps=STEPS):
    """``steps`` ``minimize`` steps of the MLP in ``pkg``: the parameters
    and the optimizer."""
    dy, lay = (dygraph, layers) if pkg is fluid else (jdy, jlayers)
    w1, w2, xs = mlp_data()
    with dy.guard(CPU if pkg is fluid else None):
        fc1 = dy.Linear(4, 3, act='relu')
        fc2 = dy.Linear(3, 2)
        fc1.weight.set_value(w1)
        fc2.weight.set_value(w2)
        params = fc1.parameters() + fc2.parameters()
        opt = make_opt(pkg, params)
        for x in xs[:steps]:
            loss = lay.reduce_mean(fc2(fc1(dy.to_variable(x))))
            loss.backward()
            opt.minimize(loss)
            for p in params:
                p.clear_gradient()
            if each_step is not None:
                each_step(opt, params)
        return [np.array(p.numpy()) for p in params], opt


def rule(name):
    cls, lr, kw = RULES[name]
    return lambda pkg, params: getattr(pkg.optimizer, cls)(
        lr, parameter_list=params, **kw)


@pytest.mark.parametrize('name', list(RULES))
def test_dygraph_rule_matches_jax(name):
    got, _ = mlp_run(fluid, rule(name))
    want, _ = mlp_run(jfluid, rule(name))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert not np.allclose(got[0], mlp_data()[0], atol=1e-4)
    assert np.abs(got[1]).max() > 0          # the biases left zero


@pytest.mark.parametrize('name', ['lars', 'lamb'])
def test_excluded_parameters_take_no_weight_decay(name):
    """Over one step the excluded biases move as they do with weight
    decay 0 for every parameter; the weights do not."""
    cls, lr, kw = RULES[name]
    key = 'lars_weight_decay' if name == 'lars' else 'lamb_weight_decay'

    def no_decay(pkg, params):
        return getattr(pkg.optimizer, cls)(lr, parameter_list=params,
                                           **{key: 0.0})

    got, _ = mlp_run(fluid, rule(name), steps=1)
    want, _ = mlp_run(fluid, no_decay, steps=1)
    for i in (1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    assert not np.array_equal(got[0], want[0])


def test_dygraph_dpsgd_clips_as_gradient_clip_by_norm():
    """At ``sigma`` 0 Dpsgd is SGD on each gradient clipped to norm
    ``clip``; the JAX package's dygraph Dpsgd raises (no PRNG key)."""
    def dpsgd(pkg, params):
        return pkg.optimizer.Dpsgd(0.1, clip=0.05, sigma=0.0,
                                   parameter_list=params)

    def sgd(pkg, params):
        return pkg.optimizer.SGD(0.1, parameter_list=params,
                                 grad_clip=pkg.clip.GradientClipByNorm(0.05))

    got, _ = mlp_run(fluid, dpsgd)
    want, _ = mlp_run(jfluid, sgd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    with pytest.raises(TypeError, match='PRNG key'):
        mlp_run(jfluid, dpsgd)


def test_state_dict_carries_the_jax_slot_names():
    """Lamb's slots after one step, loaded into a fresh optimizer by
    ``set_dict``, and into the JAX package's from the same arrays: the
    next two steps agree (atol 1e-5)."""
    w1, w2, xs = mlp_data()

    def steps(pkg, slots=None):
        dy, lay = (dygraph, layers) if pkg is fluid else (jdy, jlayers)
        # each run names its Linear linear_0, as the state's keys do
        with dy.guard(CPU if pkg is fluid else None), \
                pkg.unique_name.guard():
            fc = dy.Linear(4, 3)
            fc.weight.set_value(w1)
            opt = pkg.optimizer.Lamb(0.01, parameter_list=fc.parameters())
            if slots is not None:
                if pkg is fluid:
                    opt.set_dict(slots)
                else:
                    for p in fc.parameters():
                        opt._dy_slots[p.name] = {
                            s: jnp.asarray(slots[f'{p.name}_{s}'])
                            for s in opt._slot_names}
            for x in (xs if slots is None else xs[1:]):
                lay.reduce_mean(fc(dy.to_variable(x))).backward()
                opt.minimize(None)
                fc.clear_gradients()
                if slots is None:
                    return {k: np.array(v) for k, v in
                            opt.state_dict().items()}, None
            return None, [p.numpy() for p in fc.parameters()]

    state, _ = steps(fluid)
    assert sorted(state) == sorted(
        [f'linear_0.{w}_{s}' for w in ('w_0', 'w_1')
         for s in fluid.optimizer.Lamb._slot_names] + ['global_step'])
    _, got = steps(fluid, state)
    _, want = steps(jfluid, state)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


# ---------------------------------------------- static LeNet, the rules

STATIC_RULES = {
    'lars': lambda f: f.optimizer.LarsMomentum(
        0.01, exclude_from_weight_decay_fn=bias),
    'adamax': lambda f: f.optimizer.Adamax(0.001),
    'adagrad': lambda f: f.optimizer.Adagrad(
        0.01, initial_accumulator_value=0.1),
    'decayed_adagrad': lambda f: f.optimizer.DecayedAdagrad(0.01),
    'rmsprop_centered': lambda f: f.optimizer.RMSProp(
        0.001, centered=True, momentum=0.9),
    'adadelta': lambda f: f.optimizer.Adadelta(1.0),
    # l1 0: the update is continuous (at l1 > 0 an entry whose linear
    # accumulator sits at the threshold goes to 0 in one package alone);
    # the first step divides the gradient by |g| / lr + 2 * l2, which
    # multiplies a small gradient's round-off by up to 1 / (2 l2): 5 here
    'ftrl': lambda f: f.optimizer.Ftrl(0.01, l1=0.0, l2=0.1),
    'lamb': lambda f: f.optimizer.Lamb(0.001,
                                       exclude_from_weight_decay_fn=bias),
    'dpsgd': lambda f: f.optimizer.Dpsgd(0.01, clip=1.0, sigma=0.0),
    'dgc': lambda f: f.optimizer.DGCMomentumOptimizer(0.01,
                                                      sparsity=[0.9]),
}


@pytest.mark.parametrize('name', list(STATIC_RULES))
def test_static_lenet_three_steps_match_jax(name, monkeypatch):
    monkeypatch.setitem(tsg.OPTIMIZERS, name, STATIC_RULES[name])
    (jexe, jscope, jm, jl, _, _), (texe, tscope, tm, tl, _, _) = \
        carried_across(name)
    assert tsg._ops(tm) == tsg._ops(jm)
    assert tsg._vars(tm) == tsg._vars(jm)
    names = persistables(tm)
    start = {n: tscope.find(n).numpy().copy() for n in names}
    wexe, wm, wscope = lenet_witness(tm, start)
    want, got = [], []
    states = {'jax': [], 'port': [], 'witness': []}
    for step in range(3):
        x, y = batch(10 + step)
        feed = {'img': x, 'label': y}
        want.append(jexe.run(jm, feed=feed, fetch_list=[jl],
                             scope=jscope)[0])
        got.append(texe.run(tm, feed=feed, fetch_list=[tl],
                            scope=tscope)[0])
        wexe.run(wm, feed=feed, fetch_list=[tl.name], scope=wscope)
        states['jax'].append({n: np.asarray(jscope.find(n)) for n in names})
        states['port'].append({n: tscope.find(n).numpy().copy()
                               for n in names})
        states['witness'].append({n: wscope.find(n).numpy().copy()
                                  for n in names})
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for n in names:
        np.testing.assert_allclose(states['port'][0][n],
                                   states['jax'][0][n], atol=1e-4, rtol=0,
                                   err_msg=n)
    for s, n, reading, bound in lenet_readings(
            states['port'], states['jax'], states['witness'], start, 1e-5):
        assert reading <= bound, (s, n, reading, bound)
    w = 'conv2d_0.w_0'
    assert not np.array_equal(states['port'][-1][w], start[w])


def lars_program(exclude):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data('img', [1, 28, 28], dtype='float32')
        label = fluid.layers.data('label', [1], dtype='int64')
        loss, _, _ = tsg.build_static_lenet(img, label)
        fluid.optimizer.LarsMomentum(
            0.01, exclude_from_weight_decay_fn=bias if exclude else None
        ).minimize(loss)
    return main, startup, loss


def test_fused_lars_groups_excluded_parameters_apart(monkeypatch):
    main, startup, loss = lars_program(exclude=True)
    bs = BuildStrategy()
    bs.fuse_all_optimizer_ops = True
    opt, ctx = fluid.ir.apply_pipeline(main, [loss.name], build_strategy=bs)
    fused = [op for op in opt.global_block().ops
             if op.type == 'fused_lars_momentum']
    assert op_types(opt).count('lars_momentum') == 0 and len(fused) == 2
    decays = sorted(op.attrs['lars_weight_decay'] for op in fused)
    assert decays == [0.0, 0.0005]
    excluded = next(op for op in fused
                    if op.attrs['lars_weight_decay'] == 0.0)
    assert all(bias(main.global_block().var(n))
               for n in excluded.inputs['params'])
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    start = {n: scope.find(n).numpy().copy() for n in persistables(main)}
    x, y = batch(3)
    feed = {'img': x, 'label': y}
    plain_bs = BuildStrategy()
    off = port_steps(main, [loss.name], feed, start, monkeypatch, '1',
                     plain_bs)
    on = port_steps(main, [loss.name], feed, start, monkeypatch, '1', bs)
    assert_bitwise(off, on)
    assert not np.array_equal(on[-1][1]['conv2d_0.w_0'],
                              start['conv2d_0.w_0'])


def test_fused_lars_momentum_gives_the_per_parameter_bits():
    gen = torch.Generator().manual_seed(0)
    ps = [torch.randn(s, generator=gen) for s in SHAPES]
    ps[3] = torch.zeros(SHAPES[3])
    gs = [torch.randn(s, generator=gen) for s in SHAPES]
    gs[4] = torch.zeros(SHAPES[4])
    vs = [torch.randn(s, generator=gen) for s in SHAPES]
    lr = torch.tensor([0.1])
    kw = OP_ATTRS['lars_momentum']
    new_p, new_v = fused_ops.fused_lars_momentum(ps, gs, vs, lr, **kw)
    for p, g, v, fp, fv in zip(ps, gs, vs, new_p, new_v):
        want_p, want_v = ops.lars_momentum(p, g, v, lr, **kw)
        assert torch.equal(fp, want_p) and torch.equal(fv, want_v)


# ----------------------------------------- decoupled weight decay (AdamW)

def test_decoupled_weight_decay_dygraph_matches_jax():
    def adamw(pkg, params):
        cls = (ext if pkg is fluid else jext) \
            .extend_with_decoupled_weight_decay(pkg.optimizer.Adam)
        return cls(0.1, learning_rate=0.01, parameter_list=params)

    got, opt = mlp_run(fluid, adamw)
    want, _ = mlp_run(jfluid, adamw)
    assert type(opt).__name__ == 'AdamOptimizerWithDecoupledWeightDecay'
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    plain, _ = mlp_run(fluid, lambda pkg, params: pkg.optimizer.Adam(
        0.01, parameter_list=params))
    assert not np.allclose(got[0], plain[0], atol=1e-5)


def static_mlp(pkg, make_opt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data('x', [4], dtype='float32')
        h = pkg.layers.fc(x, 3, param_attr=pkg.ParamAttr(name='w1'),
                          act='relu')
        out = pkg.layers.fc(h, 2, param_attr=pkg.ParamAttr(name='w2'))
        loss = pkg.layers.reduce_mean(out)
        make_opt(pkg).minimize(loss)
    return main, startup, loss


def int_vars(program):
    """``tsg._vars`` with int64 read as int32: the JAX package, with
    JAX's 64-bit types off, makes the gradient merge's int64
    ``fill_constant`` and ``elementwise_mod`` int32."""
    return [(n, s, 'int32' if d == 'int64' else d, *rest)
            for n, s, d, *rest in tsg._vars(program)]


def static_mlp_parity(make_opt, atol, steps=STEPS, passes=False):
    """The MLP program in both packages, the JAX startup values carried
    across, ``steps`` runs on the same feeds: the port's program and its
    parameters after the runs."""
    jm, js, jl = static_mlp(jfluid, make_opt)
    tm, ts, tl = static_mlp(fluid, make_opt)
    assert tsg._ops(tm) == tsg._ops(jm)
    assert int_vars(tm) == int_vars(jm)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = fluid.Executor(CPU), fluid.Scope()
    # the JAX package's int64 step counters are int32 (see int_vars)
    scope_from_paddle({n: np.asarray(jscope.find(n)).astype(
        tm.global_block().var(n).dtype) for n in persistables(jm)},
        tscope, CPU, program=tm)
    xs = (mlp_data()[2] * 2)[:steps]
    for x in xs:
        jloss, = jexe.run(jm, feed={'x': x}, fetch_list=[jl], scope=jscope)
        tloss, = texe.run(tm, feed={'x': x}, fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(tloss, np.asarray(jloss), rtol=1e-5,
                                   atol=1e-6)
    params = ['w1', 'fc_0.b_0', 'w2', 'fc_1.b_0']
    for n in params:
        np.testing.assert_allclose(tscope.find(n).numpy(),
                                   np.asarray(jscope.find(n)), atol=atol,
                                   rtol=0, err_msg=n)
    return tm, {n: tscope.find(n).numpy() for n in params}


def test_decoupled_weight_decay_static_matches_jax():
    def adamw(pkg):
        cls = (ext if pkg is fluid else jext) \
            .extend_with_decoupled_weight_decay(pkg.optimizer.Adam)
        return cls(0.1, learning_rate=0.01)

    tm, _ = static_mlp_parity(adamw, 1e-5)
    t = op_types(tm)
    after = t[t.index('__backward__') + 1:]
    # scale of the rate, the product, the subtraction, then the update
    assert after[:4] == ['scale', 'elementwise_mul', 'elementwise_sub',
                         'adam']
    assert after.count('adam') == 4


# ------------------------------------------ Lookahead, averages, merge

def test_lookahead_matches_jax():
    def lookahead(pkg, params):
        return pkg.optimizer.LookaheadOptimizer(
            pkg.optimizer.SGD(0.1, parameter_list=params), alpha=0.5, k=2)

    got, opt = mlp_run(fluid, lookahead)
    want, _ = mlp_run(jfluid, lookahead)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    assert opt._step == STEPS and len(opt._slow) == 4


@pytest.mark.parametrize('what', ['model_average', 'ema'])
def test_averages_match_jax_after_k_steps(what):
    """``ModelAverage.accumulate`` or ``ExponentialMovingAverage.update``
    after each of three SGD steps; the averages swapped in and out: atol
    1e-6."""
    out = {}
    for pkg in (fluid, jfluid):
        avg = (pkg.optimizer.ModelAverage(0.15) if what == 'model_average'
               else pkg.optimizer.ExponentialMovingAverage(0.9))

        def each_step(opt, params, avg=avg, pkg=pkg):
            if pkg is jfluid and what == 'model_average':
                # the JAX package's first accumulate keeps the parameter's
                # array itself, which its next donated step deletes
                # (ROADMAP C.16): give it copies
                params = [types.SimpleNamespace(name=p.name,
                                                value=jnp.array(p.value))
                          for p in params]
            (avg.accumulate if what == 'model_average'
             else avg.update)(params)

        def sgd_with(pkg, params, avg=avg):
            opt = pkg.optimizer.SGD(0.1, parameter_list=params)
            opt.avg, opt.params = avg, params
            return opt

        weights, opt = mlp_run(pkg, sgd_with, each_step)
        dy = dygraph if pkg is fluid else jdy
        with dy.guard(CPU if pkg is fluid else None):
            if what == 'model_average':
                with avg.apply():
                    pass
                avg.apply_params(opt.params)
            else:
                avg.apply(opt.params)
            averaged = [np.array(p.numpy()) for p in opt.params]
            (avg.restore_params if what == 'model_average'
             else avg.restore)(opt.params)
            restored = [np.array(p.numpy()) for p in opt.params]
        out[pkg] = (weights, averaged, restored)
    for got, want in zip(out[fluid], out[jfluid]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    weights, averaged, restored = out[fluid]
    for w, r in zip(weights, restored):
        np.testing.assert_array_equal(w, r)
    assert not np.allclose(weights[0], averaged[0], atol=1e-4)


@pytest.mark.parametrize('passes', [False, True], ids=['plain', 'passes'])
def test_static_gradient_merge_matches_jax(passes, monkeypatch):
    """``GradientMergeOptimizer(Adam, k_steps=2)`` over four runs: the
    updates sit in a ``cond`` sub-block; the port's parameters equal the
    JAX package's (atol 1e-5), and with the fuse passes on (which read
    the global block alone) the port's runs equal its plain runs bit for
    bit."""
    def merged(pkg):
        return pkg.optimizer.GradientMergeOptimizer(
            pkg.optimizer.Adam(0.01), k_steps=2)

    tm, _ = static_mlp_parity(merged, 1e-5, steps=4)
    sub = tm.blocks[1:]
    assert [op.type for b in sub for op in b.ops].count('adam') == 4
    assert 'adam' not in op_types(tm) and '__cond__' in op_types(tm)
    if passes:
        exe, scope = fluid.Executor(CPU), fluid.Scope()
        tm2, ts2, tl2 = static_mlp(fluid, merged)
        exe.run(ts2, scope=scope)
        start = {n: scope.find(n).numpy().copy()
                 for n in persistables(tm2)}
        feed = {'x': mlp_data()[2][0]}
        bs = BuildStrategy()
        bs.fuse_all_optimizer_ops = True
        bs.fuse_elewise_add_act_ops = True
        off = port_steps(tm2, [tl2.name], feed, start, monkeypatch, '0',
                         BuildStrategy(), steps=4)
        on = port_steps(tm2, [tl2.name], feed, start, monkeypatch, '1', bs,
                        steps=4)
        assert_bitwise(off, on)


def test_gradient_merge_and_pipeline_raise_as_documented():
    with dygraph.guard(CPU):
        opt = fluid.optimizer.GradientMergeOptimizer(
            fluid.optimizer.SGD(0.1), k_steps=2)
        with pytest.raises(RuntimeError, match='static-graph'):
            opt.minimize(torch.zeros(()))
    with pytest.raises(NotImplementedError, match='ROADMAP A[.]9'):
        fluid.optimizer.PipelineOptimizer(fluid.optimizer.SGD(0.1))


def test_every_jax_optimizer_name_is_exported():
    import paddle_tpu.optimizer as jopt
    names = [n for n, v in vars(jopt).items()
             if isinstance(v, type) and v.__module__ == jopt.__name__
             and n[0] != '_']
    assert len(names) == 32
    for n in names:
        assert hasattr(fluid.optimizer, n), n
    for alias, cls in (('Lamb', 'LambOptimizer'),
                       ('LarsMomentum', 'LarsMomentumOptimizer'),
                       ('Dpsgd', 'DpsgdOptimizer')):
        assert getattr(fluid.optimizer, alias) is \
            getattr(fluid.optimizer, cls)
