"""The port's regularizers, gradient clips and AMP's ``decorate``
(paddle_tpu_torch/{regularizer, clip, optimizer}.py,
contrib/mixed_precision.py) against the JAX package's, on the CPU.

- Dygraph: two Linear layers (4 -> 3 relu -> 2) from one set of numpy
  weights, three ``minimize`` calls in both packages with each regularizer
  (L2Decay, L1Decay, a ParamAttr regularizer that wins over the
  optimizer's) and each clip (by value, by norm, by global norm), under
  SGD and Adam. Parameters within atol 1e-6 for SGD (the same f32
  operations, sums in another order) and 1e-5 for Adam (a step of about lr
  * m / sqrt(v) moves with round-off in small gradients).
- Static graph: the same model as a Program in both packages (``fc``
  layers): the programs hold the same ops with the same slots, names and
  variables, and three executor steps from the JAX startup values
  (``convert.scope_from_paddle``) give the same parameters at the same
  tolerances. Without ``grad_clip=``, a clip that ``set_gradient_clip``
  recorded on the program applies.
- ``decorate``: over a run with injected inf and NaN gradients, the port
  skips the same updates, counts the same skips and moves the loss scale
  as the JAX package does; the static path raises naming A.8e.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import dygraph as jdy
from paddle_tpu import layers as jlayers
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu_torch import dygraph, layers
from paddle_tpu_torch.contrib import mixed_precision as mp
from paddle_tpu_torch.convert import scope_from_paddle
from torch_jax_seed import jax_seed_pinned  # noqa: F401

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_programs():
    """Fresh default programs, scope and name counter of the port, as
    tests/conftest.py gives the JAX package's, so both packages name a
    program's variables alike."""
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


# case -> (optimizer, its rate, regularization, grad_clip, the first
# layer's ParamAttr regularizer); regularizers and clips as
# (module, class, argument), built in each package
CASES = {
    'l2': ('SGD', 0.1, ('regularizer', 'L2Decay', 0.1), None, None),
    'l1': ('SGD', 0.1, ('regularizer', 'L1Decay', 0.1), None, None),
    'param_attr': ('SGD', 0.1, ('regularizer', 'L2Decay', 0.1), None,
                   ('regularizer', 'L1Decay', 0.3)),
    'by_value': ('SGD', 0.1, None, ('clip', 'GradientClipByValue', 0.05),
                 None),
    'by_norm': ('SGD', 0.1, None, ('clip', 'GradientClipByNorm', 0.1),
                None),
    'global_norm': ('SGD', 0.1, None,
                    ('clip', 'GradientClipByGlobalNorm', 0.1), None),
    'adam_l2_global_norm': ('Adam', 0.01, ('regularizer', 'L2Decay', 0.01),
                            ('clip', 'GradientClipByGlobalNorm', 0.1),
                            None),
}
STEPS = 3


def _make(pkg, spec):
    if spec is None:
        return None
    module, cls, arg = spec
    return getattr(getattr(pkg, module), cls)(arg)


def _optimizer(pkg, case, **kw):
    name, lr, reg, clip, _ = CASES[case]
    return getattr(pkg.optimizer, name)(
        lr, regularization=_make(pkg, reg), grad_clip=_make(pkg, clip), **kw)


def _atol(case):
    return 1e-5 if CASES[case][0] == 'Adam' else 1e-6


def _data():
    rng = np.random.default_rng(11)
    w1 = rng.standard_normal((4, 3)).astype(np.float32)
    w2 = rng.standard_normal((3, 2)).astype(np.float32)
    xs = [rng.standard_normal((5, 4)).astype(np.float32) * 2
          for _ in range(STEPS)]
    return w1, w2, xs


def _dygraph_run(pkg, dy, lay, case):
    w1, w2, xs = _data()
    with dy.guard(CPU if pkg is fluid else None):
        attr = pkg.ParamAttr(regularizer=_make(pkg, CASES[case][4]))
        fc1 = dy.Linear(4, 3, param_attr=attr, act='relu')
        fc2 = dy.Linear(3, 2)
        fc1.weight.set_value(w1)
        fc2.weight.set_value(w2)
        params = fc1.parameters() + fc2.parameters()
        opt = _optimizer(pkg, case, parameter_list=params)
        for x in xs:
            loss = lay.reduce_mean(fc2(fc1(dy.to_variable(x))))
            loss.backward()
            opt.minimize(loss)
            for p in params:
                p.clear_gradient()
        return [p.numpy() for p in params]


@pytest.mark.parametrize('case', list(CASES))
def test_dygraph_minimize_matches_jax(case):
    got = _dygraph_run(fluid, dygraph, layers, case)
    want = _dygraph_run(jfluid, jdy, jlayers, case)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=_atol(case), rtol=0)
    w1 = _data()[0]
    assert not np.allclose(got[0], w1, atol=1e-3)     # the steps moved it


def test_regularized_minimize_leaves_the_gradient_as_it_was():
    with dygraph.guard(CPU):
        fc = dygraph.Linear(3, 2)
        opt = _optimizer(fluid, 'adam_l2_global_norm',
                         parameter_list=fc.parameters())
        layers.reduce_sum(fc(dygraph.to_variable(np.ones((2, 3))))).backward()
        g = fc.weight.gradient()
        opt.minimize(None)
        np.testing.assert_array_equal(fc.weight.gradient(), g)


def _static_build(pkg, case, program_clip=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data('x', [4], dtype='float32')
        attr = pkg.ParamAttr(name='w1',
                             regularizer=_make(pkg, CASES[case][4]))
        h = pkg.layers.fc(x, 3, param_attr=attr, act='relu')
        out = pkg.layers.fc(h, 2, param_attr=pkg.ParamAttr(name='w2'))
        loss = pkg.layers.reduce_mean(out)
        if program_clip:
            name, lr, reg, clip, _ = CASES[case]
            pkg.clip.set_gradient_clip(_make(pkg, clip))
            getattr(pkg.optimizer, name)(
                lr, regularization=_make(pkg, reg)).minimize(loss)
        else:
            _optimizer(pkg, case).minimize(loss)
    return main, startup, loss


def _ops(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


def _vars(program):
    return [(v.name, v.shape, v.dtype, v.persistable)
            for v in program.list_vars()]


def _static_case(case, program_clip=False):
    jm, js, jl = _static_build(jfluid, case, program_clip)
    tm, ts, tl = _static_build(fluid, case, program_clip)
    assert _ops(tm) == _ops(jm)
    assert _vars(tm) == _vars(jm)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = fluid.Executor(CPU), fluid.Scope()
    names = sorted(v.name for v in jm.list_vars() if v.persistable)
    scope_from_paddle({n: np.asarray(jscope.find(n)) for n in names},
                      tscope, CPU, program=tm)
    for x in _data()[2]:
        jloss, = jexe.run(jm, feed={'x': x}, fetch_list=[jl], scope=jscope)
        tloss, = texe.run(tm, feed={'x': x}, fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(np.asarray(tloss), np.asarray(jloss),
                                   rtol=1e-5, atol=1e-6)
    params = [v.name for v in jm.global_block().all_parameters()]
    assert params == ['w1', 'fc_0.b_0', 'w2', 'fc_1.b_0']
    for n in params:
        got = tscope.find(n).numpy()
        np.testing.assert_allclose(got, np.asarray(jscope.find(n)),
                                   atol=_atol(case), rtol=0, err_msg=n)
    return [op.type for op in tm.global_block().ops]


@pytest.mark.parametrize('case', list(CASES))
def test_static_minimize_matches_jax(case):
    types = _static_case(case)
    after = types[types.index('__backward__') + 1:]
    opt, _, reg, clip, attr_reg = CASES[case]
    if reg or attr_reg:
        assert 'elementwise_add' in after
    if (reg and reg[1] == 'L1Decay') or attr_reg:
        assert 'sign' in after
    want = {'GradientClipByValue': 'clip',
            'GradientClipByNorm': 'clip_by_norm',
            'GradientClipByGlobalNorm': 'elementwise_max'}
    if clip:
        assert want[clip[1]] in after
    assert after[-4:] == [opt.lower()] * 4


def test_static_set_gradient_clip_applies_without_grad_clip():
    types = _static_case('global_norm', program_clip=True)
    assert 'sqrt' in types and 'elementwise_max' in types


# ------------------------------------------------------------ decorate

# gradient scale of each call: 1, inf, NaN and 1 again; every call's
# update is compared
SCALES = [1.0, float('inf'), 1.0, float('nan'), 1.0, 1.0]


def _amp_run(pkg, dy, lay, decorate):
    w1, w2, xs = _data()
    rng = np.random.default_rng(3)
    out = []
    with dy.guard(CPU if pkg is fluid else None):
        fc = dy.Linear(4, 3)
        fc.weight.set_value(w1)
        opt = decorate(pkg.optimizer.Adam(0.01,
                                          parameter_list=fc.parameters()),
                       init_loss_scaling=8.0, incr_every_n_steps=2,
                       decr_every_n_nan_or_inf=1, decr_ratio=0.5)
        for s in SCALES:
            x = rng.standard_normal((5, 4)).astype(np.float32)
            y = fc(dy.to_variable(x))
            loss = lay.reduce_mean(lay.elementwise_mul(
                y, dy.to_variable(np.full((1,), s, np.float32))))
            loss.backward()
            opt.minimize(loss)
            fc.clear_gradients()
            out.append((fc.weight.numpy().copy(), opt.get_loss_scaling(),
                        opt.overflow_steps()))
    return out


def test_decorate_skips_overflow_steps_as_the_jax_package_does():
    got = _amp_run(fluid, dygraph, layers, mp.decorate)
    want = _amp_run(jfluid, jdy, jlayers, jmp.decorate)
    for (gw, gs, gk), (ww, ws, wk) in zip(got, want):
        np.testing.assert_allclose(gw, ww, atol=1e-6, rtol=0)
        assert (gs, gk) == (ws, wk)
    assert [k for _, _, k in got] == [0, 1, 1, 2, 2, 2]
    assert [s for _, s, _ in got] == [8.0, 4.0, 4.0, 2.0, 2.0, 4.0]
    np.testing.assert_array_equal(got[1][0], got[0][0])     # skipped
    assert not np.array_equal(got[2][0], got[1][0])


def test_decorate_forwards_to_the_inner_optimizer_and_static_raises():
    with dygraph.guard(CPU):
        fc = dygraph.Linear(3, 2)
        inner = fluid.optimizer.Adam(0.01, parameter_list=fc.parameters())
        opt = mp.decorate(inner)
    assert opt._parameter_list is inner._parameter_list
    assert isinstance(opt._amp_lists, mp.AutoMixedPrecisionLists)
    assert 'matmul' in opt._amp_lists.white_list
    # the static graph (A.8e): minimize records the cast lists on the
    # program and appends the inner optimizer's update
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data('x', [3], dtype='float32')
        loss = fluid.layers.reduce_mean(fluid.layers.fc(x, 2))
        version = main._version
        mp.decorate(fluid.optimizer.SGD(0.1)).minimize(loss)
    amp = main._amp_config
    assert amp['dtype'] == torch.bfloat16
    assert amp['white'] == frozenset(opt._amp_lists.white_list)
    assert amp['black'] == frozenset(opt._amp_lists.black_list)
    assert main._version > version
    assert [op.type for op in main.global_block().ops].count('sgd') == 2


def test_cast_model_to_bf16():
    with dygraph.guard(CPU):
        fc = dygraph.Linear(3, 2)
        assert mp.cast_model_to_bf16(fc) is fc
        assert {p.dtype for p in fc.parameters()} == {torch.bfloat16}
