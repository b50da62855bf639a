"""The port's NaN/Inf checks (``debugging``, the Executor's
``FLAGS_check_nan_inf`` fetch scan, ``debugger``'s fast NaN search) and
``install_check`` (ROADMAP A.13) against the JAX package's, on the CPU.

- ``nonfinite_summary``, ``check_numerics`` (messages included) and
  ``assert_all_finite`` agree with the JAX package's on the same arrays
  and nested dicts and lists; the port's also read torch tensors.
- ``FLAGS_check_nan_inf`` arms the check when the module is imported.
  With the check on, a NaN-fed ``Executor.run`` raises
  ``FloatingPointError`` naming the fetch in both packages, with the same
  message; with it off, ``run`` returns the NaN and the scan never runs.
- ``debugger.run_fast_nan_inf_debug`` names the op that first makes a NaN,
  in both packages.
- ``install_check`` trains its step with ``place=CPUPlace()``; without a
  card ``run_check()`` raises the port's missing-card error (it never
  carries on on the CPU).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import debugging as jdbg
from paddle_tpu_torch import debugging
from paddle_tpu_torch import executor as executor_mod
from paddle_tpu_torch.convert import scope_from_paddle
from test_torch_static_graph import fresh_port_programs  # noqa: F401
from torch_jax_seed import jax_seed_pinned  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def check_off_after():
    """Both packages' switches off after each test (the JAX package's also
    turns jax_debug_nans off)."""
    yield
    debugging.enable_check_nan_inf(False)
    jdbg.enable_check_nan_inf(False)


def arrays():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = a.copy()
    b[0, 1], b[1, 2] = np.nan, np.inf
    return a, b


CASES = {
    'finite': lambda a, b: a,
    'nonfinite': lambda a, b: b,
    'ints': lambda a, b: np.arange(4),
    'inf_only': lambda a, b: np.array([np.inf, -np.inf, 1.0]),
    'scalar_nan': lambda a, b: np.float32(np.nan),
    'dict': lambda a, b: {'loss': b, 'acc': a, 'grads': [a, b]},
    'nested': lambda a, b: {'z': {'y': (b, None, a)}, 'a': [[a], [b]]},
    'list': lambda a, b: [a, b, b],
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_check_numerics_matches_jax(case):
    value = CASES[case](*arrays())
    if hasattr(value, 'shape'):
        assert (debugging.nonfinite_summary(value)
                == jdbg.nonfinite_summary(value))

    def outcome(check):
        try:
            return check(value, 'fetched') is value, None
        except FloatingPointError as e:
            return None, str(e)

    assert outcome(debugging.check_numerics) == outcome(jdbg.check_numerics)


def test_check_numerics_reads_tensors():
    a, b = arrays()
    assert debugging.nonfinite_summary(torch.from_numpy(b)) == \
        jdbg.nonfinite_summary(b) == {'nan': 1, 'inf': 1, 'size': 6}
    assert debugging.nonfinite_summary(
        torch.from_numpy(b).bfloat16()) == {'nan': 1, 'inf': 1, 'size': 6}
    assert debugging.nonfinite_summary(torch.from_numpy(a)) is None
    with pytest.raises(FloatingPointError, match=r"\['x'\]: 1 NaN, 1 Inf"):
        debugging.check_numerics({'x': torch.from_numpy(b)}, 'fetches')


@pytest.mark.parametrize('case', ['finite', 'nonfinite', 'inf_only'])
def test_assert_all_finite_matches_jax(case):
    value = CASES[case](*arrays())
    got = debugging.assert_all_finite(torch.from_numpy(np.array(value)))
    want = np.asarray(jdbg.assert_all_finite(value))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want).all() == (case != 'finite')


def test_flag_is_read_at_import():
    code = ('import paddle_tpu_torch.debugging as d\n'
            'print(d.check_nan_inf_enabled())\n')
    for flag, want in (('1', 'True'), ('0', 'False'), ('', 'False')):
        env = {**os.environ, 'PYTHONPATH': REPO, 'FLAGS_check_nan_inf': flag}
        out = subprocess.run([sys.executable, '-c', code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.stdout.strip() == want, out.stderr


def test_enable_switch():
    assert debugging.check_nan_inf_enabled() is False
    debugging.enable_check_nan_inf()
    assert debugging.check_nan_inf_enabled() is True
    debugging.enable_check_nan_inf(False)
    assert debugging.check_nan_inf_enabled() is False


def regression(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.data('x', [4, 3], 'float32')
        y = pkg.data('y', [4, 1], 'float32')
        pred = pkg.layers.fc(x, 1)
        loss = pkg.layers.reduce_mean(pkg.layers.square_error_cost(pred, y))
        ids = pkg.layers.argmax(pred, axis=0)
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, pred, ids


def both_regressions():
    with jfluid.unique_name.guard():
        jm, js, jl, jp, ji = regression(jfluid)
    with fluid.unique_name.guard():
        tm, ts, tl, tp, ti = regression(fluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({v.name: np.asarray(jscope.find(v.name))
                       for v in jm.list_vars() if v.persistable}, scope,
                      fluid.CPUPlace(), program=tm)
    return ((exe, scope, tm, [tl, tp, ti]),
            (jexe, jscope, jm, [jl, jp, ji]))


def feeds(nan):
    x = np.ones((4, 3), np.float32)
    if nan:
        x[2, 1] = np.nan
    return {'x': x, 'y': np.zeros((4, 1), np.float32)}


def test_nan_fetch_raises_in_both_packages():
    import jax
    port, ref = both_regressions()
    debugging.enable_check_nan_inf()
    jdbg.enable_check_nan_inf()
    # the JAX package's fetch scan alone first (enable_check_nan_inf also
    # arms jax_debug_nans, which raises inside its step)
    jax.config.update('jax_debug_nans', False)
    got = port[0].run(port[2], feed=feeds(False), fetch_list=port[3],
                      scope=port[1])
    want = ref[0].run(ref[2], feed=feeds(False), fetch_list=ref[3],
                      scope=ref[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    with pytest.raises(FloatingPointError) as err:
        port[0].run(port[2], feed=feeds(True), fetch_list=port[3],
                    scope=port[1])
    message = str(err.value)
    assert repr(port[3][0].name) in message and 'fetches' in message
    assert repr(port[3][2].name) not in message       # ints are not scanned
    with pytest.raises(FloatingPointError) as jerr:
        ref[0].run(ref[2], feed=feeds(True), fetch_list=ref[3],
                   scope=ref[1])
    assert message == str(jerr.value)
    # with jax_debug_nans the JAX package raises at the producing op
    _, ref = both_regressions()
    jdbg.enable_check_nan_inf()
    with pytest.raises(FloatingPointError):
        ref[0].run(ref[2], feed=feeds(True), fetch_list=ref[3],
                   scope=ref[1])


def test_nan_fetch_with_the_check_off(monkeypatch):
    port, _ = both_regressions()

    def scan(*args):
        raise AssertionError('the fetch scan ran with the check off')
    monkeypatch.setattr(executor_mod, '_check_fetches_finite', scan)
    loss, pred, _ = port[0].run(port[2], feed=feeds(True),
                                fetch_list=port[3], scope=port[1])
    assert np.isnan(loss) and np.isnan(pred).any()


def test_nan_fetch_raises_on_device_tensors():
    port, _ = both_regressions()
    debugging.enable_check_nan_inf()
    with pytest.raises(FloatingPointError, match='1 NaN'):
        port[0].run(port[2], feed=feeds(True), fetch_list=port[3][:1],
                    scope=port[1], return_numpy=False)


def log_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.data('dx', [2, 2], 'float32')
        h = pkg.layers.log(x)
        out = pkg.layers.reduce_sum(h)
    return main, startup, out


@pytest.mark.parametrize('return_numpy', [True, False])
def test_fast_nan_inf_debug_names_the_op(return_numpy):
    from paddle_tpu import debugger as jdebugger
    with fluid.unique_name.guard():
        tm, ts, tout = log_program(fluid)
    with jfluid.unique_name.guard():
        jm, js, jout = log_program(jfluid)
    exe, jexe = fluid.Executor(fluid.CPUPlace()), jfluid.Executor()
    exe.run(ts)
    jexe.run(js)
    fluid.debugger.prepare_fast_nan_inf_debug(tm)
    assert tm._nan_inf_watch == jdebugger.prepare_fast_nan_inf_debug(
        jm)._nan_inf_watch
    ones = {'dx': np.ones((2, 2), np.float32)}
    r = fluid.debugger.run_fast_nan_inf_debug(
        exe, tm, feed=ones, fetch_list=[tout], return_numpy=return_numpy)
    assert np.isfinite(np.asarray(r[0])).all() and len(r) == 1
    bad = {'dx': -np.ones((2, 2), np.float32)}
    with pytest.raises(RuntimeError, match='NaN/Inf') as err:
        fluid.debugger.run_fast_nan_inf_debug(
            exe, tm, feed=bad, fetch_list=[tout], return_numpy=return_numpy)
    with pytest.raises(RuntimeError, match='NaN/Inf') as jerr:
        jdebugger.run_fast_nan_inf_debug(jexe, jm, feed=bad,
                                         fetch_list=[jout])
    assert str(err.value) == str(jerr.value)
    assert "'log'" not in str(err.value) and 'log(' in str(err.value)


# ------------------------------------------------------------ install check

def test_device_report():
    report = debugging.device_report().split('\n')
    assert report[0].startswith(f'torch {torch.__version__}, cuda ')
    assert report[1].startswith('devices: ')
    assert 'tf32 matmul' in report[2]


def test_install_check_on_the_cpu(caplog):
    assert debugging.install_check(place=fluid.CPUPlace()) is True
    fluid.install_check.run_check(fluid.CPUPlace())


def test_run_check_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device is available'):
        fluid.install_check.run_check()
    with pytest.raises(RuntimeError, match='no CUDA device is available'):
        debugging.install_check()
