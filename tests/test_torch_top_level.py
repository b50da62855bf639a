"""The port's Fluid top-level surface (ROADMAP A.13) against the JAX
package's, on the CPU.

- Every public top-level name of ``paddle_tpu`` and of
  ``paddle_tpu.contrib`` exists in the port, of the same kind (module,
  class or function). A name the port runs is defined by the port; a name
  it does not run yet is a stand-in that raises ``NotImplementedError``
  naming its ROADMAP item (a module on any public attribute). ``hasattr``
  on a name neither package has stays False, and
  ``import paddle_tpu_torch.fluid as fluid`` gives the package itself.
- ``device_guard``, ``load_op_library``, ``require_version``, ``enabled``,
  the places, ``WeightNormParamAttr`` (inert in the JAX package: ROADMAP
  C.4 item 10), ``log_helper``, ``annotations``, ``default_scope_funcs``,
  ``input``, ``transpiler``, ``utils``: as the JAX package's, on the same
  programs and values.
- ``op``'s protos and creation methods, ``debugger``'s reprs, pretty
  print and dot text and ``net_drawer``'s dot text equal the JAX
  package's, text for text, on the same programs built under fresh name
  counters in both packages (LeNet with Adam, and
  tests/framework/test_fluid_long_tail.py's small programs).
- ``contrib.model_stat.summary``, ``contrib.op_freq_statistic`` and
  ``contrib.memory_usage`` equal the JAX package's on LeNet with Adam.
"""
import inspect
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.contrib as jcontrib
import paddle_tpu_torch as fluid
from paddle_tpu.models.lenet import build_static_lenet as jax_lenet
from paddle_tpu_torch import contrib
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.models.lenet import build_static_lenet
from test_torch_static_graph import fresh_port_programs  # noqa: F401
from torch_jax_seed import jax_seed_pinned  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# dir(paddle_tpu) and dir(paddle_tpu.contrib), public names, in a fresh
# process (test_the_name_lists_are_the_jax_packages holds them to it)
JAX_NAMES = [
    'CPUPlace', 'CUDAPinnedPlace', 'CUDAPlace', 'Communicator',
    'CompiledProgram', 'DataFeedDesc', 'DataFeeder', 'DataLoader',
    'DatasetFactory', 'DistributeTranspiler', 'DistributeTranspilerConfig',
    'Executor', 'FetchHandle', 'InMemoryDataset', 'LoDTensor',
    'ParallelExecutor', 'ParamAttr', 'Program', 'QueueDataset', 'Scope',
    'TPUPlace', 'Variable', 'WeightNormParamAttr', 'XLAPlace', 'analysis',
    'annotations', 'append_backward', 'average', 'backward', 'clip',
    'communicator', 'compiler', 'contrib', 'core', 'cpu_places',
    'create_lod_tensor', 'create_random_int_lodtensor',
    'cuda_pinned_places', 'cuda_places', 'data', 'data_feed_desc',
    'data_feeder', 'dataset', 'datasets', 'debugger', 'debugging',
    'default_main_program', 'default_scope_funcs',
    'default_startup_program', 'device_guard', 'device_worker',
    'disable_dygraph', 'distribute_lookup_table', 'distributed', 'dygraph',
    'dygraph_grad_clip', 'enable_dygraph', 'enabled', 'evaluator',
    'executor', 'fluid', 'framework', 'global_scope', 'gradients',
    'in_dygraph_mode', 'incubate', 'inference', 'initializer', 'input',
    'install_check', 'io', 'is_compiled_with_cuda', 'layer_helper',
    'layers', 'load', 'load_dygraph', 'load_inference_model',
    'load_op_library', 'load_params', 'load_persistables',
    'load_program_state', 'log_helper', 'manual_seed', 'memory_optimize',
    'metrics', 'name_scope', 'net_drawer', 'nets', 'observability', 'op',
    'ops', 'optimizer', 'parallel', 'parallel_executor', 'param_attr',
    'partition', 'profiler', 'program_guard', 'reader', 'regularizer',
    'release_memory', 'require_version', 'resilience', 'save',
    'save_dygraph', 'save_inference_model', 'save_params',
    'save_persistables', 'scope_guard', 'seed', 'serving',
    'set_program_state', 'tpu_places', 'trainer_desc', 'trainer_factory',
    'transpiler', 'unique_name', 'utils']
JAX_CONTRIB_NAMES = [
    'AutoMixedPrecisionLists', 'BasicGRUUnit', 'BasicLSTMUnit',
    'BeamSearchDecoder', 'BeginEpochEvent', 'BeginStepEvent',
    'CheckpointConfig', 'Compressor', 'EndEpochEvent', 'EndStepEvent',
    'HDFSClient', 'Inferencer', 'InitState', 'PostTrainingQuantization',
    'QuantizeTranspiler', 'StateCell', 'Trainer', 'TrainingDecoder',
    'WeightQuantization', 'basic_gru', 'basic_lstm',
    'convert_dist_to_sparse_program', 'ctr_metric_bundle', 'decoder',
    'decorate', 'device_memory_stats', 'distributed_batch_reader',
    'extend_optimizer', 'extend_with_decoupled_weight_decay', 'extra',
    'fused_elemwise_activation', 'fused_embedding_seq_pool', 'inferencer',
    'layers', 'load_persistables_for_increment',
    'load_persistables_for_inference', 'match_matrix_tensor',
    'memory_usage', 'memory_usage_calc', 'mixed_precision', 'model_stat',
    'multi_download', 'multi_upload', 'multiclass_nms2',
    'op_freq_statistic', 'op_frequence', 'partial_concat', 'partial_sum',
    'print_memory_report', 'quantize', 'reader', 'search_pyramid_hash',
    'sequence_topk_avg_pooling', 'shuffle_batch', 'slim', 'summary',
    'trainer', 'tree_conv', 'utils', 'var_conv_2d']

# the names the port does not run yet -> their ROADMAP item
STAND_INS = {
    **dict.fromkeys([
        'ParallelExecutor', 'parallel_executor', 'DistributeTranspiler',
        'DistributeTranspilerConfig', 'distributed', 'partition',
        'communicator', 'Communicator', 'distribute_lookup_table'], 'A.9'),
    **dict.fromkeys(['LoDTensor', 'create_lod_tensor',
                     'create_random_int_lodtensor'], 'A.10'),
    **dict.fromkeys([
        'DataLoader', 'reader', 'FetchHandle', 'profiler', 'resilience', 'analysis', 'dataset', 'datasets', 'DatasetFactory',
        'InMemoryDataset', 'QueueDataset', 'data_feed_desc', 'DataFeedDesc',
        'device_worker', 'trainer_desc', 'trainer_factory', 'incubate'],
        'A.11'),
}
CONTRIB_STAND_INS = {
    **dict.fromkeys(['slim', 'PostTrainingQuantization',
                     'WeightQuantization', 'Compressor', 'quantize',
                     'QuantizeTranspiler', 'reader',
                     'distributed_batch_reader'], 'A.11'),
    **dict.fromkeys([
        'extra', 'BasicLSTMUnit',
        'BasicGRUUnit', 'basic_lstm', 'basic_gru',
        'fused_elemwise_activation', 'partial_concat', 'partial_sum',
        'shuffle_batch', 'tree_conv', 'multiclass_nms2', 'decoder',
        'InitState', 'StateCell', 'TrainingDecoder', 'BeamSearchDecoder',
        'layers', 'sequence_topk_avg_pooling', 'var_conv_2d',
        'match_matrix_tensor', 'fused_embedding_seq_pool',
        'search_pyramid_hash', 'ctr_metric_bundle'], 'A.10'),
    **dict.fromkeys(['utils', 'HDFSClient', 'multi_download',
                     'multi_upload', 'convert_dist_to_sparse_program',
                     'load_persistables_for_increment',
                     'load_persistables_for_inference'], 'A.9'),
}


def kind(obj):
    if isinstance(obj, types.ModuleType):
        return 'module'
    return 'class' if inspect.isclass(obj) else 'callable'


def defined_by_the_port(obj):
    name = (obj.__name__ if isinstance(obj, types.ModuleType)
            else getattr(obj, '__module__', ''))
    return name.startswith('paddle_tpu_torch')


def assert_stand_in(obj, item):
    match = f'ROADMAP {item.replace(".", "[.]")}'
    with pytest.raises(NotImplementedError, match=match):
        if isinstance(obj, types.ModuleType):
            getattr(obj, 'anything')
        else:
            obj()


def test_the_name_lists_are_the_jax_packages():
    code = ('import paddle_tpu, paddle_tpu.contrib as c\n'
            'print(sorted(n for n in dir(paddle_tpu) if n[0] != "_"))\n'
            'print(sorted(n for n in dir(c) if n[0] != "_"))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         env={**os.environ, 'JAX_PLATFORMS': 'cpu'},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top, con = out.stdout.strip().splitlines()
    assert eval(top) == JAX_NAMES and len(JAX_NAMES) == 118
    assert eval(con) == JAX_CONTRIB_NAMES


@pytest.mark.parametrize('name', JAX_NAMES)
def test_every_jax_top_level_name_exists_in_the_port(name):
    assert hasattr(fluid, name)
    obj, ref = getattr(fluid, name), getattr(jfluid, name)
    assert kind(obj) == kind(ref)
    if name in STAND_INS:
        assert_stand_in(obj, STAND_INS[name])
    elif name == 'fluid':
        assert obj is fluid
    else:
        assert defined_by_the_port(obj), obj


@pytest.mark.parametrize('name', JAX_CONTRIB_NAMES)
def test_every_jax_contrib_name_exists_in_the_port(name):
    assert hasattr(contrib, name)
    obj, ref = getattr(contrib, name), getattr(jcontrib, name)
    assert kind(obj) == kind(ref)
    if name in CONTRIB_STAND_INS:
        assert_stand_in(obj, CONTRIB_STAND_INS[name])
    else:
        assert defined_by_the_port(obj), obj


def test_unknown_names_are_not_attributes():
    assert not hasattr(fluid, 'no_such_name')
    assert not hasattr(contrib, 'no_such_name')
    assert not hasattr(fluid.transpiler, 'no_such_name')
    assert not hasattr(fluid.reader, '_private')
    with pytest.raises(NotImplementedError, match='ROADMAP A[.]9'):
        fluid.transpiler.DistributeTranspiler


def test_fluid_alias_is_the_package():
    import paddle_tpu_torch.fluid as alias
    from paddle_tpu_torch.fluid import layers
    assert alias is fluid and alias.fluid is fluid
    assert layers is fluid.layers
    assert fluid.__version__ == jfluid.__version__ == '1.7.0'


# ------------------------------------------------------ framework additions

def test_places():
    assert fluid.CUDAPinnedPlace().device().type == 'cpu'
    assert fluid.cuda_pinned_places() == [fluid.CUDAPinnedPlace()]
    assert fluid.cuda_pinned_places(3) == [fluid.CUDAPinnedPlace()] * 3
    assert (jfluid.cuda_pinned_places(2)
            == [jfluid.CUDAPinnedPlace()] * 2)
    assert fluid.tpu_places() == fluid.cuda_places()
    assert fluid.tpu_places([0]) == [fluid.CUDAPlace(0)]


def device_guarded(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.data('x', [4, 3], 'float32')
        with pkg.device_guard('gpu:0'):
            h = pkg.layers.fc(x, 2, act='relu')
        out = pkg.layers.reduce_sum(h)
    return main, startup, out


def test_device_guard_marks_ops_and_is_inert():
    got, want = device_guarded(fluid), device_guarded(jfluid)
    assert ([(op.type, op.attrs.get('op_device'))
             for op in got[0].global_block().ops]
            == [(op.type, op.attrs.get('op_device'))
                for op in want[0].global_block().ops])
    assert [op.attrs.get('op_device')
            for op in got[0].global_block().ops] == [
        'gpu:0', 'gpu:0', 'gpu:0', None]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(want[1], scope=jscope)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({v.name: np.asarray(jscope.find(v.name))
                       for v in want[0].all_parameters()}, scope,
                      fluid.CPUPlace(), program=got[0])
    x = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    w, = jexe.run(want[0], feed={'x': x}, fetch_list=[want[2]],
                  scope=jscope)
    g, = exe.run(got[0], feed={'x': x}, fetch_list=[got[2]], scope=scope)
    np.testing.assert_allclose(g, w, rtol=1e-6)


def test_load_op_library_warns_and_returns_none():
    with pytest.warns(UserWarning, match='register_op'):
        assert fluid.load_op_library('custom_ops.so') is None
    with pytest.warns(UserWarning):
        assert jfluid.load_op_library('custom_ops.so') is None


@pytest.mark.parametrize('args,ok', [
    (('1.6',), True), (('1.7.0',), True), (('1.8',), False),
    (('1.5', '1.7'), True), (('1.5', '1.6.9'), False)])
def test_require_version(args, ok):
    for pkg in (fluid, jfluid):
        if ok:
            pkg.require_version(*args)
        else:
            with pytest.raises(Exception, match='installed version'):
                pkg.require_version(*args)


def test_enabled_follows_the_dygraph_guard():
    assert fluid.enabled() is False
    with fluid.dygraph.guard(fluid.CPUPlace()):
        assert fluid.enabled() is True
    assert fluid.enabled() is False


def test_weight_norm_param_attr_is_inert_in_the_jax_package():
    """ROADMAP C.4 item 10: the JAX package builds the same program with
    a WeightNormParamAttr as with a plain ParamAttr (no norm op, no g or v
    parameter); the port's layer raises naming that item."""
    def build(pkg, attr):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard():
            with pkg.program_guard(main, startup):
                x = pkg.data('x', [4, 3], 'float32')
                pkg.layers.fc(x, 2, param_attr=attr)
        return ([(op.type, op.inputs, op.outputs)
                 for op in main.global_block().ops],
                sorted(v.name for v in main.list_vars()))

    assert (build(jfluid, jfluid.WeightNormParamAttr(dim=0, name='w'))
            == build(jfluid, jfluid.ParamAttr(name='w')))
    attr = fluid.WeightNormParamAttr(dim=0, name='w', learning_rate=1.0)
    assert attr.dim == 0 and attr.name == 'w'
    assert isinstance(attr, fluid.ParamAttr)
    with pytest.raises(NotImplementedError, match='C[.]4 item 10'):
        build(fluid, attr)


# ------------------------------------------------------- small host modules

def test_log_helper_adds_one_handler(capsys):
    from paddle_tpu import log_helper as jlog
    for mod, name in ((fluid.log_helper, 'port_log'), (jlog, 'jax_log')):
        a = mod.get_logger(name, 20, fmt='%(levelname)s %(message)s')
        b = mod.get_logger(name, 20)
        assert a is b and len(a.handlers) == 1 and not a.propagate
        a.info('hello')
    err = capsys.readouterr().err
    assert err.count('INFO hello') == 2


def test_deprecated_prints_the_same_notice(capsys):
    def f(x):
        """Doc."""
        return x + 1
    from paddle_tpu.annotations import deprecated as jdep
    got = fluid.annotations.deprecated('1.6', 'g', 'see g')(f)
    want = jdep('1.6', 'g', 'see g')(f)
    assert got(1) == 2
    port_err = capsys.readouterr().err
    assert want(1) == 2
    assert port_err == capsys.readouterr().err
    assert got.__doc__ == want.__doc__ and 'since 1.6' in got.__doc__


def test_default_scope_funcs():
    dsf = fluid.default_scope_funcs
    base = dsf.get_cur_scope()
    assert base is fluid.global_scope()
    dsf.enter_local_scope()
    dsf.var('tmp_x')
    assert dsf.get_cur_scope() is not base
    assert dsf.find_var('tmp_x') is None
    dsf.leave_local_scope()
    assert dsf.get_cur_scope() is base
    with pytest.raises(RuntimeError, match='global scope'):
        dsf.leave_local_scope()

    def inner():
        dsf.var('scoped_y')
        assert dsf.get_cur_scope() is not base
        return 42
    assert dsf.scoped_function(inner) == 42
    assert dsf.get_cur_scope() is base


def input_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = pkg.data('ids', [4], 'int64')
        emb = pkg.input.embedding(ids, size=[10, 8])
        oh = pkg.input.one_hot(ids, 10)
    return main, startup, emb, oh


def test_input_embedding_and_one_hot_match_jax():
    jm, js, jemb, joh = input_program(jfluid)
    tm, ts, temb, toh = input_program(fluid)
    assert ([op.type for op in tm.global_block().ops]
            == [op.type for op in jm.global_block().ops])
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({p.name: np.asarray(jscope.find(p.name))
                       for p in jm.all_parameters()}, scope,
                      fluid.CPUPlace(), program=tm)
    ids = np.array([1, 2, 3, 0])
    want = jexe.run(jm, feed={'ids': ids}, fetch_list=[jemb, joh],
                    scope=jscope)
    got = exe.run(tm, feed={'ids': ids}, fetch_list=[temb, toh],
                  scope=scope)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_transpiler_no_ops():
    main = build_static_lenet_program(fluid, 'adam')[0]
    assert fluid.memory_optimize(main) is None
    assert fluid.release_memory(main, skip_opt_set={'x'}) is None
    assert fluid.transpiler.memory_optimize is fluid.memory_optimize
    for name in fluid.transpiler.NOT_PORTED:
        with pytest.raises(NotImplementedError, match='ROADMAP A[.]9'):
            getattr(fluid.transpiler, name)


def test_utils_ploter_and_dump_config(tmp_path, capsys, monkeypatch):
    from paddle_tpu_torch.utils import PlotData, Ploter, dump_config
    p = Ploter('train cost', 'test cost')
    p.append('train cost', 0, 1.5)
    p.append('train cost', 1, 1.25)
    with pytest.raises(ValueError, match='not a curve'):
        p.append('other', 0, 1.0)
    assert p.__plot_data__['train cost'].value == [1.5, 1.25]
    p.plot(str(tmp_path / 'curve.png'))
    assert (tmp_path / 'curve.png').exists() or \
        (tmp_path / 'curve.png.csv').read_text().startswith('train cost,0,')
    p.reset()
    assert p.__plot_data__['train cost'].step == []
    d = PlotData()
    d.append(3, 4.0)
    assert (d.step, d.value) == ([3], [4.0])
    monkeypatch.setenv('DISABLE_PLOT', 'True')
    q = Ploter('a')
    q.append('a', 0, 1.0)
    q.plot(str(tmp_path / 'off.png'))
    assert not list(tmp_path.glob('off.png*'))
    monkeypatch.setenv('PADDLE_TPU_PROBE', '1')
    dump_config()
    out = capsys.readouterr().out
    assert 'torch:' in out and 'PADDLE_TPU_PROBE=1' in out
    assert 'jax' not in out


@pytest.mark.parametrize('isolated', [True, False],
                         ids=['isolated', 'in-process'])
def test_backend_probe_raises_without_a_card(isolated, monkeypatch):
    """No card: a fast failure, never a CPU fallback."""
    from paddle_tpu_torch.utils import backend_probe
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '')
    with pytest.raises(backend_probe.BackendInitError,
                       match='no CUDA device') as err:
        backend_probe.probe_backend(timeout=60, isolated=isolated)
    assert err.value.parent_clean is isolated


def test_backend_probe_times_out_on_a_hang(monkeypatch):
    from paddle_tpu_torch.utils import backend_probe
    monkeypatch.setattr(backend_probe, '_CHILD',
                        'import time\ntime.sleep(30)\n')
    monkeypatch.setattr(backend_probe, '_CHILD_STARTUP_GRACE_S', 0.5)
    with pytest.raises(backend_probe.BackendInitTimeout) as err:
        backend_probe.probe_backend(timeout=0.5)
    assert err.value.parent_clean


# ------------------------------------------------ introspection of programs

def build_static_lenet_program(pkg, opt):
    lenet = build_static_lenet if pkg is fluid else jax_lenet
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data('img', [1, 28, 28], dtype='float32')
        label = pkg.layers.data('label', [1], dtype='int64')
        loss, acc, logits = lenet(img, label)
        if opt == 'adam':
            pkg.optimizer.Adam(learning_rate=0.001).minimize(loss)
    return main, startup, loss


def log_program(pkg):
    """tests/framework/test_fluid_long_tail.py's debugger program."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.data('dx', [2, 2], 'float32')
        h = pkg.layers.log(x)
        out = pkg.layers.reduce_sum(h)
    return main, startup, out


PROGRAMS = {'lenet_adam': lambda pkg: build_static_lenet_program(pkg, 'adam'),
            'lenet': lambda pkg: build_static_lenet_program(pkg, None),
            'log': log_program}


def both(what):
    """The same program built in both packages under fresh name
    counters: (port's, JAX package's)."""
    with fluid.unique_name.guard():
        got = PROGRAMS[what](fluid)
    with jfluid.unique_name.guard():
        want = PROGRAMS[what](jfluid)
    return got, want


@pytest.mark.parametrize('what', sorted(PROGRAMS))
def test_debugger_text_matches_jax(what, tmp_path, capsys):
    from paddle_tpu import debugger as jdbg
    (tm, _, _), (jm, _, _) = both(what)
    dbg = fluid.debugger
    tb, jb = tm.global_block(), jm.global_block()
    assert sorted(tb.vars) == sorted(jb.vars)
    for name in tb.vars:
        tv, jv = tb.vars[name], jb.vars[name]
        assert dbg.repr_var(tv) == jdbg.repr_var(jv)
        for f in ('repr_tensor', 'repr_lodtensor', 'repr_selected_rows',
                  'repr_tensor_array'):
            assert getattr(dbg, f)(tv) == getattr(jdbg, f)(jv)
        assert dbg.repr_data_type(tv.dtype) == jdbg.repr_data_type(jv.dtype)
    for top, jop in zip(tb.ops, jb.ops):
        assert dbg.repr_op(top) == jdbg.repr_op(jop)
    assert dbg.repr_attr('scale', 2.0) == jdbg.repr_attr('scale', 2.0)
    assert dbg.pprint_program_codes(tm) == jdbg.pprint_program_codes(jm)
    assert (dbg.pprint_block_codes(tb, show_backward=False)
            == jdbg.pprint_block_codes(jb, show_backward=False))
    got = dbg.draw_block_graphviz(tb, highlights=['img'],
                                  path=str(tmp_path / 'p.dot'))
    want = jdbg.draw_block_graphviz(jb, highlights=['img'],
                                    path=str(tmp_path / 'j.dot'))
    assert got == want == (tmp_path / 'p.dot').read_text()
    assert got.startswith('digraph G {')


@pytest.mark.parametrize('what', sorted(PROGRAMS))
def test_net_drawer_text_matches_jax(what, tmp_path, monkeypatch):
    from paddle_tpu import net_drawer as jnd
    (tm, ts, _), (jm, js, _) = both(what)
    monkeypatch.setattr(fluid.net_drawer, '_counter', [0])
    monkeypatch.setattr(jnd, '_counter', [0])
    got = fluid.net_drawer.draw_graph(ts, tm, path=str(tmp_path / 'p.dot'),
                                      graph_attr={'rankdir': 'TB'})
    want = jnd.draw_graph(js, jm, path=str(tmp_path / 'j.dot'),
                          graph_attr={'rankdir': 'TB'})
    assert got == want == (tmp_path / 'p.dot').read_text()


def test_op_protos_match_jax_on_the_programs_ops():
    from paddle_tpu import op as jop
    (tm, _, _), _ = both('lenet_adam')
    types_ = sorted({op.type for op in tm.global_block().ops}
                    - {'__backward__'}) + ['relu', 'scale']
    port = {p.type: p for p in fluid.op.get_all_op_protos()}
    ref = {p.type: p for p in jop.get_all_op_protos()}
    assert list(port) == sorted(port)
    for t in types_:
        assert repr(port[t]) == repr(ref[t]), t
        assert repr(fluid.op.OpInfo(t).proto) == repr(jop.OpInfo(t).proto)
    assert 'x' in port['relu'].inputs and 'Out' in port['relu'].outputs
    desc = fluid.op.Operator(type='scale', x='a', Out='b', scale=2.0)
    assert desc == jop.Operator(type='scale', x='a', Out='b', scale=2.0)
    assert desc['type'] == 'scale' and desc['attrs']['scale'] == 2.0
    assert fluid.op.Operator('relu', x='a') == jop.Operator('relu', x='a')
    assert fluid.op.Operator.types() == sorted(port)
    with pytest.raises(ValueError, match='unknown op type'):
        fluid.op.OpInfo('definitely_not_an_op')
    with pytest.raises(ValueError):
        fluid.op.Operator('scale', type='scale')


def test_model_stat_and_op_frequencies_match_jax(capsys):
    (tm, _, _), (jm, _, _) = both('lenet_adam')
    got = contrib.summary(tm)
    port_out = capsys.readouterr().out
    want = jcontrib.summary(jm)
    assert port_out == capsys.readouterr().out
    assert got == want
    assert got[1:] == (430500, 4631180)
    assert contrib.op_freq_statistic(tm) == jcontrib.op_freq_statistic(jm)
    with pytest.raises(ValueError, match='not a Program'):
        contrib.op_freq_statistic('main')


@pytest.mark.parametrize('batch', [1, 64, 4096])
def test_memory_usage_matches_jax(batch):
    (tm, _, _), (jm, _, _) = both('lenet_adam')
    assert (contrib.memory_usage(tm, batch)
            == jcontrib.memory_usage(jm, batch))
    with pytest.raises(ValueError, match='positive'):
        contrib.memory_usage(tm, 0)
    with pytest.raises(TypeError, match='requires Program'):
        contrib.memory_usage('main', 1)


def test_device_memory_stats_without_a_card_is_empty(capsys):
    assert contrib.device_memory_stats() == {}
    assert contrib.print_memory_report() == {}
    assert 'no CUDA device' in capsys.readouterr().out


def test_evaluator_and_install_check_modules_import():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        ed = fluid.evaluator.EditDistance('distance')
    assert isinstance(ed, fluid.metrics.EditDistance)
    assert caught[0].category is DeprecationWarning
    assert callable(fluid.install_check.run_check)
