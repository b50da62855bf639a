"""The port's fluid.io (paddle_tpu_torch/io.py), CompiledProgram's knobs
(compiler.py) and the Predictor (inference.py) on the CPU, against the
JAX package where both take part.

The model is PaddleCV's static ResNet recipe at test size
(tools/static_resnet.py: one bottleneck a stage, width / 16, 10 classes,
32x32 images, batch 4 from ``numpy.random.RandomState``), after one
training step, so the running statistics are not their initial values.

- ``save_persistables`` -> ``load_persistables`` into a fresh scope
  restores every persistable bit for bit, on the executor's device;
  ``fluid.save`` -> ``fluid.load`` the same.
- An inference model saved by the port runs in the JAX package
  (``load_inference_model`` + its ``Executor``) and one saved by the JAX
  package runs in the port, each with the logits of the saving package's
  own test program: atol 1e-5, rtol 1e-4 (the same f32 convolutions,
  summed in another order).
- The Predictor's output equals the loaded program's through the same
  executor bit for bit (the same ops on the same device), with one
  lowering for repeated runs of one batch size.
- ``program_only=True`` with no values in the scope raises at load; the
  knobs that the port does not act on raise naming their ROADMAP items
  (A.8d, A.9, A.11), and so do the Predictor's bf16, int8 and StableHLO
  entry points (A.8e, A.10, A.11).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch import inference
from paddle_tpu_torch.tools import static_resnet
from torch_jax_seed import jax_seed_pinned  # noqa: F401

KW = dict(class_dim=10, image_shape=(3, 32, 32), blocks=[1, 1, 1, 1],
          width_div=16)
CPU = fluid.CPUPlace()


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


def feed(seed=0):
    rng = np.random.RandomState(seed)
    return {'image': rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            'label': rng.randint(0, 10, (4, 1)).astype(np.int64)}


def trained(pkg):
    """The recipe after one step in ``pkg`` on its CPU executor, in the
    global scope: (exe, main, test, vars)."""
    main, startup, test, v = static_resnet.build(pkg, **KW)
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup)
    exe.run(main, feed=feed(0), fetch_list=[v['loss']])
    return exe, main, test, v


def persistable_values(program, scope):
    return {v.name: scope.find(v.name) for v in program.list_vars()
            if v.persistable}


def test_save_and_load_persistables_round_trip(tmp_path):
    exe, main, _, _ = trained(fluid)
    before = persistable_values(main, fluid.global_scope())
    fluid.io.save_persistables(exe, str(tmp_path), main)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.io.load_persistables(exe, str(tmp_path), main)
    after = persistable_values(main, scope)
    assert sorted(after) == sorted(before)
    for n, t in before.items():
        assert after[n].device == exe.device, n
        assert after[n].dtype == t.dtype, n
        assert np.array_equal(after[n].numpy(), t.numpy()), n


def test_fluid_save_and_load_round_trip_and_load_in_jax(tmp_path):
    exe, main, _, _ = trained(fluid)
    before = persistable_values(main, fluid.global_scope())
    path = str(tmp_path / 'ckpt' / 'model')
    fluid.save(main, path)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.load(main, path, exe)
    for n, t in before.items():
        assert np.array_equal(scope.find(n).numpy(), t.numpy()), n
    state = jfluid.load_program_state(path)
    assert set(state) == set(before)
    for n, t in before.items():
        np.testing.assert_array_equal(state[n], t.numpy())


@pytest.mark.parametrize('saver', ['port', 'jax'])
def test_inference_model_runs_in_the_other_package(tmp_path, saver):
    src, dst = (fluid, jfluid) if saver == 'port' else (jfluid, fluid)
    exe, main, test, v = trained(src)
    x = feed(1)
    want = np.asarray(exe.run(test, feed=x, fetch_list=[v['prob']])[0])
    src.io.save_inference_model(str(tmp_path), ['image'], [v['prob']], exe,
                                main_program=main)
    dexe = dst.Executor(dst.CPUPlace())
    with dst.scope_guard(dst.Scope()):
        prog, feeds, fetches = dst.io.load_inference_model(str(tmp_path),
                                                           dexe)
        assert feeds == ['image']
        got = np.asarray(dexe.run(prog, feed={'image': x['image']},
                                  fetch_list=fetches)[0])
    assert prog.global_block().ops[-1].type == 'softmax'
    assert not any(op.type in ('__backward__', 'increment', 'momentum',
                               'cross_entropy', 'accuracy')
                   for op in prog.global_block().ops)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_predictor_matches_the_loaded_program_bit_for_bit(tmp_path):
    exe, main, test, v = trained(fluid)
    fluid.io.save_inference_model(str(tmp_path), ['image'], [v['prob']], exe,
                                  main_program=main)
    pexe = fluid.Executor(CPU)
    pred = inference.Predictor(inference.Config(str(tmp_path)), pexe)
    assert pred.get_input_names() == ['image']
    assert pred.get_output_names() == [v['prob'].name]
    x = feed(2)['image']
    outs = [pred.run([x])[0] for _ in range(3)]
    assert pexe.lowering_count(pred.program) == 1
    lexe = fluid.Executor(CPU)
    with fluid.scope_guard(fluid.Scope()):
        prog, _, fetches = fluid.io.load_inference_model(str(tmp_path), lexe)
        ref = lexe.run(prog, feed={'image': x}, fetch_list=fetches)[0]
    for out in outs:
        assert np.array_equal(out, ref)
    want = exe.run(test, feed={'image': x, 'label': feed(2)['label']},
                   fetch_list=[v['prob']])[0]
    np.testing.assert_allclose(ref, want, atol=1e-6, rtol=1e-5)
    # another batch size: one more lowering, the same rows (eval mode)
    np.testing.assert_allclose(pred.run({'image': x[:2]})[0], ref[:2],
                               atol=1e-6, rtol=1e-5)
    assert pexe.lowering_count(pred.program) == 2


def test_program_only_without_values_raises(tmp_path):
    exe, main, _, v = trained(fluid)
    fluid.io.save_inference_model(str(tmp_path), ['image'], [v['prob']], exe,
                                  main_program=main, program_only=True)
    assert not (tmp_path / 'params.npz').exists()
    with fluid.scope_guard(fluid.Scope()):
        with pytest.raises(RuntimeError, match='no saved value'):
            fluid.io.load_inference_model(str(tmp_path), exe)


def test_io_helpers_classify_the_recipes_variables():
    _, main, _, v = trained(fluid)
    by_name = {x.name: x for x in main.list_vars()}
    assert fluid.io.is_parameter(by_name['conv1_weights'])
    assert not fluid.io.is_persistable(by_name['image'])
    assert fluid.io.is_belong_to_optimizer(by_name['lr_decay_counter_0'])
    assert fluid.io.is_belong_to_optimizer(
        by_name['conv1_weights_velocity_0'])
    assert not fluid.io.is_belong_to_optimizer(by_name['bn_conv1_mean'])
    assert len(fluid.io.get_program_parameter(main)) == len(
        main.all_parameters())
    np.testing.assert_array_equal(
        fluid.io.get_parameter_value_by_name('conv1_weights', program=main),
        fluid.global_scope().find('conv1_weights').numpy())


def _small_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data('x', [None, 3], 'float32')
        loss = fluid.layers.mean(fluid.layers.fc(x, 2))
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(CPU)
    exe.run(startup)
    return exe, main, loss


@pytest.mark.parametrize('knob,item', [
    ('fuse_elewise_add_act_ops', 'A.8d'), ('fuse_all_optimizer_ops', 'A.8d'),
    ('fuse_bn_act_ops', 'A.8d'), ('num_trainers', 'A.9'),
    ('num_inflight_steps', 'A.11')])
def test_compiled_program_knobs_the_port_does_not_act_on_raise(knob, item):
    exe, main, loss = _small_program()
    bs, es = fluid.compiler.BuildStrategy(), fluid.compiler.ExecutionStrategy()
    if knob == 'num_inflight_steps':
        es.num_inflight_steps = 2
    elif knob == 'num_trainers':
        bs.num_trainers = 2
    else:
        setattr(bs, knob, True)
    prog = fluid.CompiledProgram(main, bs, es).with_data_parallel(
        loss_name=loss.name)
    with pytest.raises(NotImplementedError, match=item):
        exe.run(prog, feed={'x': np.ones((4, 3), 'float32')},
                fetch_list=[loss])


def test_compiled_program_runs_with_the_accepted_knobs():
    exe, main, loss = _small_program()
    bs, es = fluid.compiler.BuildStrategy(), fluid.compiler.ExecutionStrategy()
    bs.enable_inplace = bs.memory_optimize = False
    bs.reduce_strategy = fluid.compiler.BuildStrategy.ReduceStrategy.Reduce
    es.num_threads = 4
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs, exec_strategy=es,
        places=fluid.cpu_places(1))
    x = {'x': np.ones((4, 3), 'float32')}
    a = exe.run(prog, feed=x, fetch_list=[loss])[0]
    b = exe.run(main, feed=x, fetch_list=[loss])[0]
    assert b < a                       # the step ran and updated
    assert exe.lowering_count(main) == 1
    with pytest.raises(NotImplementedError, match='A.9'):
        fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=fluid.cpu_places(2))


@pytest.mark.parametrize('call,item', [
    (lambda: inference.Config('m').enable_bf16(), None),
    (lambda: inference.Config('m').enable_int8(), 'A.10'),
    (lambda: inference.export_stablehlo(None, ()), 'A.11'),
    (lambda: inference.export_program_stablehlo(None, {}, []), 'A.11'),
    (lambda: fluid.io.DataLoader(), 'A.11')],
    ids=['bf16', 'int8', 'stablehlo', 'program_stablehlo', 'dataloader'])
def test_unported_inference_and_io_entry_points_raise(call, item):
    """Each entry point not ported raises naming its ROADMAP item;
    ``enable_bf16`` (A.8e) is ported and returns its Config set to bf16
    (tests/test_torch_static_amp.py runs a Predictor with it)."""
    if item is None:
        cfg = call()
        assert isinstance(cfg, inference.Config)
        assert cfg.precision == 'bfloat16'
        return
    with pytest.raises(NotImplementedError, match=item):
        call()
