"""The port's ``contrib.Trainer`` and ``contrib.Inferencer`` (ROADMAP A.13)
against the JAX package's, on the CPU, running PaddleBook's
recognize_digits (``paddle_tpu_torch/tools/recognize_digits.py``, one
script for both packages) at batch 8, as
tests/framework/test_contrib_complete.py's round trip runs the JAX one.

- The Trainer's program is ``build_static_lenet`` with ``Adam(1e-3)``, op
  for op and variable for variable.
- The same numpy weights go into both Trainers' scopes
  (``convert.scope_from_paddle``), and three Trainer steps are held as
  tests/test_torch_static_graph.py's ``test_lenet_three_steps_match_jax``
  holds three Executor steps: losses within rtol 1e-4, the persistables
  after the first step within atol 1e-4 of the JAX package's (Adam), and
  after every step no further from a float64 witness (the port's program
  cloned by ``tools/witness.as_float64``, run by a plain Executor from the
  same values) than twice the JAX package's distance from it plus a tenth
  of that atol after the first step, or plus what the witness moved in the
  step after a later one.
- The events come in the same order, with the same epochs and steps; the
  same checkpoint directories survive ``max_num_checkpoints``; ``test``
  gives the same means (loss at rtol 1e-4, accuracy within one sample);
  ``stop`` and ``fetch_metrics=False`` act alike.
- ``save_params`` then ``Inferencer``: its output equals the test
  program's on the same batch in the same scope's values (max |diff| 0 on
  the CPU), and the JAX Inferencer's within 1e-5; ``save_inference_model``
  reloads through ``load_inference_model`` to the same output.
- The port's Trainer casts and reshapes each column to the declared
  variable (PaddleBook's rows of 784 floats and an int label), where the
  JAX package's stacks rows as given: on rows already in the declared form
  both feed the same arrays.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.contrib as jcontrib
import paddle_tpu_torch as fluid
from paddle_tpu_torch import contrib
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.models.lenet import build_static_lenet
from paddle_tpu_torch.tools import recognize_digits as book
from paddle_tpu_torch.tools.witness import as_float64
from test_torch_static_graph import _ops, _vars, lenet_readings
from test_torch_static_graph import fresh_port_programs  # noqa: F401
from torch_jax_seed import jax_seed_pinned  # noqa: F401

BATCH = 8
ADAM_ATOL = 1e-4


def shaped(reader):
    """PaddleBook's rows in the declared form: (1, 28, 28) float32 pixels
    and a (1,) int64 label, which the JAX package's Trainer needs."""
    def shaped_reader():
        for rows in reader():
            yield [(p.reshape(1, 28, 28), np.array([y], np.int64))
                   for p, y in rows]
    return shaped_reader


def trainer(pkg, mod, checkpoint_dir=None, **kw):
    cfg = (mod.CheckpointConfig(checkpoint_dir=str(checkpoint_dir),
                                max_num_checkpoints=2, step_interval=1)
           if checkpoint_dir is not None else None)
    return mod.Trainer(lambda: book.train_program(pkg),
                       lambda: book.optimizer_func(pkg),
                       place=pkg.CPUPlace(), checkpoint_config=cfg, **kw)


def persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def carried(jtr, tr):
    """The JAX Trainer's startup values into the port Trainer's scope."""
    scope_from_paddle({n: np.asarray(jtr.scope.find(n))
                       for n in persistables(jtr.train_program)},
                      tr.scope, fluid.CPUPlace(), program=tr.train_program)


def port_state(tr):
    return {n: tr.scope.find(n).numpy().copy()
            for n in persistables(tr.train_program)}


def jax_state(jtr):
    return {n: np.array(jtr.scope.find(n))
            for n in persistables(jtr.train_program)}


class Recorder:
    """An event handler: each event as (type, epoch, step), each step's
    metrics and the state after it."""

    def __init__(self, state, stop_at=None, trainer=None, fetch=True):
        self.events, self.metrics, self.states = [], [], []
        self._state, self._stop_at, self._trainer = state, stop_at, trainer
        self._fetch = fetch

    def __call__(self, e):
        self.events.append((type(e).__name__, e.epoch,
                            getattr(e, 'step', None)))
        if type(e).__name__ == 'BeginStepEvent':
            e.fetch_metrics = self._fetch
        if type(e).__name__ == 'EndStepEvent':
            self.metrics.append([np.asarray(m) for m in e.metrics])
            self.states.append(self._state())
            if e.step == self._stop_at:
                self._trainer.stop()


def test_the_trainer_program_is_build_static_lenet():
    tr = trainer(fluid, contrib)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            img = fluid.layers.data('img', [1, 28, 28], dtype='float32')
            label = fluid.layers.data('label', [1], dtype='int64')
            loss, _, _ = build_static_lenet(img, label)
            fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    assert _ops(tr.train_program) == _ops(main)
    assert _vars(tr.train_program) == _vars(main)
    assert _ops(tr.startup_program) == _ops(startup)
    assert sum(int(np.prod(p.shape))
               for p in tr.train_program.all_parameters()) == 431080


def test_three_trainer_steps_match_jax_and_the_witness(tmp_path):
    jtr = trainer(jfluid, jcontrib, tmp_path / 'jax')
    tr = trainer(fluid, contrib, tmp_path / 'port')
    carried(jtr, tr)
    names = persistables(tr.train_program)
    start = port_state(tr)
    reader = shaped(book.mnist_reader(0, 3, batch=BATCH))
    jrec, rec = Recorder(lambda: jax_state(jtr)), Recorder(
        lambda: port_state(tr))
    jtr.train(1, jrec, reader=reader, feed_order=book.FEED_ORDER)
    tr.train(1, rec, reader=reader, feed_order=book.FEED_ORDER)

    # the witness: the port's program in float64, three plain steps
    w64 = as_float64(tr.train_program)
    wexe, wscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({n: a.astype(w64.global_block().var(n).dtype)
                       for n, a in start.items()}, wscope, fluid.CPUPlace(),
                      program=w64)
    feeder = fluid.DataFeeder([tr.train_program.global_block().var(n)
                               for n in book.FEED_ORDER])
    witness = []
    for rows in reader():
        wexe.run(w64, feed={k: v.astype(np.float64) if k == 'img' else v
                            for k, v in feeder.feed(rows).items()},
                 fetch_list=[tr.loss.name], scope=wscope)
        witness.append({n: wscope.find(n).numpy().copy() for n in names})

    assert rec.events == jrec.events == (
        [('BeginEpochEvent', 0, None)]
        + [(e, 0, s) for s in range(3)
           for e in ('BeginStepEvent', 'EndStepEvent')]
        + [('EndEpochEvent', 0, None)])
    np.testing.assert_allclose([m[0] for m in rec.metrics],
                               [m[0] for m in jrec.metrics], rtol=1e-4)
    for name in names:
        np.testing.assert_allclose(rec.states[0][name], jrec.states[0][name],
                                   atol=ADAM_ATOL, rtol=0, err_msg=name)
    for s, name, reading, bound in lenet_readings(
            rec.states, jrec.states, witness, start, ADAM_ATOL / 10):
        assert reading <= bound, (s, name, reading, bound)
    kept = ['checkpoint_0_2', 'checkpoint_0_end']
    assert sorted(os.listdir(tmp_path / 'port')) == kept
    assert sorted(os.listdir(tmp_path / 'jax')) == kept
    assert tr.exe.lowering_count(tr.train_program) == 1

    test_reader = shaped(book.mnist_reader(1, 2, batch=BATCH))
    got = tr.test(test_reader, book.FEED_ORDER)
    want = jtr.test(test_reader, book.FEED_ORDER)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert abs(got[1] - want[1]) <= 1 / (2 * BATCH) + 1e-7


def test_save_params_and_the_inferencer(tmp_path):
    jtr, tr = trainer(jfluid, jcontrib), trainer(fluid, contrib)
    carried(jtr, tr)
    reader = shaped(book.mnist_reader(2, 2, batch=BATCH))
    jtr.train(1, lambda e: None, reader=reader, feed_order=book.FEED_ORDER)
    tr.train(1, lambda e: None, reader=reader, feed_order=book.FEED_ORDER)
    tr.save_params(str(tmp_path / 'port'))
    jtr.save_params(str(tmp_path / 'jax'))

    inf = contrib.Inferencer(lambda: book.inference_program(fluid),
                             str(tmp_path / 'port'), place=fluid.CPUPlace())
    jinf = jcontrib.Inferencer(lambda: book.inference_program(jfluid),
                               str(tmp_path / 'jax'),
                               place=jfluid.CPUPlace())
    rows = next(shaped(book.mnist_reader(3, 1, batch=BATCH))())
    img = np.stack([r[0] for r in rows])
    got, = inf.infer({'img': img})
    want, = jinf.infer({'img': img})
    assert got.shape == (BATCH, 10)
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match='map'):
        inf.infer([img])

    # the test program's softmax, in the trainer's scope
    test_program = tr.train_program.clone(for_test=True)
    softmax = [op for op in test_program.global_block().ops
               if op.type == 'softmax'][0].output_names()[0]
    feed = fluid.DataFeeder([tr.train_program.global_block().var(n)
                             for n in book.FEED_ORDER]).feed(rows)
    ref, = tr.exe.run(test_program, feed=feed, fetch_list=[softmax],
                      scope=tr.scope)
    assert np.abs(got - ref).max() == 0

    # the saved inference model of the loss and accuracy
    tr.save_inference_model(str(tmp_path / 'model'), book.FEED_ORDER, [0, 1])
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        prog, feeds, fetches = fluid.load_inference_model(
            str(tmp_path / 'model'), exe)
        assert feeds == book.FEED_ORDER and len(fetches) == 2
        loss, acc = exe.run(prog, feed=feed, fetch_list=fetches)
    want_loss, want_acc = tr.exe.run(test_program, feed=feed,
                                     fetch_list=tr.train_func_outputs,
                                     scope=tr.scope)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    np.testing.assert_array_equal(acc, want_acc)

    # param_path: a new Trainer starts from the saved parameters (the
    # optimizer's slots are named outside recognize_digits' name guard)
    again = trainer(fluid, contrib, param_path=str(tmp_path / 'port'))
    for p in tr.train_program.all_parameters():
        np.testing.assert_array_equal(again.scope.find(p.name).numpy(),
                                      tr.scope.find(p.name).numpy())


def test_mnist_rows_feed_the_declared_variables():
    """PaddleBook's row format, cast and reshaped by the port's Trainer,
    trains exactly as rows already in the declared form do."""
    a, b = trainer(fluid, contrib), trainer(fluid, contrib)
    scope_from_paddle(port_state(a), b.scope, fluid.CPUPlace(),
                      program=b.train_program)
    raw = book.mnist_reader(4, 3, batch=BATCH)
    first = next(raw())[0]
    assert first[0].shape == (784,) and isinstance(first[1], int)
    ra, rb = Recorder(lambda: None), Recorder(lambda: None)
    a.train(1, ra, reader=raw, feed_order=book.FEED_ORDER)
    b.train(1, rb, reader=shaped(raw), feed_order=book.FEED_ORDER)
    for ma, mb in zip(ra.metrics, rb.metrics):
        np.testing.assert_array_equal(ma[0], mb[0])
    assert np.isfinite([m[0] for m in ra.metrics]).all()


@pytest.mark.parametrize('how', ['stop', 'no_fetch'])
def test_stop_and_fetch_metrics_match_jax(how):
    jtr, tr = trainer(jfluid, jcontrib), trainer(fluid, contrib)
    reader = shaped(book.mnist_reader(5, 4, batch=BATCH))
    kw = ({'stop_at': 1} if how == 'stop' else {'fetch': False})
    jrec = Recorder(lambda: None, trainer=jtr, **kw)
    rec = Recorder(lambda: None, trainer=tr, **kw)
    jtr.train(2, jrec, reader=reader, feed_order=book.FEED_ORDER)
    tr.train(2, rec, reader=reader, feed_order=book.FEED_ORDER)
    assert rec.events == jrec.events
    assert [len(m) for m in rec.metrics] == [len(m) for m in jrec.metrics]
    if how == 'stop':
        assert rec.events[-2:] == [('EndStepEvent', 0, 1),
                                   ('EndEpochEvent', 0, None)]
    else:
        assert rec.metrics and all(m == [] for m in rec.metrics)


def test_checkpoint_config_must_be_one():
    for pkg, mod in ((fluid, contrib), (jfluid, jcontrib)):
        with pytest.raises(TypeError, match='CheckpointConfig'):
            mod.Trainer(lambda: book.train_program(pkg),
                        lambda: book.optimizer_func(pkg),
                        place=pkg.CPUPlace(), checkpoint_config='every 10')
    cfg = contrib.CheckpointConfig(epoch_interval=0, step_interval=-3)
    assert (cfg.epoch_interval, cfg.step_interval) == (1, 1)
    assert cfg.checkpoint_dir == os.getcwd()


def test_trainer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device is available'):
        contrib.Trainer(lambda: book.train_program(fluid),
                        lambda: book.optimizer_func(fluid))
