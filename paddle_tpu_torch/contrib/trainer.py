"""Fluid's high-level Trainer (counterpart of paddle_tpu/contrib/trainer.py).

``train_func`` builds the model in a fresh program and returns the loss (or
[loss, metric, ...]); ``optimizer_func`` returns the optimizer that
minimizes it. The Trainer owns the programs, a scope and an Executor on
``place`` (the card if None, which raises without one), runs epochs over a
reader, fires the four events, and saves checkpoints by
:class:`CheckpointConfig`, keeping the newest ``max_num_checkpoints``.

``feed_order`` names the feed variables in a row's order. Where a name is
declared in the program, the DataFeeder casts and reshapes that column to
the declaration, as Fluid 1.7's Trainer does (so PaddleBook's MNIST rows
of 784 floats and an int label feed a [1, 28, 28] image and an int64
label); the JAX package stacks the columns as given, which gives the same
feed for rows already in the declared shape and type."""
import os
import shutil

import numpy as np

from .. import io as fluid_io
from ..core.scope import Scope, scope_guard
from ..data_feeder import DataFeeder
from ..executor import Executor
from ..framework import Program, program_guard

__all__ = ['BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent',
           'EndStepEvent', 'CheckpointConfig', 'Trainer']


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    """``fetch_metrics``: set False in the handler to run the step without
    fetching ``train_func``'s outputs."""

    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    """``metrics``: the step's fetched ``train_func`` outputs."""

    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """Where (``checkpoint_dir``, the working directory if None) and how
    often (every ``step_interval`` steps and ``epoch_interval`` epochs) the
    Trainer saves its persistables, keeping the newest
    ``max_num_checkpoints``."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10):
        self.checkpoint_dir = checkpoint_dir or os.getcwd()
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(1, int(epoch_interval))
        self.step_interval = max(1, int(step_interval))
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial = None
        self.pserver_id = None
        self.lookup_table_name = None


class Trainer:
    """``Trainer(train_func, optimizer_func, param_path=None, place=None,
    parallel=False, checkpoint_config=None)`` (module docstring);
    ``param_path`` loads saved persistables after the startup program."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None):
        self.parallel = parallel
        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()
        self.checkpoint_cfg = checkpoint_config
        if self.checkpoint_cfg is not None and \
                not isinstance(self.checkpoint_cfg, CheckpointConfig):
            raise TypeError(
                'checkpoint_config must be a CheckpointConfig instance')

        with program_guard(self.train_program, self.startup_program):
            out = train_func()
            self.train_func_outputs = (list(out)
                                       if isinstance(out, (list, tuple))
                                       else [out])
            loss = self.train_func_outputs[0]
            optimizer_func().minimize(loss)
        self.loss = loss

        self.place = place
        self.exe = Executor(place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            if param_path is not None:
                fluid_io.load_persistables(self.exe, param_path,
                                           self.train_program)

    def _feeder(self, program, feed_order):
        block = program.global_block()
        return DataFeeder(
            feed_list=[block.vars.get(n, n) for n in feed_order],
            program=program)

    def stop(self):
        """End :meth:`train` before its next step."""
        self.__stopped = True

    def train(self, num_epochs, event_handler, reader=None, feed_order=None):
        """``num_epochs`` passes over ``reader()`` (batches of rows, or feed
        dicts without ``feed_order``), firing the events around each epoch
        and step."""
        self.__stopped = False
        feeder = (self._feeder(self.train_program, feed_order)
                  if feed_order else None)
        with scope_guard(self.scope):
            for epoch_id in range(num_epochs):
                if self.__stopped:
                    break
                event_handler(BeginEpochEvent(epoch_id))
                for step_id, data in enumerate(reader()):
                    if self.__stopped:
                        break
                    begin = BeginStepEvent(epoch_id, step_id)
                    event_handler(begin)
                    feed = feeder.feed(data) if feeder else data
                    fetch = (self.train_func_outputs
                             if begin.fetch_metrics else [])
                    metrics = self.exe.run(self.train_program, feed=feed,
                                           fetch_list=fetch)
                    event_handler(EndStepEvent(epoch_id, step_id, metrics))
                    cfg = self.checkpoint_cfg
                    if cfg and (step_id + 1) % cfg.step_interval == 0:
                        self._save_checkpoint(epoch_id, step_id)
                cfg = self.checkpoint_cfg
                if cfg and (epoch_id + 1) % cfg.epoch_interval == 0:
                    self._save_checkpoint(epoch_id, 'end')
                event_handler(EndEpochEvent(epoch_id))

    def test(self, reader, feed_order):
        """The mean over ``reader()``'s batches of each ``train_func``
        output's mean, on the test clone of the program."""
        test_program = self.train_program.clone(for_test=True)
        feeder = self._feeder(test_program, feed_order)
        totals, count = None, 0
        with scope_guard(self.scope):
            for data in reader():
                vals = self.exe.run(test_program, feed=feeder.feed(data),
                                    fetch_list=self.train_func_outputs)
                vals = [np.mean(v) for v in vals]
                totals = vals if totals is None else \
                    [a + b for a, b in zip(totals, vals)]
                count += 1
        if count == 0:
            return []
        return [t / count for t in totals]

    def save_params(self, param_path):
        """Save the train program's persistables to ``param_path``."""
        with scope_guard(self.scope):
            fluid_io.save_persistables(self.exe, param_path,
                                       self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        """Save the inference model of ``train_func``'s outputs at
        ``target_var_indexes``, fed by ``feeded_var_names``."""
        with scope_guard(self.scope):
            fluid_io.save_inference_model(
                param_path, feeded_var_names,
                [self.train_func_outputs[i] for i in target_var_indexes],
                self.exe, self.train_program)

    def _save_checkpoint(self, epoch_id, step_id):
        cfg = self.checkpoint_cfg
        d = os.path.join(cfg.checkpoint_dir,
                         f'checkpoint_{epoch_id}_{step_id}')
        fluid_io.save_persistables(self.exe, d, self.train_program)
        # keep the newest max_num_checkpoints (by mtime, then name)
        kept = sorted(
            (p for p in os.listdir(cfg.checkpoint_dir)
             if p.startswith('checkpoint_')),
            key=lambda p: (os.path.getmtime(
                os.path.join(cfg.checkpoint_dir, p)), p))
        while len(kept) > cfg.max_num_checkpoints:
            shutil.rmtree(os.path.join(cfg.checkpoint_dir, kept.pop(0)),
                          ignore_errors=True)
