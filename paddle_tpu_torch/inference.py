"""The inference library (counterpart of paddle_tpu/inference.py):
``Config``, ``Predictor`` and ``create_paddle_predictor``.

A Predictor loads a saved inference model (io.load_inference_model) into
a Scope of its own and runs it through an Executor, the card's by default
or the one passed in (``Executor(CPUPlace())`` on the CPU). The executor
lowers the program once per set of feed shapes and reuses the plan.

``Config.enable_bf16`` does what the JAX package's does and no more: each
f32 feed is rounded to bf16 (on the executor's device), and the executor
then casts it to its variable's type, so the saved model computes as it
was saved (f32) on bf16-rounded inputs.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``Config.enable_int8`` (A.10: weight-only int8 rides on the
``dequantize_linear`` quant op) and the StableHLO exports
``export_stablehlo``/``export_program_stablehlo`` (A.11).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.scope import Scope, scope_guard

__all__ = ['Config', 'Predictor', 'create_paddle_predictor',
           'export_stablehlo', 'export_program_stablehlo']


class Config:
    """The model's directory and file names, and ``precision``: 'float32',
    or 'bfloat16' after :meth:`enable_bf16`."""

    def __init__(self, model_dir=None, model_filename=None,
                 params_filename=None):
        self.model_dir = model_dir
        self.model_filename = model_filename
        self.params_filename = params_filename
        self.precision = 'float32'

    def enable_bf16(self):
        """Round the f32 feeds to bf16; returns the Config."""
        self.precision = 'bfloat16'
        return self

    def enable_int8(self, quant_scales=None, weight_bits=8):
        raise NotImplementedError('Config.enable_int8: weight-only int8 '
                                  'needs the dequantize_linear quant op, '
                                  'not ported yet (ROADMAP A.10)')

    # toggles of the reference's GPU library, accepted as no-ops
    def enable_use_gpu(self, *a, **k):
        return self

    def switch_use_feed_fetch_ops(self, *a, **k):
        return self

    def disable_glog_info(self):
        return self


class Predictor:
    """``Predictor(config_or_dir, executor=None)``: the saved model,
    loaded into its own Scope; :meth:`run` feeds it and returns the
    fetches as numpy arrays."""

    def __init__(self, config_or_dir, executor=None):
        from .executor import Executor
        from .io import load_inference_model
        cfg = (config_or_dir if isinstance(config_or_dir, Config)
               else Config(str(config_or_dir)))
        self.config = cfg
        self._exe = executor if executor is not None else Executor()
        self._scope = Scope()
        with scope_guard(self._scope):
            prog, feeds, fetches = load_inference_model(
                cfg.model_dir, self._exe, cfg.model_filename,
                cfg.params_filename)
        self.program = prog
        self.feed_names = feeds
        self.fetch_vars = fetches

    @property
    def executor(self):
        return self._exe

    def get_input_names(self):
        return list(self.feed_names)

    def get_output_names(self):
        return [v.name for v in self.fetch_vars]

    def run(self, inputs):
        """``inputs``: arrays in feed order, or {name: array}."""
        feed = (inputs if isinstance(inputs, dict)
                else dict(zip(self.feed_names, inputs)))
        if self.config.precision == 'bfloat16':
            feed = {k: self._to_bf16(v) for k, v in feed.items()}
        return self._exe.run(self.program, feed=feed,
                             fetch_list=self.fetch_vars, scope=self._scope)


    def _to_bf16(self, value):
        """An f32 feed as a bf16 tensor on the executor's device; any other
        feed as it is."""
        if isinstance(value, torch.Tensor):
            return (value.to(torch.bfloat16)
                    if value.dtype == torch.float32 else value)
        arr = np.asarray(value)
        if arr.dtype != np.float32:
            return value
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self._exe.device).to(torch.bfloat16)


def create_paddle_predictor(config):
    return Predictor(config)


def export_stablehlo(fn, example_args, path=None, bf16=False):
    raise NotImplementedError('export_stablehlo is not ported yet (ROADMAP '
                              'A.11)')


def export_program_stablehlo(program, feed_shapes, fetch_list, path=None,
                             scope=None, feed_dtypes=None):
    raise NotImplementedError('export_program_stablehlo is not ported yet '
                              '(ROADMAP A.11)')
