"""Fluid's high-level Inferencer (counterpart of
paddle_tpu/contrib/inferencer.py): ``infer_func`` builds the inference
graph in a fresh program, the parameters load from ``param_path``, and
``infer`` runs the test clone on ``place`` (the card if None)."""
from .. import io as fluid_io
from ..core.scope import Scope, scope_guard
from ..executor import Executor
from ..framework import Program, program_guard

__all__ = ['Inferencer']


class Inferencer:
    """``Inferencer(infer_func, param_path, place=None, parallel=False)``."""

    def __init__(self, infer_func, param_path, place=None, parallel=False):
        self.param_path = param_path
        self.scope = Scope()
        self.parallel = parallel
        self.place = place
        self.exe = Executor(place)
        self.inference_program = Program()
        startup = Program()
        with program_guard(self.inference_program, startup):
            out = infer_func()
            self.predict_var = (out[0] if isinstance(out, (list, tuple))
                                else out)
        self.inference_program = self.inference_program.clone(for_test=True)
        with scope_guard(self.scope):
            self.exe.run(startup)
            fluid_io.load_persistables(self.exe, param_path,
                                       self.inference_program)

    def infer(self, inputs, return_numpy=True):
        """``inputs``: {feed name: array}; returns [the prediction]."""
        if not isinstance(inputs, dict):
            raise ValueError(
                'inputs should be a map of {"input_name": input_var}')
        with scope_guard(self.scope):
            return self.exe.run(self.inference_program, feed=inputs,
                                fetch_list=[self.predict_var],
                                return_numpy=return_numpy)
