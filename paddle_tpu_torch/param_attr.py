"""ParamAttr and WeightNormParamAttr (counterpart of
paddle_tpu/param_attr.py): a parameter's name, initializer, learning rate,
regularizer and trainability.

``WeightNormParamAttr`` constructs, but no layer takes it: the JAX package
stores its ``dim`` and never normalises a weight (ROADMAP C.4 item 10), so
a layer given one raises naming that item instead of training an
unnormalised weight in silence."""
from __future__ import annotations

from .initializer import ConstantInitializer, Initializer

__all__ = ['ParamAttr', 'WeightNormParamAttr']


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.gradient_clip = gradient_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, WeightNormParamAttr):
            raise NotImplementedError(
                'WeightNormParamAttr: weight normalisation is not applied '
                'by the JAX package, which stores the attribute and trains '
                'the plain weight (ROADMAP C.4 item 10)')
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        if isinstance(arg, (int, float)):
            return ParamAttr(initializer=ConstantInitializer(float(arg)))
        raise TypeError(f'cannot make ParamAttr from {arg!r}')

    def _to_kwargs(self, with_initializer=False):
        kw = {'name': self.name, 'learning_rate': self.learning_rate,
              'regularizer': self.regularizer, 'trainable': self.trainable,
              'do_model_average': self.do_model_average}
        if with_initializer:
            kw['initializer'] = self.initializer
        return kw


class WeightNormParamAttr(ParamAttr):
    """A weight-normalised parameter's attribute (``dim``: the axis kept
    apart in the norm). Constructs; a layer given it raises (module
    docstring)."""

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
