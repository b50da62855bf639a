"""Recurrent cells and layers (counterpart of the first part of
paddle_tpu/layers/rnn.py and its ``lstm``): ``RNNCell``, ``GRUCell``,
``LSTMCell``, ``rnn``, ``birnn`` and ``lstm``.

``rnn(cell, inputs)`` builds the cell's step into a ``StaticRNN`` (one
``__scan__`` op) over the time-major inputs; with ``sequence_length`` a
(T, B) mask freezes each row's states past its length and zeroes its
outputs there, so the final states are each row's last valid ones. Under
a ``dygraph.guard`` it is a Python loop over time on tensors, and a cell's
weights are dygraph Parameters (the JAX package's cells make static
Parameters there, so its cells run in static programs only). ``lstm`` is
stacked ``LSTMCell`` s over ``rnn``, the parity surface of the
reference's cuDNN ``lstm`` op, with that op's ``default_initializer`` for
the weights (the JAX package's ``lstm`` takes it and leaves it unused).

The decoders, ``beam_search``, ``gather_tree``, the ``dynamic_*`` LoD
recurrences, ``lstm_unit`` and ``gru_unit`` are not ported (ROADMAP A.10
and A.8g): they are callables that raise, from layers/__init__.py's
table.
"""
from __future__ import annotations

import copy

import numpy as np

from ..core import unique_name
from ..core.dtypes import convert_dtype
from ..framework import in_dygraph_mode
from ..initializer import ConstantInitializer, XavierInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from . import nn as nn_layers
from . import tensor as tensor_layers
from .control_flow import StaticRNN, less_than
from .utils import flatten as _flatten
from .utils import map_structure as _map_structure
from .utils import pack_sequence_as as _pack

__all__ = ['RNNCell', 'GRUCell', 'LSTMCell', 'rnn', 'birnn', 'lstm']


def _parameter(helper, attr, shape, dtype, is_bias=False):
    """``helper.create_parameter`` in a static program; under a
    ``dygraph.guard`` a dygraph Parameter of the same name, initializer
    and attrs, on the guard's device."""
    if not in_dygraph_mode():
        return helper.create_parameter(attr, shape, dtype, is_bias=is_bias)
    from ..dygraph.base import _current_device
    from ..dygraph.tape import Parameter
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    attr = copy.copy(attr)
    name = attr.name or unique_name.generate(
        '.'.join([helper.name, 'b' if is_bias else 'w']))
    init = attr.initializer or (
        ConstantInitializer(0.0) if is_bias else XavierInitializer())
    value = init.compute([int(s) for s in shape], convert_dtype(dtype),
                         _current_device())
    return Parameter(value, name=name, trainable=attr.trainable,
                     regularizer=attr.regularizer,
                     learning_rate=attr.learning_rate)


class RNNCell:
    """One step of a recurrence, for ``rnn``: ``call(inputs, states) ->
    (outputs, new_states)``."""

    def call(self, inputs, states, **kwargs):
        raise NotImplementedError

    def __call__(self, inputs, states, **kwargs):
        return self.call(inputs, states, **kwargs)

    @property
    def state_shape(self):
        raise NotImplementedError

    def get_initial_states(self, batch_ref, shape=None, dtype='float32',
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value`` in the structure of ``state_shape``,
        their batch dim taken from ``batch_ref``."""
        shape = shape if shape is not None else self.state_shape

        def is_shape(s):
            return isinstance(s, (list, tuple)) and \
                all(isinstance(e, int) for e in s)

        def rec(s):
            if is_shape(s):
                return tensor_layers.fill_constant_batch_size_like(
                    batch_ref, [-1] + list(s), dtype, float(init_value),
                    input_dim_idx=batch_dim_idx)
            return type(s)(rec(e) for e in s)

        return rec(shape)


class GRUCell(RNNCell):
    """``u, r = σ([x, h] Wg + bg)``, ``c̃ = tanh([x, r ⊙ h] Wc + bc)``,
    ``h' = u ⊙ h + (1 − u) ⊙ c̃``; weights made at the first call."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, dtype='float32',
                 name='GRUCell'):
        self.hidden_size = hidden_size
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.gate_act = gate_activation or nn_layers.sigmoid
        self.act = activation or nn_layers.tanh
        self.dtype = dtype
        self.name = name
        self._built = False

    def _build(self, input_size):
        helper = LayerHelper(self.name, param_attr=self.param_attr,
                             bias_attr=self.bias_attr)
        D = self.hidden_size
        self.gate_w = _parameter(helper, helper.param_attr,
                                 [input_size + D, 2 * D], self.dtype)
        self.gate_b = _parameter(helper, helper.bias_attr, [2 * D],
                                 self.dtype, is_bias=True)
        self.cand_w = _parameter(helper, helper.param_attr,
                                 [input_size + D, D], self.dtype)
        self.cand_b = _parameter(helper, helper.bias_attr, [D], self.dtype,
                                 is_bias=True)
        self._built = True

    def call(self, inputs, states):
        if not self._built:
            self._build(inputs.shape[-1])
        h = states
        xh = tensor_layers.concat([inputs, h], axis=-1)
        gates = self.gate_act(
            nn_layers.matmul(xh, self.gate_w) + self.gate_b)
        u, r = nn_layers.split(gates, 2, dim=-1)
        xrh = tensor_layers.concat([inputs, r * h], axis=-1)
        c = self.act(nn_layers.matmul(xrh, self.cand_w) + self.cand_b)
        new_h = u * h + (1.0 - u) * c
        return new_h, new_h

    @property
    def state_shape(self):
        return [self.hidden_size]


class LSTMCell(RNNCell):
    """The basic LSTM unit on one fused weight ``[x, h] W + b`` cut into
    gates ``i, c̃, f, o``: ``c' = c ⊙ σ(f + forget_bias) + σ(i) ⊙
    tanh(c̃)``, ``h' = tanh(c') ⊙ σ(o)``; weights made at the first
    call."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, forget_bias=1.0,
                 dtype='float32', name='LSTMCell'):
        self.hidden_size = hidden_size
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.gate_act = gate_activation or nn_layers.sigmoid
        self.act = activation or nn_layers.tanh
        self.forget_bias = forget_bias
        self.dtype = dtype
        self.name = name
        self._built = False

    def _build(self, input_size):
        helper = LayerHelper(self.name, param_attr=self.param_attr,
                             bias_attr=self.bias_attr)
        D = self.hidden_size
        self.weight = _parameter(helper, helper.param_attr,
                                 [input_size + D, 4 * D], self.dtype)
        self.bias = _parameter(helper, helper.bias_attr, [4 * D], self.dtype,
                               is_bias=True)
        self._built = True

    def call(self, inputs, states):
        if not self._built:
            self._build(inputs.shape[-1])
        pre_h, pre_c = states
        xh = tensor_layers.concat([inputs, pre_h], axis=-1)
        gates = nn_layers.matmul(xh, self.weight) + self.bias
        i, j, f, o = nn_layers.split(gates, 4, dim=-1)
        new_c = pre_c * self.gate_act(f + self.forget_bias) \
            + self.gate_act(i) * self.act(j)
        new_h = self.act(new_c) * self.gate_act(o)
        return new_h, [new_h, new_c]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """``cell`` over the time dim of ``inputs`` (B, T, D), or (T, B, D)
    when ``time_major``; returns ``(outputs, final_states)``. A row's steps
    at and past its ``sequence_length`` carry its states through and give
    zero outputs."""
    if initial_states is None:
        initial_states = cell.get_initial_states(
            batch_ref=inputs, batch_dim_idx=1 if time_major else 0)
    if in_dygraph_mode():
        return _rnn_dygraph(cell, inputs, initial_states, sequence_length,
                            time_major, is_reverse, **kwargs)

    x = inputs if time_major else nn_layers.transpose(inputs, perm=[1, 0, 2])
    T = x.shape[0]
    if is_reverse:
        x = tensor_layers.reverse(x, axis=[0])
    mask = None
    if sequence_length is not None:
        t_idx = tensor_layers.fill_constant_array(
            np.arange(T).reshape(T, 1).astype(np.int64))
        # (T, 1) < (1, B): the (T, B) validity mask
        mask = less_than(t_idx, nn_layers.reshape(
            tensor_layers.cast(sequence_length, 'int64'), shape=[1, -1]))
        if is_reverse:
            mask = tensor_layers.reverse(mask, axis=[0])
        mask = tensor_layers.cast(mask, x.dtype)

    srnn = StaticRNN()
    flat_init = _flatten(initial_states)
    with srnn.step():
        x_t = srnn.step_input(x)
        m_t = srnn.step_input(mask) if mask is not None else None
        pre = [srnn.memory(init=s) for s in flat_init]
        out, new_states = cell.call(x_t, _pack(initial_states, pre),
                                    **kwargs)
        out_template = out
        flat_new = _flatten(new_states)
        out_flat = _flatten(out)
        if m_t is not None:
            m_col = nn_layers.reshape(m_t, shape=[-1, 1])
            flat_new = [nw * m_col + pv * (1.0 - m_col)
                        for nw, pv in zip(flat_new, pre)]
            out_flat = [o * m_col for o in out_flat]
        for pv, nw in zip(pre, flat_new):
            srnn.update_memory(pv, nw)
        for o in out_flat + flat_new:
            srnn.step_output(o)
    res = srnn()
    res = res if isinstance(res, list) else [res]
    n_states = len(flat_init)
    outs_seq, states_seq = res[:len(res) - n_states], res[len(res) - n_states:]
    # the mask already carried each row's last valid state to step T - 1
    final_flat = [nn_layers.reshape(
        nn_layers.slice(s, axes=[0], starts=[T - 1], ends=[T]),
        shape=list(s.shape[1:])) for s in states_seq]
    final_states = _pack(initial_states, final_flat)
    if is_reverse:
        outs_seq = [tensor_layers.reverse(o, axis=[0]) for o in outs_seq]
    if not time_major:
        outs_seq = [nn_layers.transpose(
            o, perm=[1, 0] + list(range(2, len(o.shape)))) for o in outs_seq]
    return _pack(out_template, outs_seq), final_states


def _rnn_dygraph(cell, inputs, initial_states, sequence_length, time_major,
                 is_reverse, **kwargs):
    from ..dygraph.tape import Tensor
    axis_t = 0 if time_major else 1
    T = inputs.shape[axis_t]
    states = initial_states
    outs = []
    lens = sequence_length.numpy() if sequence_length is not None else None
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        x_t = inputs[t] if time_major else inputs[:, t]
        out, new_states = cell.call(x_t, states, **kwargs)
        if lens is not None:
            m_t = Tensor((t < lens).astype(np.float32).reshape(-1, 1),
                         stop_gradient=True)
            new_flat = [nw * m_t + pv * (1.0 - m_t) for nw, pv in
                        zip(_flatten(new_states), _flatten(states))]
            new_states = _pack(states, new_flat)
            out = _map_structure(lambda o: o * m_t, out)
        states = new_states
        outs.append(out)
    if is_reverse:
        outs = outs[::-1]
    stacked = _map_structure(
        lambda *os: nn_layers.stack(list(os), axis=axis_t), *outs)
    return stacked, states


def birnn(cell_fw, cell_bw, inputs, initial_states=None, sequence_length=None,
          time_major=False, **kwargs):
    """A forward and a reversed ``rnn``, their outputs concatenated on the
    last dim; returns ``(outputs, (fw states, bw states))``."""
    states_fw, states_bw = (initial_states if initial_states is not None
                            else (None, None))
    out_fw, st_fw = rnn(cell_fw, inputs, states_fw, sequence_length,
                        time_major=time_major, **kwargs)
    out_bw, st_bw = rnn(cell_bw, inputs, states_bw, sequence_length,
                        time_major=time_major, is_reverse=True, **kwargs)
    outputs = tensor_layers.concat([out_fw, out_bw], axis=-1)
    return outputs, (st_fw, st_bw)


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """A stacked (optionally bidirectional) LSTM over time-major input
    (T, B, D), with ``dropout_prob`` between layers; returns ``(out,
    last_h, last_c)``, the last two (num_layers x directions, B,
    hidden_size). ``init_h`` and ``init_c`` hold one (B, hidden_size)
    state a layer and direction (``init_h[k]``: a list in a static
    program, as the JAX package indexes them), or are None for zeros."""

    def cell(suffix):
        attr = (None if default_initializer is None
                else ParamAttr(initializer=default_initializer))
        return LSTMCell(hidden_size, param_attr=attr,
                        name=f'{name or "lstm"}_l{suffix}')

    x = input
    last_hs, last_cs = [], []
    for layer in range(num_layers):
        if is_bidirec:
            fw, bw = cell(f'{layer}_fw'), cell(f'{layer}_bw')
            init = None
            if init_h is not None and init_c is not None:
                i0, i1 = 2 * layer, 2 * layer + 1
                init = ([init_h[i0], init_c[i0]], [init_h[i1], init_c[i1]])
            x, (st_fw, st_bw) = birnn(fw, bw, x, init, time_major=True)
            last_hs += [st_fw[0], st_bw[0]]
            last_cs += [st_fw[1], st_bw[1]]
        else:
            init = None
            if init_h is not None and init_c is not None:
                init = [init_h[layer], init_c[layer]]
            x, st = rnn(cell(layer), x, init, time_major=True)
            last_hs.append(st[0])
            last_cs.append(st[1])
        if dropout_prob > 0.0 and not is_test and layer < num_layers - 1:
            x = nn_layers.dropout(x, dropout_prob)
    return x, nn_layers.stack(last_hs, axis=0), nn_layers.stack(last_cs,
                                                                axis=0)
