"""Recurrent cells, layers and decoders (counterpart of
paddle_tpu/layers/rnn.py but its LoD recurrences): ``RNNCell``,
``GRUCell``, ``LSTMCell``, ``rnn``, ``birnn`` and ``lstm``; the beam search
(``BeamSearchDecoder``, ``gather_tree``, the legacy ``beam_search`` and
``beam_search_decode``) and the ``Decoder``/``DecodeHelper`` family
(``BasicDecoder`` with ``TrainingHelper``, ``GreedyEmbeddingHelper`` or
``SampleEmbeddingHelper``), both driven by ``dynamic_decode``.

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

``dynamic_decode`` runs the decoder's ``step`` in one ``StaticRNN`` of
``max_step_num`` steps in a static program (finished beams masked, the
trip count fixed, as the JAX package); under a ``dygraph.guard`` it is a
loop that stops once every beam has finished, so its outputs may have
fewer steps. The beam search keeps a dense (batch, beam) layout: scores
start at 0 for beam 0 and -1e9 for the others, and a finished beam
continues only with ``end_token`` at its score. Where the JAX package
departs from the reference's documented API (``beam_search``'s outputs,
``beam_search_decode``'s parents, dygraph decoding), the port follows the
reference (ROADMAP C.11).

``gru_unit`` is one GRU step over the ``gru_unit`` op (ops/extra_ops.py),
as the JAX package builds it. The ``dynamic_*`` LoD recurrences and
``lstm_unit`` are not ported (ROADMAP A.10): they are callables that
raise, from layers/__init__.py's table.
"""
from __future__ import annotations

import collections
import copy

import numpy as np

from ..core import unique_name
from ..core.dtypes import convert_dtype
from ..framework import in_dygraph_mode
from ..initializer import ConstantInitializer, XavierInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from . import nn as nn_layers
from .common import apply_op_layer
from . import tensor as tensor_layers
from .control_flow import StaticRNN, less_than
from .utils import flatten as _flatten
from .utils import map_structure as _map_structure
from .utils import pack_sequence_as as _pack

__all__ = ['RNNCell', 'GRUCell', 'LSTMCell', 'rnn', 'birnn', 'lstm',
           'BeamSearchDecoder', 'dynamic_decode', 'beam_search',
           'beam_search_decode', 'gather_tree', 'Decoder', 'DecodeHelper',
           'TrainingHelper', 'GreedyEmbeddingHelper',
           'SampleEmbeddingHelper', 'BasicDecoderOutput', 'BasicDecoder',
           'gru_unit']


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


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation='tanh', gate_activation='sigmoid',
             origin_mode=False):
    """One GRU step: ``input`` is the (B, 3D) projected input (the fc
    comes before, as in the reference), ``hidden`` (B, D); creates the
    (D, 3D) recurrent weight and the (1, 3D) bias, f32, and returns (new
    hidden, reset hidden, gate). The gates are sigmoid and the candidate
    tanh; other activations raise ``ValueError``, as in the JAX
    package."""
    if activation != 'tanh' or gate_activation != 'sigmoid':
        raise ValueError('gru_unit supports the reference defaults '
                         "activation='tanh', gate_activation='sigmoid'")
    helper = LayerHelper('gru_unit', param_attr=param_attr,
                         bias_attr=bias_attr)
    d = size // 3
    w = helper.create_parameter(helper.param_attr, [d, 3 * d], 'float32')
    bias = helper.create_parameter(helper.bias_attr, [1, 3 * d], 'float32',
                                   is_bias=True)
    return apply_op_layer(
        'gru_unit', {'x': input, 'hidden': hidden, 'weight': w, 'bias': bias},
        {'origin_mode': origin_mode})


# ------------------------------------------------------------ beam search


def gather_tree(ids, parents):
    """The beam-search backtrace of (T, B, W) ``ids`` along their
    ``parents`` (each step's beam index in the step before)."""
    return apply_op_layer('gather_tree', {'ids': ids, 'parents': parents})


def expand_to_beam(x, beam_size):
    """(B, ...) -> (B*W, ...), each row repeated W times in a row (the
    reference's ``tile_beam_merge_with_batch``)."""
    ex = nn_layers.unsqueeze(x, axes=[1])
    ex = nn_layers.expand(
        ex, expand_times=[1, beam_size] + [1] * (len(x.shape) - 1))
    return nn_layers.reshape(ex, shape=[-1] + list(x.shape[1:]))


class BeamSearchDecoder:
    """Beam search over ``cell`` in a dense (batch, beam) layout with
    static shapes: each step takes the top ``beam_size`` of each batch
    row's W x V continuations, a finished beam continuing only with
    ``end_token`` at its score. Beams start as beam 0 at score 0 and the
    others at -1e9. ``step`` takes no keyword arguments, as the JAX
    package's: a cell that reads more than its inputs and states carries
    it itself (ROADMAP C.11)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _merge(self, x):
        """(B, W, ...) -> (B*W, ...)"""
        return nn_layers.reshape(x, shape=[-1] + list(x.shape[2:]))

    def _split(self, x, B):
        """(B*W, ...) -> (B, W, ...)"""
        return nn_layers.reshape(
            x, shape=[B, self.beam_size] + list(x.shape[1:]))

    def _expand_to_beam(self, x):
        return expand_to_beam(x, self.beam_size)

    def initialize(self, initial_cell_states):
        """The start tokens' inputs (B, W, ...) and the states ``[cell
        states (B*W, ...), log probs (B, W), finished (B, W) float,
        lengths (B, W) int64]``."""
        flat = _flatten(initial_cell_states)
        B = flat[0].shape[0]
        self._batch_size = B
        W = self.beam_size
        cell_states = _pack(initial_cell_states,
                            [self._expand_to_beam(s) for s in flat])
        start_ids = tensor_layers.fill_constant_array(
            np.full((B, W), self.start_token, np.int64))
        inputs = self.embedding_fn(start_ids) if self.embedding_fn \
            else tensor_layers.cast(start_ids, 'float32')
        log_probs = tensor_layers.fill_constant_array(
            np.tile(np.array([0.0] + [-1e9] * (W - 1), np.float32), (B, 1)))
        finished = tensor_layers.fill_constant_array(
            np.zeros((B, W), np.float32))
        lengths = tensor_layers.fill_constant_array(
            np.zeros((B, W), np.int64))
        return inputs, [cell_states, log_probs, finished, lengths]

    def step(self, time, inputs, states):
        """One search step: returns ``([scores, token ids, parent beams]
        (B, W) each, next states, next inputs, next finished)``."""
        cell_states, log_probs, finished, lengths = states
        B, W = self._batch_size, self.beam_size
        flat_in = self._merge(inputs) if len(inputs.shape) > 2 else inputs
        cell_out, next_cell_states = self.cell.call(flat_in, cell_states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        V = logits.shape[-1]
        step_lp = self._split(
            apply_op_layer('log_softmax', {'x': logits}), B)    # (B, W, V)
        noend = np.full((V,), -1e9, np.float32)
        noend[self.end_token] = 0.0
        noend_t = tensor_layers.fill_constant_array(noend.reshape(1, 1, V))
        fin3 = nn_layers.reshape(finished, shape=[B, W, 1])
        step_lp = step_lp * (1.0 - fin3) + noend_t * fin3
        total = nn_layers.reshape(log_probs, shape=[B, W, 1]) + step_lp
        flat_lp = nn_layers.reshape(total, shape=[B, W * V])
        top_scores, top_idx = nn_layers.topk(flat_lp, W)       # (B, W)
        beam_idx = tensor_layers.cast(top_idx, 'int64') // np.int64(V)
        token_ids = tensor_layers.cast(top_idx, 'int64') % np.int64(V)
        offs = tensor_layers.fill_constant_array(
            (np.arange(B) * W).reshape(B, 1).astype(np.int64))
        flat_sel = nn_layers.reshape(beam_idx + offs, shape=[B * W])

        def sel(x):
            return nn_layers.gather(x, flat_sel)

        next_cell_states = _pack(next_cell_states,
                                 [sel(s) for s in _flatten(next_cell_states)])
        fin_flat = nn_layers.reshape(finished, shape=[B * W])
        len_flat = nn_layers.reshape(lengths, shape=[B * W])
        prev_fin = nn_layers.reshape(sel(fin_flat), shape=[B, W])
        prev_len = nn_layers.reshape(sel(len_flat), shape=[B, W])
        now_end = tensor_layers.cast(
            nn_layers.reshape(token_ids, shape=[B, W])
            == np.int64(self.end_token), 'float32')
        next_finished = nn_layers.elementwise_max(prev_fin, now_end)
        next_lengths = prev_len + tensor_layers.cast(1.0 - prev_fin, 'int64')
        next_inputs = self.embedding_fn(token_ids) if self.embedding_fn \
            else tensor_layers.cast(token_ids, 'float32')
        outputs = [top_scores, token_ids, beam_idx]
        next_states = [next_cell_states, top_scores, next_finished,
                       next_lengths]
        return outputs, next_states, next_inputs, next_finished

    def finalize(self, outputs, final_states, sequence_lengths=None):
        """``[scores, token ids, parent beams]`` (T, B, W) -> (each final
        beam's ids (T, B, W) by ``gather_tree``, the scores)."""
        scores, token_ids, parent_ids = outputs
        return gather_tree(token_ids, parent_ids), scores


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, is_test=True, return_length=False,
                   **kwargs):
    """``decoder.step`` from ``decoder.initialize(inits)``, then
    ``decoder.finalize``; returns ``(outputs, final states)`` (and None
    for the lengths with ``return_length``), batch-major unless
    ``output_time_major``. A static program runs ``max_step_num`` steps
    (default 100) in one ``__scan__``, finished beams masked; under a
    ``dygraph.guard`` it is a loop that stops once every beam has
    finished (one host read a step), so the outputs' T may be shorter.
    ``kwargs`` go to every ``step``."""
    if max_step_num is None:
        max_step_num = 100
    initial_inputs, initial_states = decoder.initialize(inits)
    if in_dygraph_mode():
        return _dynamic_decode_dygraph(decoder, initial_inputs,
                                       initial_states, max_step_num,
                                       output_time_major, return_length,
                                       **kwargs)
    times = tensor_layers.fill_constant_array(
        np.arange(max_step_num, dtype=np.int64))
    srnn = StaticRNN()
    flat_init = _flatten([initial_inputs, initial_states])
    with srnn.step():
        t = srnn.step_input(times)
        pre = [srnn.memory(init=s) for s in flat_init]
        inputs, states = _pack([initial_inputs, initial_states], pre)
        outputs, next_states, next_inputs, next_finished = decoder.step(
            t, inputs, states, **kwargs)
        for pv, nw in zip(pre, _flatten([next_inputs, next_states])):
            srnn.update_memory(pv, nw)
        for o in _flatten(outputs):
            srnn.step_output(o)
    res = srnn()
    res = res if isinstance(res, list) else [res]
    return _finish(decoder, _pack(outputs, res), output_time_major,
                   return_length)


def _finish(decoder, stacked, output_time_major, return_length):
    a, b = (decoder.finalize(stacked, None)
            if hasattr(decoder, 'finalize') else (stacked, None))
    if not output_time_major:
        a = _map_structure(_transpose_batch_time, a)
        b = _map_structure(_transpose_batch_time, b) if b is not None else b
    return (a, b, None) if return_length else (a, b)


def _transpose_batch_time(x):
    """(T, B, ...) <-> (B, T, ...); anything of rank below 2 passes."""
    if x is None or getattr(x, 'shape', None) is None:
        return x
    if len(x.shape) < 2:
        return x
    return apply_op_layer('transpose_batch_time', {'x': x})


def _dynamic_decode_dygraph(decoder, inputs, states, max_step_num,
                            output_time_major, return_length, **kwargs):
    from ..dygraph.tape import Tensor
    outs = []
    for t in range(max_step_num):
        outputs, states, inputs, finished = decoder.step(
            Tensor(np.int64(t), stop_gradient=True), inputs, states,
            **kwargs)
        outs.append(outputs)
        if bool((finished > 0.5).all()):
            break
    stacked = _map_structure(lambda *os: nn_layers.stack(list(os), axis=0),
                             *outs)
    return _finish(decoder, stacked, output_time_major, return_length)


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One step of beam search over dense candidates: ``pre_ids`` and
    ``pre_scores`` (B*W, 1), ``ids`` and ``scores`` (B*W, K). Returns
    ``(selected_ids, selected_scores)`` (B*W, 1), and the flat parent
    index (B*W,) with ``return_parent_idx``, as the reference documents
    (the JAX package returns all three always, ROADMAP C.11)."""
    out = apply_op_layer(
        'beam_search_step',
        {'pre_ids': pre_ids, 'pre_scores': pre_scores, 'ids': ids,
         'scores': scores},
        {'beam_size': beam_size, 'end_id': end_id,
         'is_accumulated': is_accumulated,
         'return_parent_idx': return_parent_idx}, name=name)
    return out if return_parent_idx else out[:2]


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    """The full sequences of a finished search and their accumulated
    scores: ``ids`` (T, B, W) each step's selected ids, or a pair ``(ids,
    parents)`` with each step's parent beam (its beam index within the
    batch row, as ``beam_search``'s parent index mod W); ``scores`` (T, B,
    W). Both are walked back along the parents (a beam is its own parent
    where none are given). Returns ``(sentence ids, sentence scores)``,
    (T, B, W) each. The JAX package backtraces ``ids`` along ``scores``
    (ROADMAP C.11)."""
    if isinstance(ids, (list, tuple)):
        ids, parents = ids
    else:
        T, B, W = ids.shape
        parents = tensor_layers.fill_constant_array(np.ascontiguousarray(
            np.broadcast_to(np.arange(W, dtype=np.int64), (T, B, W))))
    return gather_tree(ids, parents), gather_tree(scores, parents)


# ------------------------------------------- the Decoder / DecodeHelper API


class Decoder:
    """A one-step decoder that ``dynamic_decode`` drives."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class DecodeHelper:
    """Samples ids from a step's outputs and makes the next step's
    inputs, for ``BasicDecoder``."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


def _gather_time(x_tm, time):
    """(T, B, ...) at the int scalar ``time`` -> (B, ...), a gather on the
    device (no host read)."""
    idx = nn_layers.reshape(tensor_layers.cast(time, 'int64'), shape=[1])
    step = nn_layers.gather(x_tm, idx)
    return nn_layers.reshape(step, shape=list(x_tm.shape[1:]))


class TrainingHelper(DecodeHelper):
    """Teacher forcing: step t's input is the given sequence's step t; a
    row finishes at its ``sequence_length`` (else at T)."""

    def __init__(self, inputs, sequence_length=None, time_major=False):
        self.inputs_tm = inputs if time_major \
            else _transpose_batch_time(inputs)
        self.T = self.inputs_tm.shape[0]
        self.sequence_length = sequence_length

    def initialize(self):
        first = _gather_time(self.inputs_tm,
                             tensor_layers.fill_constant([1], 'int64', 0))
        if self.sequence_length is not None:
            fin = tensor_layers.cast(
                apply_op_layer('less_equal',
                               {'x': self.sequence_length,
                                'y': tensor_layers.fill_constant(
                                    [1], 'int64', 0)}), 'float32')
        else:
            fin = tensor_layers.fill_constant_batch_size_like(
                self.inputs_tm, [-1], 'float32', 0.0, input_dim_idx=1,
                output_dim_idx=0)
        return first, fin

    def sample(self, time, outputs, states):
        return nn_layers.reshape(
            tensor_layers.cast(nn_layers.argmax(outputs, axis=-1), 'int64'),
            shape=[-1])

    def next_inputs(self, time, outputs, states, sample_ids):
        next_time = tensor_layers.cast(time, 'int64') + np.int64(1)
        last = tensor_layers.fill_constant([1], 'int64', self.T - 1)
        clipped = nn_layers.elementwise_min(
            nn_layers.reshape(next_time, shape=[1]), last)
        nxt = _gather_time(self.inputs_tm, clipped)
        if self.sequence_length is not None:
            fin = tensor_layers.cast(
                apply_op_layer(
                    'greater_equal',
                    {'x': nn_layers.reshape(next_time, shape=[1]),
                     'y': tensor_layers.cast(self.sequence_length,
                                             'int64')}), 'float32')
        else:
            fin = tensor_layers.cast(
                apply_op_layer('greater_equal',
                               {'x': nn_layers.reshape(next_time, shape=[1]),
                                'y': tensor_layers.fill_constant(
                                    [1], 'int64', self.T)}), 'float32')
            ones = tensor_layers.fill_constant_batch_size_like(
                self.inputs_tm, [-1], 'float32', 1.0, input_dim_idx=1,
                output_dim_idx=0)
            fin = ones * fin        # (B,) * (1,): one flag a row
        return fin, nxt


class GreedyEmbeddingHelper(DecodeHelper):
    """Greedy generation: the argmax id, through ``embedding_fn``, is the
    next input; a row finishes at ``end_token``."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self.embedding_fn = embedding_fn
        self.start_tokens = start_tokens
        self.end_token = int(end_token)

    def initialize(self):
        fin = tensor_layers.fill_constant_batch_size_like(
            self.start_tokens, [-1], 'float32', 0.0)
        return self.embedding_fn(self.start_tokens), fin

    def sample(self, time, outputs, states):
        return nn_layers.reshape(
            tensor_layers.cast(nn_layers.argmax(outputs, axis=-1), 'int64'),
            shape=[-1])

    def next_inputs(self, time, outputs, states, sample_ids):
        fin = tensor_layers.cast(
            apply_op_layer('equal',
                           {'x': sample_ids,
                            'y': tensor_layers.fill_constant(
                                [1], 'int64', self.end_token)}), 'float32')
        return fin, self.embedding_fn(sample_ids)


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """``GreedyEmbeddingHelper`` that draws each id from
    ``softmax(outputs / softmax_temperature)`` (the ``sampling_id`` op,
    from the port's generator, or from ``seed`` where given)."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature=None, seed=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self.temperature = softmax_temperature
        self.seed = seed

    def sample(self, time, outputs, states):
        logits = outputs if self.temperature is None \
            else outputs / float(self.temperature)
        probs = nn_layers.softmax(logits)
        ids = apply_op_layer('sampling_id', {'x': probs},
                             {'seed': self.seed or 0})
        return nn_layers.reshape(tensor_layers.cast(ids, 'int64'),
                                 shape=[-1])


BasicDecoderOutput = collections.namedtuple('BasicDecoderOutput',
                                            ('cell_outputs', 'sample_ids'))


class BasicDecoder(Decoder):
    """``cell`` and ``helper`` as one decoder step: the cell's outputs
    (through ``output_fn``), the helper's sampled ids and next inputs;
    rows finish where the helper says."""

    def __init__(self, cell, helper, output_fn=None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        initial_inputs, initial_finished = self.helper.initialize()
        return initial_inputs, [initial_cell_states, initial_finished]

    def step(self, time, inputs, states, **kwargs):
        cell_states, finished = states
        cell_outputs, next_cell_states = self.cell.call(inputs, cell_states,
                                                        **kwargs)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        sample_ids = self.helper.sample(time, cell_outputs, cell_states)
        helper_fin, next_inputs = self.helper.next_inputs(
            time, cell_outputs, next_cell_states, sample_ids)
        next_finished = nn_layers.elementwise_max(finished, helper_fin)
        outputs = BasicDecoderOutput(cell_outputs, sample_ids)
        return outputs, [next_cell_states, next_finished], next_inputs, \
            next_finished
