"""PaddleNLP's attention seq2seq as a user's static script writes it
(PaddlePaddle/models release/1.7, ``PaddleNLP/seq2seq/seq2seq``:
``attention_model.py`` and ``base_model.py`` for the net, ``args.py`` and
``run.sh`` for the IWSLT'15 en-vi configuration, ``train.py`` for the
optimizer, ``infer.py`` and ``infer.sh`` for the beam search).

:func:`build` takes the ``fluid`` module it builds with and imports
neither package, so the same code builds in ``paddle_tpu_torch`` and in
the JAX package ``paddle_tpu``::

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import static_seq2seq
    main, startup, v = static_seq2seq.build(fluid)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    loss, = exe.run(main, feed={'src': src, 'src_sequence_length': src_len,
                                'tar': tar, 'tar_sequence_length': tar_len,
                                'label': label}, fetch_list=[v['loss']])
    infer, _, w = static_seq2seq.build(fluid, mode='beam_search')
    ids, = exe.run(infer, feed={'src': src, 'src_sequence_length':
                                src_len}, fetch_list=[w['ids']])

The configuration (``RECIPE``; ``run.sh``, ``infer.sh``): source
vocabulary 17,191, target vocabulary 7,709, hidden 512, 2 LSTM layers in
the encoder and in the decoder, dropout 0.2 after every LSTM layer
(``upscale_in_train``), every weight ``UniformInitializer(-0.1, 0.1)`` and
the LSTM biases zero, batch 128, ``Adam(0.001)`` with
``GradientClipByGlobalNorm(5.0)``, beam 10 from ``<s>`` = 1 to ``</s>`` =
2 over at most 100 steps (``base_model.py``'s ``beam_max_step_num``).
26,927,616 parameters. The reader pads each batch with ``</s>`` to its
longest sentence; ``tar`` is the target but its last token, ``label`` the
target but its first, and ``tar_sequence_length`` one less than the
target's length.

The net: both vocabularies through ``embedding`` (``source_embedding``,
``target_embedding``); the encoder is ``layers.rnn`` over an
``EncoderCell`` (stacked ``LSTMCell``s) with the source lengths; the
decoder is ``layers.rnn`` over the ``AttentionDecoderCell`` with the
encoder's output and padding mask as keyword arguments (teacher
forcing), then the ``output_w`` projection; the loss is
``softmax_with_cross_entropy`` masked by ``sequence_mask`` of the target
lengths, averaged over the batch and summed over time. The decoder cell
feeds its last output back (``input_feed``): each step concatenates the
embedded token with it, runs the LSTM layers, attends over the encoder's
output (``fc`` of it as keys and values, a dot product with the top
layer's output, the padding masked by -1e9, a softmax) and projects the
attended vector with the top output to the new output.

Where the program differs from the script, and why:

- The padded lengths are build-time sizes (``src_len``, ``tar_len``): the
  script reads them with ``layers.shape``, which neither package runs, and
  both packages' ``sequence_mask`` and ``StaticRNN`` need them static.
  So is the batch in the beam-search program (``BeamSearchDecoder`` tiles
  by it).
- The cross entropy of (B, T, 1) is squeezed to (B, T) before the mask.
- Under ``amp`` the decoder cell casts its new output to f32 before it
  feeds it back: the ``mul`` of its ``fc`` is on the cast white list, so
  the scan's carry would turn bf16 after the first step, and both
  packages refuse a carry that changes type (ROADMAP C.4 item 8).
- ``unsqueeze``, ``squeeze``, ``transpose`` and ``elementwise_add`` take
  their attributes as keywords: the JAX package's generated layers drop
  positional attributes (ROADMAP C.12; the port's place them).
- The beam search: the script passes the beam-tiled encoder output to
  ``dynamic_decode`` as keyword arguments for the cell, and tiles with
  ``tile_beam_merge_with_batch``. The JAX package's
  ``BeamSearchDecoder.step`` takes no keyword arguments and has no such
  method, so the program tiles with the decoder's ``_expand_to_beam`` and
  sets the tiled tensors on the cell, which reads them when it is given
  none (ROADMAP C.11).
"""
from __future__ import annotations

__all__ = ['RECIPE', 'LEARNING_RATE', 'MAX_GRAD_NORM', 'START', 'END',
           'build', 'AttentionDecoderCell']

RECIPE = dict(src_vocab_size=17191, tar_vocab_size=7709, hidden_size=512,
              num_layers=2, dropout=0.2, init_scale=0.1, batch_size=128,
              src_len=50, tar_len=49, beam_size=10, max_decode_steps=100)
LEARNING_RATE = 0.001
MAX_GRAD_NORM = 5.0
START, END = 1, 2


def _uniform(fluid, scale):
    return fluid.initializer.UniformInitializer(low=-scale, high=scale)


class _StackedCell:
    """``base_model.py``'s EncoderCell: LSTMCells stacked, each output
    through dropout (training only) into the next."""

    def __init__(self, fluid, num_layers, hidden_size, dropout_prob,
                 init_scale):
        self.layers = fluid.layers
        self.hidden_size = hidden_size
        self.dropout_prob = dropout_prob
        param_attr = fluid.ParamAttr(initializer=_uniform(fluid,
                                                          init_scale))
        bias_attr = fluid.ParamAttr(
            initializer=fluid.initializer.Constant(0.0))
        self.lstm_cells = [fluid.layers.LSTMCell(hidden_size, param_attr,
                                                 bias_attr)
                           for _ in range(num_layers)]

    def _stack(self, step_input, states):
        new_states = []
        for cell, state in zip(self.lstm_cells, states):
            out, new_state = cell.call(step_input, state)
            step_input = (self.layers.dropout(
                out, self.dropout_prob,
                dropout_implementation='upscale_in_train')
                if self.dropout_prob > 0 else out)
            new_states.append(new_state)
        return step_input, new_states

    def call(self, step_input, states):
        return self._stack(step_input, states)

    @property
    def state_shape(self):
        return [cell.state_shape for cell in self.lstm_cells]

    def get_initial_states(self, batch_ref, shape=None, dtype='float32',
                           init_value=0.0, batch_dim_idx=0):
        return self.lstm_cells[0].get_initial_states(
            batch_ref, shape if shape is not None else self.state_shape,
            dtype, init_value, batch_dim_idx)


class AttentionDecoderCell(_StackedCell):
    """``attention_model.py``'s AttentionDecoderCell: states ``[LSTM
    states, input_feed]``; reads ``enc_output`` and ``enc_padding_mask``
    from its keyword arguments or, where none are given (the beam
    search), from its attributes of the same names."""

    def __init__(self, fluid, num_layers, hidden_size, dropout_prob,
                 init_scale):
        super().__init__(fluid, num_layers, hidden_size, dropout_prob,
                         init_scale)
        self.fluid = fluid
        self.init_scale = init_scale
        self.enc_output = None
        self.enc_padding_mask = None
        self.feed_f32 = False     # cast the fed-back output to f32 (AMP)

    def _fc(self, which, x, num_flatten_dims):
        """``layers.fc`` of ``x`` to ``hidden_size``, no bias: ``which``
        is ``'memory'`` (the encoder output's keys) or ``'output'`` (the
        new output). A cell for a dygraph guard, where ``layers.fc`` makes
        static parameters in both packages, overrides it."""
        return self.layers.fc(
            x, self.hidden_size, num_flatten_dims=num_flatten_dims,
            param_attr=self.fluid.ParamAttr(
                initializer=_uniform(self.fluid, self.init_scale)),
            bias_attr=False)

    def attention(self, query, enc_output, mask=None):
        layers = self.layers
        query = layers.unsqueeze(query, axes=[1])
        memory = self._fc('memory', enc_output, 2)
        attn = layers.matmul(query, memory, transpose_y=True)
        if mask is not None:
            attn = layers.transpose(attn, perm=[1, 0, 2])
            attn = layers.elementwise_add(attn, mask * 1000000000, axis=-1)
            attn = layers.transpose(attn, perm=[1, 0, 2])
        weight = layers.softmax(attn)
        return layers.matmul(weight, memory)

    def call(self, step_input, states, enc_output=None,
             enc_padding_mask=None):
        layers = self.layers
        if enc_output is None:
            enc_output = self.enc_output
            enc_padding_mask = self.enc_padding_mask
        lstm_states, input_feed = states
        step_input = layers.concat([step_input, input_feed], 1)
        out, new_lstm_states = self._stack(step_input, lstm_states)
        dec_att = layers.squeeze(self.attention(out, enc_output,
                                                enc_padding_mask),
                                 axes=[1])
        new_h = self._fc('output', layers.concat([dec_att, out], 1), 1)
        if self.feed_f32:
            new_h = layers.cast(new_h, 'float32')
        return new_h, [new_lstm_states, new_h]


def build(fluid, mode='train', amp=None, **cut):
    """The recipe's program in ``mode`` (``'train'`` or
    ``'beam_search'``), built with ``fluid`` (either package), at
    ``RECIPE`` with the sizes in ``cut`` replaced. Programs of both modes
    built with fresh names have the same parameter names.

    Returns ``(program, startup program, vars)``. Training: the feeds
    ``src``, ``src_sequence_length``, ``tar``, ``tar_sequence_length``,
    ``label`` and ``loss``, the program minimised by Adam with the clip,
    wrapped in ``fluid.contrib.mixed_precision.decorate(dtype=amp)``
    where ``amp`` is given.
    Beam search: the feeds ``src`` and ``src_sequence_length``, and
    ``ids`` (B, steps, beam), each final beam's tokens, and ``scores``
    (B, steps, beam), the beams' scores at each step."""
    if mode not in ('train', 'beam_search'):
        raise ValueError(f'mode {mode!r}: train or beam_search')
    unknown = set(cut) - set(RECIPE)
    if unknown:
        raise TypeError(f'unknown sizes {sorted(unknown)}')
    c = {**RECIPE, **cut}
    layers = fluid.layers
    hidden, B = c['hidden_size'], c['batch_size']
    train = mode == 'train'
    dropout = c['dropout'] if train else 0.0
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = layers.data(name='src', shape=[B, c['src_len']], dtype='int64',
                          append_batch_size=False)
        src_len = layers.data(name='src_sequence_length', shape=[B],
                              dtype='int32', append_batch_size=False)
        src_emb = layers.embedding(
            input=src, size=[c['src_vocab_size'], hidden], dtype='float32',
            is_sparse=False, param_attr=fluid.ParamAttr(
                name='source_embedding',
                initializer=_uniform(fluid, c['init_scale'])))

        def tar_embeder(x):
            return layers.embedding(
                input=x, size=[c['tar_vocab_size'], hidden],
                dtype='float32', is_sparse=False,
                param_attr=fluid.ParamAttr(
                    name='target_embedding',
                    initializer=_uniform(fluid, c['init_scale'])))

        enc_cell = _StackedCell(fluid, c['num_layers'], hidden, dropout,
                                c['init_scale'])
        enc_output, enc_final_state = layers.rnn(
            cell=enc_cell, inputs=src_emb, sequence_length=src_len)
        dec_cell = AttentionDecoderCell(fluid, c['num_layers'], hidden,
                                        dropout, c['init_scale'])
        dec_cell.feed_f32 = amp is not None
        dec_initial_states = [
            enc_final_state,
            dec_cell.get_initial_states(batch_ref=enc_output,
                                        shape=[hidden])]
        src_mask = layers.sequence_mask(src_len, maxlen=c['src_len'],
                                        dtype='float32')
        enc_padding_mask = src_mask - 1.0

        def output_layer(x):
            return layers.fc(x, size=c['tar_vocab_size'],
                             num_flatten_dims=len(x.shape) - 1,
                             param_attr=fluid.ParamAttr(
                                 name='output_w',
                                 initializer=_uniform(fluid,
                                                      c['init_scale'])),
                             bias_attr=False)

        if not train:
            decoder = layers.BeamSearchDecoder(
                dec_cell, START, END, c['beam_size'],
                embedding_fn=tar_embeder, output_fn=output_layer)
            dec_cell.enc_output = decoder._expand_to_beam(enc_output)
            dec_cell.enc_padding_mask = decoder._expand_to_beam(
                enc_padding_mask)
            ids, scores = layers.dynamic_decode(
                decoder, inits=dec_initial_states,
                max_step_num=c['max_decode_steps'])
            return main, startup, {'src': src, 'src_sequence_length':
                                   src_len, 'ids': ids, 'scores': scores}

        tar = layers.data(name='tar', shape=[B, c['tar_len']],
                          dtype='int64', append_batch_size=False)
        tar_len = layers.data(name='tar_sequence_length', shape=[B],
                              dtype='int32', append_batch_size=False)
        label = layers.data(name='label', shape=[B, c['tar_len'], 1],
                            dtype='int64', append_batch_size=False)
        dec_output, _ = layers.rnn(
            cell=dec_cell, inputs=tar_embeder(tar),
            initial_states=dec_initial_states, sequence_length=None,
            enc_output=enc_output, enc_padding_mask=enc_padding_mask)
        dec_output = output_layer(dec_output)
        loss = layers.softmax_with_cross_entropy(
            logits=dec_output, label=label, soft_label=False)
        loss = layers.squeeze(loss, axes=[2])
        tar_mask = layers.sequence_mask(tar_len, maxlen=c['tar_len'],
                                        dtype='float32')
        loss = loss * tar_mask
        loss = layers.reduce_mean(loss, dim=[0])
        loss = layers.reduce_sum(loss)
        opt = fluid.optimizer.Adam(
            learning_rate=LEARNING_RATE,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(
                clip_norm=MAX_GRAD_NORM))
        if amp is not None:
            opt = fluid.contrib.mixed_precision.decorate(opt, dtype=amp)
        opt.minimize(loss)
    return main, startup, {'src': src, 'src_sequence_length': src_len,
                           'tar': tar, 'tar_sequence_length': tar_len,
                           'label': label, 'loss': loss}
