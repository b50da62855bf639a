"""PaddleNLP's PTB LSTM language model as a user's static script writes it
(PaddlePaddle/models, ``PaddleNLP/language_model``: ``lm_model.py`` for
the net, ``train.py`` and ``args.py``/``lm_config.py`` for the loss,
the schedule and the ``large`` configuration).

:func:`build` takes the ``fluid`` module it builds with and imports
neither package, so the same code builds in ``paddle_tpu_torch`` and in
the JAX package ``paddle_tpu``::

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import static_ptb_lm
    main, startup, test, v = static_ptb_lm.build(fluid)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    h = c = np.zeros((2, 20, 1500), 'float32')
    for x, y in batches:            # x (20, 35, 1), y (700, 1) int64
        loss, h, c = exe.run(step, feed={'x': x, 'y': y, 'init_hidden': h,
                                         'init_cell': c},
                             fetch_list=[v['loss'], v['last_hidden'],
                                         v['last_cell']])

Training is truncated back-propagation through time: each step feeds the
last step's fetched ``last_hidden`` and ``last_cell`` back, as
``train.py`` does.

The net (``LARGE``: vocabulary 10,000, hidden 1,500, 2 layers, 35 steps,
batch 20, 66,022,000 parameters): the ids through ``embedding``
(``embedding_para``), reshaped to (-1, 35, 1500) and through
``dropout(upscale_in_train)``; then one of two routes:

- ``rnn_model='padding'`` (``lm_model.py``'s ``padding_rnn``): the
  embedding time-major into a ``StaticRNN`` whose step, for each layer
  ``k``, concatenates the input with the layer's hidden memory, takes
  ``matmul(., fc_weight1_k) + fc_bias1_k``, slices the gates ``i, j, f,
  o``, computes ``c = pre_c * σ(f) + σ(i) * tanh(j)`` and ``m = tanh(c) *
  σ(o)``, updates both memories, outputs ``m`` and ``c`` and passes
  ``dropout(m)`` on as the next layer's input (the last one is the
  step's output). The last step's ``m`` and ``c`` of each layer, sliced
  out and concatenated, are ``last_hidden`` and ``last_cell`` (2, 20,
  1500);
- ``rnn_model='static'`` (``lm_model.py``'s cuDNN route):
  ``fluid.layers.lstm`` over the time-major embedding with
  ``default_initializer`` the recipe's uniform, whose parameters are the
  cells' own (``lstm_l0_0.w_0``, ...); both packages take a list of one
  (20, 1500) initial state a layer there.

The head is ``matmul(., softmax_weight) + softmax_bias`` reshaped to
(-1, 10000), ``softmax_with_cross_entropy`` against ``y``, reshaped to
(-1, 35), ``reduce_mean`` over the batch and ``reduce_sum`` over the
steps. Every parameter is ``UniformInitializer(-0.04, 0.04)`` but the
LSTM biases, which start at zero. The optimizer is
``SGD(piecewise_decay(...))`` with ``GradientClipByGlobalNorm(10.0)`` set
through
``fluid.clip.set_gradient_clip``: the rate is 1.0 for the first 14 epochs
of 1,327 steps (PTB's 929,589 training tokens at batch 20 and 35 steps)
and falls by 1/1.15 an epoch after, over 55 epochs. The recipe's
``persistable = True`` on the loss, the fed states and the last states is
left out: it tells the reference's executor to keep them alive, and both
packages here would read a persistable from the scope before the run.
The keyword arguments of ``build`` exist only to cut sizes for tests.
"""
from __future__ import annotations

__all__ = ['LARGE', 'EPOCH_SIZE', 'BOUNDARIES', 'VALUES', 'build']

LARGE = dict(vocab_size=10000, hidden_size=1500, num_layers=2, num_steps=35,
             batch_size=20, init_scale=0.04, dropout=0.65)
MAX_GRAD_NORM = 10.0
TRAIN_TOKENS = 929589                  # PTB's ptb.train.txt, with <eos>
EPOCH_SIZE = ((TRAIN_TOKENS // LARGE['batch_size']) - 1) \
    // LARGE['num_steps']
MAX_EPOCH, EPOCH_START_DECAY, LR_DECAY = 55, 14, 1 / 1.15
BOUNDARIES = [EPOCH_SIZE * i for i in range(1, MAX_EPOCH)]
VALUES = [1.0] + [LR_DECAY ** max(i + 1 - EPOCH_START_DECAY, 0)
                  for i in range(1, MAX_EPOCH)]


def _padding_rnn(fluid, emb, init_hidden, init_cell, c):
    layers = fluid.layers
    hidden, n_layers, steps = c['hidden_size'], c['num_layers'], \
        c['num_steps']
    uniform = fluid.initializer.UniformInitializer(
        low=-c['init_scale'], high=c['init_scale'])
    weights, biases, hiddens, cells = [], [], [], []
    for i in range(n_layers):
        weights.append(layers.create_parameter(
            [hidden * 2, hidden * 4], dtype='float32',
            name='fc_weight1_' + str(i), default_initializer=uniform))
        biases.append(layers.create_parameter(
            [hidden * 4], dtype='float32', name='fc_bias1_' + str(i),
            default_initializer=fluid.initializer.Constant(0.0)))
        for state, out in ((init_hidden, hiddens), (init_cell, cells)):
            pre = layers.slice(state, axes=[0], starts=[i], ends=[i + 1])
            out.append(layers.reshape(pre, shape=[-1, hidden]))
    emb = layers.transpose(emb, perm=[1, 0, 2])
    rnn = layers.StaticRNN()
    with rnn.step():
        x = rnn.step_input(emb)
        for k in range(n_layers):
            pre_hidden = rnn.memory(init=hiddens[k])
            pre_cell = rnn.memory(init=cells[k])
            gate_input = layers.matmul(
                x=layers.concat([x, pre_hidden], 1), y=weights[k])
            gate_input = layers.elementwise_add(gate_input, biases[k])
            i, j, f, o = [layers.slice(gate_input, axes=[1],
                                       starts=[hidden * g],
                                       ends=[hidden * (g + 1)])
                          for g in range(4)]
            cell = pre_cell * layers.sigmoid(f) \
                + layers.sigmoid(i) * layers.tanh(j)
            m = layers.tanh(cell) * layers.sigmoid(o)
            rnn.update_memory(pre_hidden, m)
            rnn.update_memory(pre_cell, cell)
            rnn.step_output(m)
            rnn.step_output(cell)
            x = m
            if c['dropout']:
                x = layers.dropout(
                    x, dropout_prob=c['dropout'],
                    dropout_implementation='upscale_in_train')
        rnn.step_output(x)
    out = rnn()
    last_hidden, last_cell = [], []
    for i in range(n_layers):
        for seq, dst in ((out[i * 2], last_hidden),
                         (out[i * 2 + 1], last_cell)):
            seq.stop_gradient = True
            dst.append(layers.slice(seq, axes=[0], starts=[steps - 1],
                                    ends=[steps]))
    real_res = layers.transpose(x=out[-1], perm=[1, 0, 2])
    return (real_res, layers.concat(last_hidden, 0),
            layers.concat(last_cell, 0))


def _lstm(fluid, emb, init_hidden, init_cell, c):
    layers = fluid.layers
    hidden = c['hidden_size']

    def per_layer(state):
        return [layers.reshape(layers.slice(state, axes=[0], starts=[i],
                                            ends=[i + 1]),
                               shape=[-1, hidden])
                for i in range(c['num_layers'])]

    emb = layers.transpose(emb, perm=[1, 0, 2])
    out, last_hidden, last_cell = layers.lstm(
        emb, per_layer(init_hidden), per_layer(init_cell), c['num_steps'],
        hidden, c['num_layers'], is_bidirec=False,
        default_initializer=fluid.initializer.UniformInitializer(
            low=-c['init_scale'], high=c['init_scale']))
    return layers.transpose(out, perm=[1, 0, 2]), last_hidden, last_cell


def build(fluid, rnn_model='padding', **cut):
    """The recipe's programs, built with ``fluid`` (either package), at
    ``LARGE`` with the sizes in ``cut`` replaced.

    Returns ``(train program, startup program, test program, vars)``:
    the test program is the train program's ``clone(for_test=True)``
    taken before the optimizer (dropout off, no backward); ``vars`` holds
    the feeds ``x``, ``y``, ``init_hidden``, ``init_cell``, and ``loss``,
    ``last_hidden``, ``last_cell`` and ``lr`` (the schedule's rate)."""
    if rnn_model not in ('padding', 'static'):
        raise ValueError(f'rnn_model {rnn_model!r}: padding or static')
    unknown = set(cut) - set(LARGE)
    if unknown:
        raise TypeError(f'unknown sizes {sorted(unknown)}')
    c = {**LARGE, **cut}
    layers = fluid.layers
    hidden, vocab, steps = c['hidden_size'], c['vocab_size'], c['num_steps']
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data(name='x', shape=[c['batch_size'], steps, 1],
                        dtype='int64', append_batch_size=False)
        y = layers.data(name='y', shape=[c['batch_size'] * steps, 1],
                        dtype='int64', append_batch_size=False)
        state_shape = [c['num_layers'], c['batch_size'], hidden]
        init_hidden = layers.data(name='init_hidden', shape=state_shape,
                                  dtype='float32', append_batch_size=False)
        init_cell = layers.data(name='init_cell', shape=state_shape,
                                dtype='float32', append_batch_size=False)
        init_hidden_r = layers.reshape(init_hidden,
                                       shape=[c['num_layers'], -1, hidden])
        init_cell_r = layers.reshape(init_cell,
                                     shape=[c['num_layers'], -1, hidden])
        emb = layers.embedding(
            input=x, size=[vocab, hidden], dtype='float32', is_sparse=False,
            param_attr=fluid.ParamAttr(
                name='embedding_para',
                initializer=fluid.initializer.UniformInitializer(
                    low=-c['init_scale'], high=c['init_scale'])))
        emb = layers.reshape(emb, shape=[-1, steps, hidden])
        if c['dropout']:
            emb = layers.dropout(emb, dropout_prob=c['dropout'],
                                 dropout_implementation='upscale_in_train')
        rnn = _padding_rnn if rnn_model == 'padding' else _lstm
        rnn_out, last_hidden, last_cell = rnn(fluid, emb, init_hidden_r,
                                              init_cell_r, c)
        rnn_out = layers.reshape(rnn_out, shape=[-1, steps, hidden])
        uniform = fluid.initializer.UniformInitializer(
            low=-c['init_scale'], high=c['init_scale'])
        softmax_weight = layers.create_parameter(
            [hidden, vocab], dtype='float32', name='softmax_weight',
            default_initializer=uniform)
        softmax_bias = layers.create_parameter(
            [vocab], dtype='float32', name='softmax_bias',
            default_initializer=uniform)
        projection = layers.matmul(rnn_out, softmax_weight)
        projection = layers.elementwise_add(projection, softmax_bias)
        projection = layers.reshape(projection, shape=[-1, vocab])
        loss = layers.softmax_with_cross_entropy(
            logits=projection, label=y, soft_label=False)
        loss = layers.reshape(loss, shape=[-1, steps])
        loss = layers.reduce_mean(loss, dim=[0])
        loss = layers.reduce_sum(loss)
        test = main.clone(for_test=True)
        fluid.clip.set_gradient_clip(
            clip=fluid.clip.GradientClipByGlobalNorm(
                clip_norm=MAX_GRAD_NORM))
        lr = layers.piecewise_decay(boundaries=BOUNDARIES, values=VALUES)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, test, {
        'x': x, 'y': y, 'init_hidden': init_hidden, 'init_cell': init_cell,
        'loss': loss, 'last_hidden': last_hidden, 'last_cell': last_cell,
        'lr': lr}
