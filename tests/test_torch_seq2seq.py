"""The static seq2seq decoding slice of the port: the beam-search and
decode ops (paddle_tpu_torch/ops/{rnn_ops, random_ops, sequence_ops}.py,
``arg_max`` and ``transpose_batch_time`` of tensor_ops.py) and the decoders
of layers/rnn.py, against the JAX package's on the CPU, from the same
``numpy.random.RandomState`` inputs.

- The ops against the JAX ops: ``gather_tree`` and ``transpose_batch_time``
  equal; ``arg_max`` equal, ties to the first index in both;
  ``sequence_mask`` equal, and without ``maxlen`` as wide as the largest
  length (the reference's rule, against numpy: the JAX op needs it);
  ``beam_search_step`` on plain candidates, with finished beams, with
  probabilities (``is_accumulated=False``) and with tied scores: scores
  within 1e-6 and the selections equal, where scores tie as the same set
  of (id, parent) pairs (``torch.topk`` and ``lax.top_k`` may order a tie
  differently). Integer results are compared by value (the JAX package
  computes them in int32).
- The decoders in a static program in both packages, from the JAX
  startup values: ``BasicDecoder`` with ``TrainingHelper`` (with
  lengths) and with ``GreedyEmbeddingHelper``, and ``BeamSearchDecoder``
  over an ``LSTMCell`` and over the recipe's attention cell
  (tools/static_seq2seq.py); the same ops in both, float outputs within
  atol 1e-5, ids equal (the scores sit far from ties at this size,
  ``init_scale`` 1: measured).
- The same decoders under the port's ``dygraph.guard`` against the JAX
  package's static run (its decoders do not run under a guard, ROADMAP
  C.11): the dygraph loop stops once every beam has finished, so its
  outputs are the static run's first T steps, and the static run's later
  steps hold only ``end_token``; same tolerances.
- ``SampleEmbeddingHelper`` by its properties (the port's generator and
  JAX's PRNG draw different streams): ids within the vocabulary; over
  20,000 draws each id's frequency within 5 standard deviations of its
  softmax probability; at temperature 1e-6 the ids equal
  ``GreedyEmbeddingHelper``'s; one seed draws the same ids twice.
- The legacy ``beam_search`` returns the selected ids and scores, and
  the parent index with ``return_parent_idx``, as the reference
  documents; ``beam_search_decode`` walks ids and scores back along the
  parents, against a numpy backtrace, in both modes (the JAX package
  backtraces ids along the scores, ROADMAP C.11).
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.ops import rnn_ops as jrnn_ops
from paddle_tpu.ops import sequence_ops as jseq_ops
from paddle_tpu.ops import tensor_ops as jtensor_ops
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.ops import random_ops, rnn_ops, sequence_ops, tensor_ops
from paddle_tpu_torch.tools import static_seq2seq
from torch_jax_seed import jax_seed_pinned  # noqa: F401

ATOL = 1e-5
B, W, V, D, H, T = 3, 3, 12, 5, 6, 6
START, END = 1, 2


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


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- ops


def test_gather_tree_matches_jax():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V, (T, B, W)).astype(np.int64)
    parents = rng.randint(0, W, (T, B, W)).astype(np.int64)
    got = rnn_ops.gather_tree(t(ids), t(parents)).numpy()
    want = np.asarray(jrnn_ops.gather_tree(ids, parents))
    np.testing.assert_array_equal(got, want)
    # the last step is the beams themselves; each earlier step follows
    # the parent pointers
    np.testing.assert_array_equal(got[-1], ids[-1])
    beam = np.tile(np.arange(W), (B, 1))
    for s in range(T - 1, -1, -1):
        np.testing.assert_array_equal(
            got[s], np.take_along_axis(ids[s], beam, 1))
        beam = np.take_along_axis(parents[s], beam, 1)


def beam_case(name):
    """(pre_ids, pre_scores, ids, scores, attrs) of one beam step over
    (B*W, K) candidates."""
    rng = np.random.RandomState(1)
    K = 4
    pre_ids = rng.randint(3, V, (B * W, 1)).astype(np.int64)
    pre_scores = -rng.rand(B * W, 1).astype(np.float32)
    ids = rng.randint(0, V, (B * W, K)).astype(np.int64)
    scores = pre_scores - rng.rand(B * W, K).astype(np.float32)
    attrs = {'beam_size': W, 'end_id': END}
    if name == 'finished':
        pre_ids[[0, 4, 5]] = END
    elif name == 'probabilities':
        scores = rng.dirichlet(np.ones(K), B * W).astype(np.float32)
        attrs['is_accumulated'] = False
    elif name == 'ties':
        scores = np.round(scores * 2) / 2
        pre_ids[3] = END
    return pre_ids, pre_scores, ids, scores, attrs


def check_selections(got, want, ids, scores, pre_ids, pre_scores):
    """Each batch row's selections: the same scores; above the row's
    lowest selected score the same (score, id, parent) set; at it, each
    selection one of the candidates of that score (a tie there may be cut
    differently by ``torch.topk`` and ``lax.top_k``)."""
    fin = (pre_ids.reshape(-1) == END)[:, None]
    K = scores.shape[1]
    cand_s = np.where(fin, np.concatenate(
        [pre_scores, np.full((B * W, K - 1), -1e9, np.float32)], 1), scores)
    cand_i = np.where(fin, END, ids)
    for row in range(B):
        sel = [sorted(zip(s.reshape(B, W)[row].tolist(),
                          i.reshape(B, W)[row].tolist(),
                          p.reshape(B, W)[row].tolist()))
               for i, s, p in (got, want)]
        assert [x[0] for x in sel[0]] == [x[0] for x in sel[1]]
        low = sel[1][0][0]
        assert ([x for x in sel[0] if x[0] > low]
                == [x for x in sel[1] if x[0] > low])
        beams = range(row * W, row * W + W)
        at_low = {(cand_s[b, k], cand_i[b, k], b) for b in beams
                  for k in range(K) if cand_s[b, k] == low}
        for s in sel:
            assert {x for x in s if x[0] == low} <= at_low


@pytest.mark.parametrize('name', ['plain', 'finished', 'probabilities',
                                  'ties'])
def test_beam_search_step_matches_jax(name):
    pre_ids, pre_scores, ids, scores, attrs = beam_case(name)
    got = [g.numpy() for g in rnn_ops.beam_search_step(
        t(pre_ids), t(pre_scores), t(ids), t(scores), **attrs)]
    want = [np.asarray(w) for w in jrnn_ops.beam_search_step(
        pre_ids, pre_scores, ids, scores, **attrs)]
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_allclose(np.sort(got[1], 0), np.sort(want[1], 0),
                               atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    if name == 'ties':
        check_selections(got, want, ids, scores, pre_ids, pre_scores)
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
    if name == 'finished':
        # a finished beam continues only with end_id at its score
        fin = pre_ids[:, 0] == END
        for row in range(B * W):
            if fin[got[2][row]]:
                assert got[0][row, 0] == END
                assert got[1][row, 0] == pre_scores[got[2][row], 0]


@pytest.mark.parametrize('shape', [(4,), (4, 3), (4, 3, 2)])
def test_transpose_batch_time_matches_jax(shape):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    got = tensor_ops.transpose_batch_time(t(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jtensor_ops.transpose_batch_time(x)))


@pytest.mark.parametrize('axis', [0, 1, -1])
def test_arg_max_matches_jax(axis):
    x = np.round(np.random.RandomState(3).randn(4, 5, 6)).astype(np.float32)
    got = tensor_ops.arg_max(t(x), axis=axis).numpy()
    want = np.asarray(jtensor_ops.arg_max(x, axis=axis))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.argmax(x, axis=axis))


def test_sequence_mask_matches_jax():
    lens = np.array([0, 3, 5, 1], np.int64)
    for dtype in ('int64', 'float32'):
        got = sequence_ops.sequence_mask(t(lens), maxlen=6,
                                         dtype=dtype).numpy()
        want = np.asarray(jseq_ops.sequence_mask(lens, maxlen=6,
                                                 dtype=dtype))
        np.testing.assert_array_equal(got, want)
    # without maxlen: as wide as the largest length (the reference's rule)
    got = sequence_ops.sequence_mask(t(lens)).numpy()
    np.testing.assert_array_equal(
        got, (np.arange(5)[None] < lens[:, None]).astype(np.int64))


# ------------------------------------------------------------ decoders


def names_of(pkg):
    from paddle_tpu.core import unique_name as jnames
    from paddle_tpu_torch.core import unique_name as tnames
    return jnames if pkg is jfluid else tnames


class Parts:
    """The weights a decoder case uses besides its cell, made in a static
    program (``embedding`` and ``fc`` over named parameters) or, under a
    dygraph guard, from the given values."""

    def __init__(self, pkg, values=None):
        self.pkg, self.values = pkg, values
        if values is not None:
            dy = pkg.dygraph
            self.emb = dy.Embedding([V, D])
            self.emb.weight.set_value(values['emb'].copy())
            self.out = dy.Linear(H, V)
            self.out.weight.set_value(values['out_w'].copy())
            self.out.bias.set_value(values['out_b'].copy())

    def embed(self, ids):
        if self.values is not None:
            return self.emb(ids)
        return self.pkg.layers.embedding(
            ids, [V, D], param_attr=self.pkg.ParamAttr(name='emb'))

    def project(self, x):
        if self.values is not None:
            return self.out(x)
        return self.pkg.layers.fc(
            x, V, param_attr=self.pkg.ParamAttr(name='out_w'),
            bias_attr=self.pkg.ParamAttr(name='out_b'))


def lstm(pkg):
    return pkg.layers.LSTMCell(
        H, param_attr=pkg.ParamAttr(
            initializer=pkg.initializer.UniformInitializer(-1.0, 1.0)),
        name='dec')


def training_case(pkg, L, parts, feeds):
    helper = L.TrainingHelper(parts.embed(feeds['tar']),
                              sequence_length=feeds['lens'])
    dec = L.BasicDecoder(lstm(pkg), helper, output_fn=parts.project)
    out, _ = L.dynamic_decode(dec, inits=[feeds['h'], feeds['c']],
                              max_step_num=T)
    return [out.cell_outputs, out.sample_ids]


def greedy_case(pkg, L, parts, feeds):
    helper = L.GreedyEmbeddingHelper(parts.embed, feeds['start'], END)
    dec = L.BasicDecoder(lstm(pkg), helper, output_fn=parts.project)
    out, _ = L.dynamic_decode(dec, inits=[feeds['h'], feeds['c']],
                              max_step_num=T)
    return [out.cell_outputs, out.sample_ids]


def beam_lstm_case(pkg, L, parts, feeds):
    dec = L.BeamSearchDecoder(lstm(pkg), START, END, W,
                              embedding_fn=parts.embed,
                              output_fn=parts.project)
    ids, scores = L.dynamic_decode(dec, inits=[feeds['h'], feeds['c']],
                                   max_step_num=T)
    return [ids, scores]


class DygraphAttentionCell(static_seq2seq.AttentionDecoderCell):
    """The recipe's attention cell with its two projections as dygraph
    ``Linear`` layers holding the static program's ``fc_0.w_0`` (keys)
    and ``fc_1.w_0`` (output)."""

    def __init__(self, pkg, values):
        super().__init__(pkg, 2, H, 0.0, 1.0)
        self.proj = {}
        for which, name in (('memory', 'fc_0.w_0'), ('output', 'fc_1.w_0')):
            lin = pkg.dygraph.Linear(*values[name].shape, bias_attr=False)
            lin.weight.set_value(values[name].copy())
            self.proj[which] = lin

    def _fc(self, which, x, num_flatten_dims):
        return self.proj[which](x)


def beam_attention_case(pkg, L, parts, feeds):
    cell = (static_seq2seq.AttentionDecoderCell(pkg, 2, H, 0.0, 1.0)
            if parts.values is None else DygraphAttentionCell(pkg,
                                                              parts.values))
    dec = L.BeamSearchDecoder(cell, START, END, W, embedding_fn=parts.embed,
                              output_fn=parts.project)
    cell.enc_output = dec._expand_to_beam(feeds['enc'])
    cell.enc_padding_mask = dec._expand_to_beam(feeds['mask'])
    zeros = L.fill_constant_batch_size_like(feeds['h'], [-1, H], 'float32',
                                            0.0)
    init = [[[feeds['h'], feeds['c']], [feeds['c'], feeds['h']]], zeros]
    ids, scores = L.dynamic_decode(dec, inits=init, max_step_num=T)
    return [ids, scores]


CASES = {'training': training_case, 'greedy': greedy_case,
         'beam_lstm': beam_lstm_case, 'beam_attention': beam_attention_case}

RNG = np.random.RandomState(4)
FEED = {'tar': RNG.randint(3, V, (B, T)).astype(np.int64),
        'lens': np.array([T, 2, 4], np.int64),
        'start': np.full((B,), START, np.int64),
        'h': RNG.randn(B, H).astype(np.float32),
        'c': RNG.randn(B, H).astype(np.float32),
        'enc': RNG.randn(B, 4, H).astype(np.float32),
        'mask': np.array([[0, 0, 0, 0], [0, 0, -1, -1], [0, -1, -1, -1]],
                         np.float32)}


def static_build(pkg, case):
    L = pkg.layers
    main, start = pkg.Program(), pkg.Program()
    with names_of(pkg).guard(), pkg.program_guard(main, start):
        feeds = {n: L.data(n, list(a.shape), str(a.dtype),
                           append_batch_size=False)
                 for n, a in FEED.items()}
        outs = CASES[case](pkg, L, Parts(pkg), feeds)
    return main, start, outs


def jax_static(case):
    main, start, outs = static_build(jfluid, case)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(start, scope=scope)
    init = {p.name: np.asarray(scope.find(p.name))
            for p in main.all_parameters()}
    got = exe.run(main, feed=FEED, fetch_list=outs, scope=scope)
    return main, init, [np.asarray(g) for g in got]


def compare(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize('case', sorted(CASES))
def test_static_decoder_matches_jax(case):
    jmain, init, want = jax_static(case)
    main, start, outs = static_build(fluid, case)
    ops = [(b.idx, op.type) for b in main.blocks for op in b.ops]
    assert ops == [(b.idx, op.type) for b in jmain.blocks for op in b.ops]
    assert '__scan__' in {op for _, op in ops}
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle(init, scope, fluid.CPUPlace(), program=main)
    compare(exe.run(main, feed=FEED, fetch_list=outs, scope=scope), want)
    assert exe.lowering_count(main) == 1


def dygraph_run(case, init):
    """``case`` under the port's guard(CPUPlace()): each cell weight set to
    ``init`` by name as the cell makes it."""
    rnn_mod = importlib.import_module('paddle_tpu_torch.layers.rnn')
    orig = rnn_mod._parameter
    made = []

    def set_as_made(*a, **k):
        p = orig(*a, **k)
        p.set_value(init[p.name].copy())
        made.append(p.name)
        return p

    rnn_mod._parameter = set_as_made
    try:
        with fluid.unique_name.guard(), \
                fluid.dygraph.guard(fluid.CPUPlace()):
            feeds = {n: fluid.dygraph.to_variable(a) for n, a in FEED.items()}
            outs = CASES[case](fluid, fluid.layers, Parts(fluid, init), feeds)
            return [o.numpy() for o in outs], made
    finally:
        rnn_mod._parameter = orig


@pytest.mark.parametrize('case', sorted(CASES))
def test_dygraph_decoder_matches_jax_static(case):
    _, init, want = jax_static(case)
    got, made = dygraph_run(case, init)
    assert made and set(made) <= set(init)
    if case.startswith('beam'):
        steps = got[0].shape[1]
        assert 1 <= steps <= T
        assert (want[0][:, steps:] == END).all()
        want = [w[:, :steps] for w in want]
    compare(got, want)


def sample_program(temperature, seed=None, n=1):
    L = fluid.layers
    main, start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, start):
        start_ids = L.data('start', [n], 'int64', append_batch_size=False)
        logits = L.data('logits', [n, V], 'float32', append_batch_size=False)
        kw = {'softmax_temperature': temperature, 'seed': seed}
        helpers = [L.GreedyEmbeddingHelper(lambda x: x, start_ids, END),
                   L.SampleEmbeddingHelper(lambda x: x, start_ids, END,
                                           **kw)]
        ids = [h.sample(None, logits, None) for h in helpers]
    return main, ids


def test_sample_embedding_helper_draws_from_the_softmax():
    n = 20000
    logits = np.random.RandomState(5).randn(1, V).astype(np.float32) * 2
    feed = {'start': np.full((n,), START, np.int64),
            'logits': np.repeat(logits, n, 0)}
    exe = fluid.Executor(fluid.CPUPlace())
    main, (greedy, sample) = sample_program(None, n=n)
    greedy_ids, ids = exe.run(main, feed=feed, fetch_list=[greedy, sample])
    assert ids.shape == (n,) and ids.dtype == np.int64
    assert ((ids >= 0) & (ids < V)).all()
    p = np.exp(logits[0] - logits[0].max())
    p /= p.sum()
    freq = np.bincount(ids, minlength=V) / n
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12).all()
    assert (greedy_ids == np.argmax(logits[0])).all()
    # temperature -> 0: greedy
    main, (greedy, sample) = sample_program(1e-6, n=n)
    g, s = exe.run(main, feed=feed, fetch_list=[greedy, sample])
    np.testing.assert_array_equal(g, s)
    # a seed draws the same ids
    main, (_, sample) = sample_program(1.0, seed=7, n=64)
    small = {'start': feed['start'][:64], 'logits': feed['logits'][:64]}
    a, = exe.run(main, feed=small, fetch_list=[sample])
    b, = exe.run(main, feed=small, fetch_list=[sample])
    np.testing.assert_array_equal(a, b)
    # under a dygraph guard, from the device's generator
    with fluid.dygraph.guard(fluid.CPUPlace()):
        helper = fluid.layers.SampleEmbeddingHelper(
            lambda x: x, fluid.dygraph.to_variable(feed['start'][:256]), END)
        ids = helper.sample(None, fluid.dygraph.to_variable(
            feed['logits'][:256]), None).numpy()
    assert ids.shape == (256,) and ((ids >= 0) & (ids < V)).all()


def numpy_backtrace(x, parents):
    out = np.empty_like(x)
    beam = np.tile(np.arange(x.shape[2]), (x.shape[1], 1))
    for s in range(x.shape[0] - 1, -1, -1):
        out[s] = np.take_along_axis(x[s], beam, 1)
        beam = np.take_along_axis(parents[s], beam, 1)
    return out


def legacy_steps(L, pre_ids, pre_scores, ids, scores, **kw):
    return L.beam_search(pre_ids, pre_scores, ids, scores, W, END, **kw)


@pytest.mark.parametrize('mode', ['static', 'dygraph'])
def test_legacy_beam_search_and_decode(mode):
    pre_ids, pre_scores, ids, scores, _ = beam_case('finished')
    rng = np.random.RandomState(6)
    sel_ids = rng.randint(0, V, (T, B, W)).astype(np.int64)
    sel_scores = -rng.rand(T, B, W).astype(np.float32)
    parents = rng.randint(0, W, (T, B, W)).astype(np.int64)
    arrays = {'pre_ids': pre_ids, 'pre_scores': pre_scores, 'ids': ids,
              'scores': scores, 'sel_ids': sel_ids, 'sel_scores': sel_scores,
              'parents': parents}
    L = fluid.layers

    def build(v):
        two = legacy_steps(L, v['pre_ids'], v['pre_scores'], v['ids'],
                           v['scores'])
        three = legacy_steps(L, v['pre_ids'], v['pre_scores'], v['ids'],
                             v['scores'], return_parent_idx=True)
        dec = L.beam_search_decode((v['sel_ids'], v['parents']),
                                   v['sel_scores'], W, END)
        own = L.beam_search_decode(v['sel_ids'], v['sel_scores'], W, END)
        return list(two) + list(three) + list(dec) + list(own), len(two)

    if mode == 'static':
        main, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, start):
            v = {n: L.data(n, list(a.shape), str(a.dtype),
                           append_batch_size=False)
                 for n, a in arrays.items()}
            outs, n_two = build(v)
        got = fluid.Executor(fluid.CPUPlace()).run(main, feed=arrays,
                                                   fetch_list=outs)
    else:
        with fluid.dygraph.guard(fluid.CPUPlace()):
            outs, n_two = build({n: fluid.dygraph.to_variable(a)
                                 for n, a in arrays.items()})
            got = [o.numpy() for o in outs]
    want = [np.asarray(w) for w in jrnn_ops.beam_search_step(
        pre_ids, pre_scores, ids, scores, beam_size=W, end_id=END)]
    assert n_two == 2
    compare(got[:2], want[:2])
    compare(got[2:5], want)
    compare(got[5:7], [numpy_backtrace(sel_ids, parents),
                       numpy_backtrace(sel_scores, parents)])
    compare(got[7:9], [sel_ids, sel_scores])
