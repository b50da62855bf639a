"""PaddleNLP's attention seq2seq (paddle_tpu_torch/tools/static_seq2seq.py)
built by both packages, trained through the port's Executor against the
JAX package's and beam-searched by both, on the CPU.

Size: source vocabulary 30, target vocabulary 20, hidden 8, 2 layers,
batch 3, padded lengths 6 (source) and 5 (target), beam 3 over 7 steps,
dropout off; ``numpy.random.RandomState`` sentences of the recipe's
layout (``</s>``-padded, lengths drawn per row); the JAX package's
startup values carried across by name, under the JAX seed fixture.

- The train, beam-search and startup programs hold the same ops in every
  block (slots) and variables in both packages; the beam-search program
  has the train program's parameters, by name and shape. At the recipe's
  width the model has 26,927,616 parameters.
- Three ``Adam(0.001)`` steps with ``GradientClipByGlobalNorm(5.0)``: the
  losses within 1e-5 relative, the first step's gradients and every
  parameter after each step within 1e-5 of its largest entry.
- The beam search from those values: the ids equal the JAX package's
  (measured: equal; the scores of the rows sit far from any tie at this
  size), the scores within 1e-5 of their largest magnitude.
- The beam-search model the port saves (``io.save_inference_model``) runs
  in the JAX package and gives the port's ids. The other way does not
  run: the JAX package's prune drops the weights only the decode step
  reads (ROADMAP C.10).
- One lowering of each program.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.tools import static_seq2seq
from torch_jax_seed import jax_seed_pinned  # noqa: F401

KW = dict(src_vocab_size=30, tar_vocab_size=20, hidden_size=8, num_layers=2,
          dropout=0.0, init_scale=1.0, batch_size=3, src_len=6, tar_len=5,
          beam_size=3, max_decode_steps=7)
STEPS = 3
RTOL = 1e-5


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


def build(pkg, mode='train', **kw):
    from paddle_tpu.core import unique_name as jnames
    from paddle_tpu_torch.core import unique_name as tnames
    with (jnames if pkg is jfluid else tnames).guard():
        return static_seq2seq.build(pkg, mode, **{**KW, **kw})


def sentences(rng, n, length, vocab):
    """``n`` rows of ``<s>`` ... ``</s>`` with lengths in [3, length + 1]
    (both marks counted), ``</s>``-padded to ``length + 1``; and the
    lengths."""
    lens = rng.randint(3, length + 2, n)
    out = np.full((n, length + 1), static_seq2seq.END, np.int64)
    for i, k in enumerate(lens):
        out[i, 0] = static_seq2seq.START
        out[i, 1:k - 1] = rng.randint(3, vocab, k - 2)
    return out, lens


def batches(n=STEPS):
    """The reader's feeds: the source without its ``<s>``; ``tar`` the
    target but its last token, ``label`` but its first, the target's
    length less one."""
    rng = np.random.RandomState(0)
    B, S, T = KW['batch_size'], KW['src_len'], KW['tar_len']
    out = []
    for _ in range(n):
        src, src_lens = sentences(rng, B, S, KW['src_vocab_size'])
        tar, tar_lens = sentences(rng, B, T, KW['tar_vocab_size'])
        out.append({'src': src[:, 1:], 'src_sequence_length':
                    (src_lens - 1).astype(np.int32),
                    'tar': tar[:, :-1], 'label': tar[:, 1:, None],
                    'tar_sequence_length': (tar_lens - 1).astype(np.int32)})
    return out


def _ops(program):
    """Each block's ops; a dtype attr int64 reads as int32, as ``_vars``
    reads the variables it follows."""
    return [(b.idx, b.parent_idx, op.type, op.inputs, op.outputs,
             {k: 'int32' if k == 'dtype' and v == 'int64' else v
              for k, v in op.attrs.items()
              if k != 'initializer' and not isinstance(v, np.ndarray)})
            for b in program.blocks for op in b.ops]


def _vars(program):
    """Each block's variables; an int64 one reads as int32, as the JAX
    package infers a cast to int64 with JAX's 64-bit types off (the port
    keeps int64)."""
    return [(b.idx, v.name, v.shape,
             'int32' if v.dtype == 'int64' else v.dtype, v.persistable,
             v.is_data, type(v).__name__) for b in program.blocks
            for v in b.vars.values()]


@pytest.mark.parametrize('which', ['train', 'startup', 'beam_search'])
def test_programs_match_jax(which):
    mode = 'beam_search' if which == 'beam_search' else 'train'
    idx = 1 if which == 'startup' else 0
    jp, tp = build(jfluid, mode)[idx], build(fluid, mode)[idx]
    assert _ops(tp) == _ops(jp)
    assert _vars(tp) == _vars(jp)
    types = {op.type for b in tp.blocks for op in b.ops}
    if which == 'train':
        assert {'__scan__', 'adam', 'sequence_mask'} <= types
    if which == 'beam_search':
        assert {'__scan__', 'gather_tree', 'top_k'} <= types
        assert 'adam' not in types


def test_both_modes_have_the_recipe_parameters():
    train, beam = build(fluid)[0], build(fluid, 'beam_search')[0]
    shapes = {p.name: p.shape for p in train.all_parameters()}
    assert shapes == {p.name: p.shape for p in beam.all_parameters()}
    with fluid.unique_name.guard():
        full = static_seq2seq.build(fluid)[0]
    assert sum(int(np.prod(p.shape))
               for p in full.all_parameters()) == 26927616


def jax_start():
    main, startup, v = build(jfluid)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    persist = sorted(x.name for x in main.list_vars() if x.persistable)
    return main, exe, scope, v, {n: np.asarray(scope.find(n))
                                 for n in persist}


def port_scope(program, start):
    scope = fluid.Scope()
    scope_from_paddle({n: a.astype(program.global_block().var(n).dtype)
                       for n, a in start.items()
                       if program.global_block().has_var(n)},
                      scope, fluid.CPUPlace(), program=program)
    return scope


def train(pkg, exe, program, scope, v, params):
    out = []
    for i, feed in enumerate(batches()):
        fetch = [v['loss']] + ([n + '@GRAD' for n in params] if i == 0
                               else [])
        got = [np.asarray(g) for g in exe.run(program, feed=feed,
                                              fetch_list=fetch, scope=scope)]
        out.append((got, {n: np.asarray(scope.find(n) if pkg is jfluid
                                        else scope.find(n).numpy())
                          for n in params}))
    return out


def close_to_largest(got, want, what):
    err = np.abs(got - want).max()
    assert err <= RTOL * max(np.abs(want).max(), 1e-30), (what, err)


def test_three_adam_steps_match_jax():
    jmain, jexe, jscope, jv, start = jax_start()
    params = sorted(p.name for p in jmain.all_parameters())
    want = train(jfluid, jexe, jmain, jscope, jv, params)
    main, startup, v = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    got = train(fluid, exe, main, port_scope(main, start), v, params)
    assert exe.lowering_count(main) == 1
    for n, g, w in zip(params, got[0][0][1:], want[0][0][1:]):
        assert np.abs(w).max() > 0, n
        close_to_largest(g, w, n + '@GRAD')
    for s, ((g_out, g_state), (w_out, w_state)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g_out[0], w_out[0], rtol=RTOL)
        for n in params:
            assert not np.array_equal(w_state[n], start[n]), n
            close_to_largest(g_state[n], w_state[n], f'{n} {s}')


def beam_feed():
    f = batches(1)[0]
    return {'src': f['src'], 'src_sequence_length': f['src_sequence_length']}


def test_beam_ids_match_jax():
    start = jax_start()[4]
    jprog, _, jv = build(jfluid, 'beam_search')
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for n, a in start.items():
        if jprog.global_block().has_var(n):
            jscope.set(n, a)
    want = [np.asarray(x) for x in jexe.run(
        jprog, feed=beam_feed(), fetch_list=[jv['ids'], jv['scores']],
        scope=jscope)]
    prog, _, v = build(fluid, 'beam_search')
    exe = fluid.Executor(fluid.CPUPlace())
    got = exe.run(prog, feed=beam_feed(), fetch_list=[v['ids'], v['scores']],
                  scope=port_scope(prog, start))
    B, W, T = KW['batch_size'], KW['beam_size'], KW['max_decode_steps']
    assert got[0].shape == (B, T, W) and got[1].shape == (B, T, W)
    np.testing.assert_array_equal(got[0], want[0])
    close_to_largest(got[1], want[1], 'scores')


def test_the_saved_beam_search_model_runs_in_jax(tmp_path):
    prog, startup, v = build(fluid, 'beam_search')
    exe = fluid.Executor(fluid.CPUPlace())
    scope = port_scope(prog, jax_start()[4])
    feed = beam_feed()
    with fluid.scope_guard(scope):
        want = exe.run(prog, feed=feed, fetch_list=[v['ids'], v['scores']])
        fluid.io.save_inference_model(str(tmp_path), list(feed),
                                      [v['ids'], v['scores']], exe,
                                      main_program=prog)
    assert exe.lowering_count(prog) == 1
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        jprog, feeds, fetches = jfluid.io.load_inference_model(str(tmp_path),
                                                               jexe)
        got = jexe.run(jprog, feed=feed, fetch_list=fetches)
    assert sorted(feeds) == sorted(feed)
    np.testing.assert_array_equal(np.asarray(got[0]), want[0])
    close_to_largest(np.asarray(got[1]), want[1], 'scores')
