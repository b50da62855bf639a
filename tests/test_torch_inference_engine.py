"""The port's ``InferenceEngine`` (paddle_tpu_torch/serving/engine.py)
against the JAX package's, on the CPU.

Two small static models, built and saved by the port (the JAX package
loads the port's inference models, tests/test_torch_static_io.py): a conv
+ batch norm + ReLU + pool + fc classifier with seeded running statistics,
and an embedding + fc over int64 ids. Both engines load the same
directory with ``max_batch_size=8`` (ladder 1, 2, 4, 8).

- ``run_batch`` at every row count, padded to its rung, against the JAX
  engine at atol 1e-5 (f32, sums in another order) and against the port's
  own single-row runs at atol 1e-6;
- ``validate`` rejects the same requests with the same messages (the
  int64 range check with the same reason, worded for the port);
- bf16 feeds through ``Config.enable_bf16``: bit for bit the f32 engine on
  bf16-rounded rows, and within 1e-5 of the JAX bf16 engine;
- padding, ``warmup`` and ``warmed``, the metrics a batch records;
- the embedding's id bounds and ``PADDLE_TPU_EMBED_OOB``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
import paddle_tpu_torch.observability as pobs
from paddle_tpu import inference as jinference
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch import inference
from paddle_tpu_torch.serving import InferenceEngine, InvalidRequest
from paddle_tpu_torch.serving import engine as engine_mod
from torch_jax_seed import jax_seed_pinned  # noqa: F401

CPU = fluid.CPUPlace()
IMAGE = (3, 8, 8)
VOCAB = 10


def save_model(path, kind):
    """Build ``kind`` ('conv' or 'embed') in the port, initialise it from
    the port's startup (batch-norm statistics seeded), save it."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if kind == 'conv':
            x = fluid.layers.data('img', list(IMAGE), dtype='float32')
            h = fluid.layers.conv2d(x, 4, 3, padding=1)
            h = fluid.layers.batch_norm(h, act='relu', is_test=True)
            h = fluid.layers.pool2d(h, 2, pool_type='max', pool_stride=2)
            feeds = ['img']
        else:
            x = fluid.layers.data('ids', [1], dtype='int64')
            h = fluid.layers.embedding(x, size=[VOCAB, 4])
            feeds = ['ids']
        out = fluid.layers.fc(h, 5, act='softmax')
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    rng = np.random.RandomState(7)
    with fluid.scope_guard(scope):
        exe.run(startup)
        for v in main.list_vars():
            if v.persistable and ('mean' in v.name or 'variance' in v.name):
                shape = scope.find(v.name).shape
                val = (rng.uniform(0.5, 2.0, shape) if 'variance' in v.name
                       else rng.normal(0, 0.5, shape))
                scope.set(v.name, torch.tensor(val, dtype=torch.float32))
        fluid.io.save_inference_model(str(path), feeds, [out], exe,
                                      main_program=main)
    return str(path)


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    return {k: save_model(tmp_path_factory.mktemp(k), k)
            for k in ('conv', 'embed')}


def engines(path, bf16=False):
    cfgs = []
    for inf in (inference, jinference):
        cfg = inf.Config(path)
        cfgs.append(cfg.enable_bf16() if bf16 else cfg)
    port = InferenceEngine(cfgs[0], executor=fluid.Executor(CPU),
                           max_batch_size=8)
    ref = JaxEngine(cfgs[1], executor=jfluid.Executor(jfluid.CPUPlace()),
                    max_batch_size=8)
    return port, ref


def images(n, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (n,) + IMAGE).astype(np.float32)


def test_ladder_names_and_specs_match(dirs):
    for kind in ('conv', 'embed'):
        port, ref = engines(dirs[kind])
        assert port.buckets == ref.buckets == [1, 2, 4, 8]
        assert port.get_input_names() == ref.get_input_names()
        assert port.get_output_names() == ref.get_output_names()
        assert port.input_spec == ref.input_spec
        assert port.id_bounds == ref.id_bounds
    assert port.id_bounds == {'ids': (VOCAB, port.id_bounds['ids'][1])}


@pytest.mark.parametrize('nrows', [1, 2, 3, 4, 5, 7, 8])
def test_run_batch_matches_jax_and_single_rows(dirs, nrows):
    port, ref = engines(dirs['conv'])
    x = images(nrows, seed=nrows)
    pobs.reset()
    got = port.run_batch({'img': x}, nrows)
    want = ref.run_batch({'img': x}, nrows)
    assert len(got) == len(want) == 1 and got[0].shape == (nrows, 5)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    bucket = port.bucket_for(nrows)
    assert port.compiled_buckets == [bucket]
    runs = pobs.registry.counter('serving_bucket_runs')
    assert runs.labels(bucket=bucket).value == 1
    waste = pobs.registry.histogram(
        'serving_padding_waste_ratio').labels().sample()
    assert waste['count'] == 1
    assert waste['recent'] == [(bucket - nrows) / bucket]
    for i in range(nrows):
        alone = port.run_batch({'img': x[i:i + 1]}, 1)[0]
        np.testing.assert_allclose(got[0][i:i + 1], alone, atol=1e-6,
                                   rtol=0)
    pobs.reset()


def bad_requests():
    x = images(2)
    return [
        'not a dict',
        [x, x],
        {'img': x, 'extra': x},
        {},
        {'img': x[0]},
        {'img': x[:, :2]},
        {'img': np.array([['a']], dtype=object)},
        {'img': [[['x']]]},
        {'img': images(9)},
        {'img': x[:0]},
    ]


def test_validate_errors_message_for_message(dirs):
    port, ref = engines(dirs['conv'])
    for bad in bad_requests():
        msgs = []
        for eng in (port, ref):
            with pytest.raises(ValueError) as ei:
                eng.validate(bad)
            assert type(ei.value).__name__ == 'InvalidRequest'
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1], bad
    feed, n = port.validate([images(3)])
    assert n == 3 and feed['img'].dtype == np.float32
    np.testing.assert_array_equal(port.infer({'img': images(3)})[0],
                                  port.run_batch(feed, n)[0])
    with pytest.raises(InvalidRequest, match='exceed the top bucket'):
        port.bucket_for(9)


def test_bf16_feeds(dirs):
    port, ref = engines(dirs['conv'], bf16=True)
    f32, _ = engines(dirs['conv'])
    assert port.config.precision == 'bfloat16'
    x = images(3, seed=11)
    got = port.run_batch({'img': x}, 3)[0]
    rounded = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert not np.array_equal(rounded, x)
    np.testing.assert_array_equal(got, f32.run_batch({'img': rounded},
                                                     3)[0])
    np.testing.assert_allclose(got, ref.run_batch({'img': x}, 3)[0],
                               atol=1e-5, rtol=0)


def test_warmup_and_warmed(dirs):
    port, ref = engines(dirs['conv'])
    assert not port.warmed and port.compiled_buckets == []
    pobs.reset()
    timings = port.warmup()
    assert sorted(timings) == sorted(ref.warmup()) == port.buckets
    assert port.warmed and port.compiled_buckets == port.buckets
    compiled = pobs.registry.gauge('serving_bucket_compiled')
    assert [compiled.labels(bucket=b).value for b in port.buckets] == \
        [1.0] * 4
    rows = pobs.registry.histogram('serving_batch_rows').labels().sample()
    assert rows['count'] == 4 and rows['sum'] == 15
    # an example row is validated, then tiled over the ladder
    assert sorted(port.warmup(example={'img': images(1)})) == port.buckets
    with pytest.raises(InvalidRequest):
        port.warmup(example={'img': images(1)[:, :1]})
    pobs.reset()


def ids(*values):
    return np.asarray(values, np.int64).reshape(-1, 1)


def test_id_bounds_and_embed_oob(dirs, monkeypatch):
    monkeypatch.delenv(engine_mod.ENV_EMBED_OOB, raising=False)
    port, ref = engines(dirs['embed'])
    good = ids(0, 3, 9)
    np.testing.assert_allclose(port.infer({'ids': good})[0],
                               ref.infer({'ids': good})[0], atol=1e-6)
    for bad in (ids(0, VOCAB), ids(-1, 2)):
        msgs = []
        for eng in (port, ref):
            with pytest.raises(ValueError) as ei:
                eng.validate({'ids': bad})
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1] and 'PADDLE_TPU_EMBED_OOB' in msgs[0]
    # int64 beyond int32: rejected by both, for the same reason
    big = ids(2 ** 31, 1)
    msgs = []
    for eng in (port, ref):
        with pytest.raises(Exception) as ei:
            eng.validate({'ids': big})
        assert type(ei.value).__name__ == 'InvalidRequest'
        msgs.append(str(ei.value))
    assert msgs[0].split(';')[0] == msgs[1].split(';')[0]
    monkeypatch.setenv(engine_mod.ENV_EMBED_OOB, 'clip')
    clipped = ids(0, VOCAB + 5)
    np.testing.assert_allclose(port.infer({'ids': clipped})[0],
                               ref.infer({'ids': clipped})[0], atol=1e-6)
    np.testing.assert_array_equal(port.infer({'ids': clipped})[0],
                                  port.infer({'ids': ids(0, VOCAB - 1)})[0])
    monkeypatch.setenv(engine_mod.ENV_EMBED_OOB, 'wrap')
    msgs = []
    for eng in (port, ref):
        with pytest.raises(ValueError) as ei:
            eng.validate({'ids': good})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
