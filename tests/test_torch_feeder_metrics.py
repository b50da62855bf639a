"""The port's ``DataFeeder``, ``metrics``, ``average`` and ``evaluator``
(ROADMAP A.13) against the JAX package's, on the CPU.

- ``DataFeeder.feed`` and ``feed_batch`` on the same seeded rows, with
  Variables declared the same way in both packages and with names: the same
  keys, types, shapes and values, bit for bit (both cast and reshape in
  numpy by the same rules). A ``lod_level > 0`` variable fed rows of
  different lengths needs a LoD tensor: the port raises naming ROADMAP
  A.10 (the JAX package builds its ``LoDTensor``).
- Each metric class fed the same seeded batches in both packages: the two
  ``eval()`` results agree within 1e-12 (host numpy, the same formulas),
  after a ``reset()`` too. ``DetectionMAP`` builds the detection layers,
  ROADMAP A.10 in the port.
- ``WeightedAverage`` as the JAX package's; the ``evaluator`` aliases warn.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import metrics as jmetrics
from paddle_tpu.average import WeightedAverage as JaxWeightedAverage
from paddle_tpu.data_feeder import DataFeeder as JaxDataFeeder
from paddle_tpu_torch import metrics
from paddle_tpu_torch.average import WeightedAverage
from paddle_tpu_torch.data_feeder import DataFeeder
from test_torch_static_graph import fresh_port_programs  # noqa: F401
from torch_jax_seed import jax_seed_pinned  # noqa: F401

TOL = 1e-12

# name -> (declared shape without the batch dim, dtype, a row's item)
FEED_VARS = {
    'img': ([1, 28, 28], 'float32',
            lambda rng: rng.uniform(-1, 1, 784)),             # f64 -> f32
    'label': ([1], 'int64', lambda rng: int(rng.integers(0, 10))),
    'mask': ([4, 2], 'float16', lambda rng: rng.random((2, 4))),
    'ids': ([3], 'int32', lambda rng: rng.integers(0, 9, 3)),
    'half': ([2], 'bfloat16', lambda rng: rng.random(2).astype('float32')),
    'ragged_ok': ([-1, 2], 'float32', lambda rng: rng.random((3, 2))),
}


def feed_vars(pkg):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        return [pkg.layers.data(n, shape, dtype=dtype)
                for n, (shape, dtype, _) in FEED_VARS.items()]


def rows(seed, n=6):
    rng = np.random.default_rng(seed)
    return [tuple(make(rng) for _, _, make in FEED_VARS.values())
            for _ in range(n)]


def assert_same_feed(got, want):
    assert list(got) == list(want)
    for name in got:
        g, w = got[name], want[name]
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize('by', ['variables', 'names'])
def test_feed_matches_jax_bit_for_bit(by):
    tv, jv = feed_vars(fluid), feed_vars(jfluid)
    if by == 'names':
        tv = jv = list(FEED_VARS)
    batch = rows(0)
    got = DataFeeder(tv, fluid.CPUPlace()).feed(batch)
    want = JaxDataFeeder(jv, jfluid.CPUPlace()).feed(batch)
    assert_same_feed(got, want)
    if by == 'variables':
        assert got['img'].shape == (6, 1, 28, 28)
        assert got['img'].dtype == np.float32
        assert got['label'].shape == (6, 1) and got['label'].dtype == np.int64
        assert got['mask'].shape == (6, 4, 2)
        assert got['half'].dtype == np.float32
        assert got['ragged_ok'].shape == (6, 3, 2)


def test_feed_batch_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    fields = [rng.uniform(-1, 1, (5, 784)), rng.integers(0, 10, 5),
              rng.random((5, 8)), rng.integers(0, 9, (5, 3)),
              rng.random((5, 2)), rng.random((5, 4, 2))]
    got = DataFeeder(feed_vars(fluid)).feed_batch(fields)
    want = JaxDataFeeder(feed_vars(jfluid)).feed_batch(fields)
    assert_same_feed(got, want)
    assert got['label'].shape == (5, 1) and got['mask'].shape == (5, 4, 2)


def test_empty_feed_is_an_empty_dict():
    assert DataFeeder(feed_vars(fluid)).feed([]) == {}
    assert JaxDataFeeder(feed_vars(jfluid)).feed([]) == {}


def lod_var(pkg):
    main = pkg.Program()
    return main.global_block().create_var(name='words', shape=(-1, -1, 1),
                                          dtype='int64', lod_level=1)


def test_lod_rows_of_one_length_feed_as_a_dense_batch():
    batch = [(np.arange(3).reshape(3, 1) + i,) for i in range(4)]
    got = DataFeeder([lod_var(fluid)]).feed(batch)
    want = JaxDataFeeder([lod_var(jfluid)]).feed(batch)
    assert_same_feed(got, want)


def test_ragged_rows_raise_naming_a10():
    batch = [(np.arange(n).reshape(n, 1),) for n in (3, 5)]
    want = JaxDataFeeder([lod_var(jfluid)]).feed(batch)
    assert type(want['words']).__name__ == 'LoDTensor'
    with pytest.raises(NotImplementedError, match='ROADMAP A[.]10'):
        DataFeeder([lod_var(fluid)]).feed(batch)


# ------------------------------------------------------------------ metrics

def batches(seed, n=5):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        k = int(rng.integers(3, 12))
        yield rng, k


def feed_precision(m, seed):
    for rng, k in batches(seed):
        m.update(rng.random((k, 1)), rng.integers(0, 2, (k, 1)))


def feed_accuracy(m, seed):
    for rng, k in batches(seed):
        m.update(np.array([rng.random()], np.float32), k)


def feed_chunks(m, seed):
    for rng, k in batches(seed):
        m.update(np.array([k + 2]), np.array([k + 1]),
                 np.array([int(rng.integers(0, k))]))


def feed_edit_distance(m, seed):
    for rng, k in batches(seed):
        d = rng.integers(0, 3, (k, 1)).astype(np.float32)
        m.update(d, np.array([k]))


def feed_auc(m, seed):
    for rng, k in batches(seed):
        p = rng.random((k, 1))
        m.update(np.concatenate([1 - p, p], 1), rng.integers(0, 2, (k, 1)))


def feed_auc_1d(m, seed):
    for rng, k in batches(seed):
        m.update(rng.random(k), rng.integers(0, 2, k))


METRICS = {
    'precision': (lambda mod: mod.Precision('p'), feed_precision),
    'recall': (lambda mod: mod.Recall(), feed_precision),
    'accuracy': (lambda mod: mod.Accuracy(), feed_accuracy),
    'chunk': (lambda mod: mod.ChunkEvaluator(), feed_chunks),
    'edit_distance': (lambda mod: mod.EditDistance('ed'),
                      feed_edit_distance),
    'auc': (lambda mod: mod.Auc('auc', num_thresholds=255), feed_auc),
    'auc_1d': (lambda mod: mod.Auc(), feed_auc_1d),
}


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got.shape == want.shape and np.allclose(got, want, rtol=0,
                                                   atol=TOL)


@pytest.mark.parametrize('name', sorted(METRICS))
def test_metric_matches_jax(name):
    make, feed = METRICS[name]
    got, want = make(metrics), make(jmetrics)
    assert got._name == want._name
    for seed in (0, 1):
        feed(got, seed)
        feed(want, seed)
        assert close(got.eval(), want.eval()), (got.eval(), want.eval())
        got.reset()
        want.reset()
        assert close(got.eval(), want.eval())
        assert got.get_config().keys() == want.get_config().keys()


def test_composite_metric_matches_jax():
    def make(mod):
        c = mod.CompositeMetric('pr')
        c.add_metric(mod.Precision())
        c.add_metric(mod.Recall())
        return c
    got, want = make(metrics), make(jmetrics)
    feed_precision(got, 3)
    feed_precision(want, 3)
    assert close(got.eval(), want.eval())


def test_metric_base_is_abstract():
    m = metrics.MetricBase('base')
    with pytest.raises(NotImplementedError):
        m.update(1)
    with pytest.raises(NotImplementedError):
        m.eval()
    assert m.get_config() == {} and m._name == 'base'


def test_detection_map_raises_naming_a10():
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data('det', [4, 6], 'float32')
        with pytest.raises(NotImplementedError, match='ROADMAP A[.]10'):
            metrics.DetectionMAP(x, x, x, class_num=3)


# ----------------------------------------------------- average, evaluator

def test_weighted_average_matches_jax():
    got, want = WeightedAverage(), JaxWeightedAverage()
    for wa in (got, want):
        with pytest.raises(ValueError, match='no data'):
            wa.eval()
        with pytest.raises(ValueError, match='number'):
            wa.add(1.0, np.array([1, 2]))
    rng = np.random.default_rng(4)
    for _ in range(6):
        v, w = rng.random(int(rng.integers(1, 5))), int(rng.integers(1, 9))
        got.add(v, w)
        want.add(v, w)
    assert abs(got.eval() - want.eval()) <= TOL
    got.reset()
    got.add(1.0, 1)
    got.add(3.0, 3)
    assert got.eval() == pytest.approx(2.5)
    got.reset()
    got.add([2.0, 4.0], 2)
    assert got.eval() == pytest.approx(3.0)


@pytest.mark.parametrize('name', ['ChunkEvaluator', 'EditDistance'])
def test_evaluator_aliases_warn(name):
    with pytest.warns(DeprecationWarning, match=f'fluid.metrics.{name}'):
        m = getattr(fluid.evaluator, name)()
    assert isinstance(m, getattr(metrics, name))
    assert type(m).__name__ == name
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        getattr(metrics, name)()


def test_evaluator_detection_map_raises_naming_a10():
    with pytest.warns(DeprecationWarning):
        with pytest.raises(NotImplementedError, match='ROADMAP A[.]10'):
            fluid.evaluator.DetectionMAP(None, None, None)
