"""Checkpoints of NHWC convolutions and ``to_variable``'s float types, the
port against the JAX package on the CPU (ROADMAP C.6 and C.7).

- C.6: the reference keeps an NHWC ``Conv2D``'s weight in Paddle's HWIO
  layout, the port in torch's OIHW. The port's ``state_dict`` gives it as
  an HWIO view and its ``set_dict`` copies through that view, so a file of
  one package's ``save_dygraph`` loads into the other's ``set_dict`` and
  the two give equal outputs: an NHWC ``Conv2D`` at atol 1e-5 (f32 sums in
  another order), a ResNet-18 in NHWC, in eval at batch 2 x 32^2, at atol
  1e-4 with its logits of order 10 (18 layers of such sums). A conv weight
  of the other layout's shape raises instead of loading reshaped.
- C.7: ``to_variable`` of a float64 array gives float32, as the reference
  computes it; a float64 torch tensor keeps its type, integers stay int64.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.models import resnet as port_resnet
import torch_jax_seed  # noqa: F401  (caps torch's threads)

CPU = fluid.CPUPlace()


def _conv(dy):
    return dy.Conv2D(4, 6, 3, padding=1, data_format='NHWC')


def _image(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port'])
def test_nhwc_conv2d_checkpoint_carries_across(tmp_path, direction):
    x = _image((2, 5, 5, 4))
    path = str(tmp_path / 'conv')
    with dygraph.guard(CPU):
        port = _conv(dygraph)
    with jdy.guard():
        ref = _conv(jdy)
        if direction == 'port_to_jax':
            fluid.save_dygraph(port.state_dict(), path)
            ref.set_dict(jfluid.load_dygraph(path)[0])
        else:
            jfluid.save_dygraph(ref.state_dict(), path)
        want = ref(jdy.to_variable(x)).numpy()
    with dygraph.guard(CPU):
        if direction == 'jax_to_port':
            port.set_dict(fluid.load_dygraph(path)[0])
        got = port(dygraph.to_variable(x)).numpy()
        sd = port.state_dict()
    assert tuple(sd['weight'].shape) == (3, 3, 4, 6)
    assert port.weight.shape == (6, 4, 3, 3)
    assert port.weight.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_a_conv_weight_of_the_other_layout_raises():
    with dygraph.guard(CPU):
        conv = _conv(dygraph)
        before = conv.weight.detach().clone()
        oihw = np.zeros((6, 4, 3, 3), np.float32)
        with pytest.raises(ValueError, match='weight'):
            conv.set_dict({'weight': oihw})
        assert torch.equal(conv.weight, before)
        nchw = dygraph.Conv2D(4, 6, 3)
        with pytest.raises(ValueError, match='weight'):
            nchw.set_dict({'weight': np.zeros((3, 3, 4, 6), np.float32)})
        nchw.set_dict({'weight': oihw})
        assert not nchw.weight.any()


def _port_resnet():
    return port_resnet.ResNet(18, 10, data_format='NHWC', device='cpu',
                              seed=3)


@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port'])
def test_nhwc_resnet_checkpoint_carries_across(tmp_path, direction):
    x = _image((2, 32, 32, 3), 1)
    path = str(tmp_path / 'resnet')
    port = _port_resnet().eval()
    with jdy.guard():
        ref = jax_resnet.ResNet(18, 10, data_format='NHWC')
        ref.eval()
        if direction == 'port_to_jax':
            fluid.save_dygraph(port.state_dict(), path)
            ref.set_dict(jfluid.load_dygraph(path)[0])
        else:
            jfluid.save_dygraph(ref.state_dict(), path)
            port.set_dict(fluid.load_dygraph(path)[0])
        want = ref(jdy.to_variable(x)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    sd = port.state_dict()
    assert tuple(sd['conv._conv.weight'].shape) == (7, 7, 3, 64)
    assert sorted(sd) == sorted(ref.state_dict())


def test_to_variable_makes_float64_float32():
    with dygraph.guard(CPU):
        x = dygraph.to_variable(np.random.randn(2, 3))
        assert x.dtype == torch.float32
        assert dygraph.to_variable([0.5, 1.5]).dtype == torch.float32
        assert dygraph.to_variable(np.arange(3)).dtype == torch.int64
        t = dygraph.to_variable(torch.ones(2, dtype=torch.float64))
        assert t.dtype == torch.float64
        fc = dygraph.Linear(3, 2)
        assert fc(x).dtype == torch.float32
    with jdy.guard():
        assert str(jdy.to_variable(np.random.randn(2, 3)).dtype) == 'float32'
