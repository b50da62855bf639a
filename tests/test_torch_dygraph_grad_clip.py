"""``fluid.dygraph_grad_clip`` (paddle_tpu_torch/dygraph_grad_clip.py)
against the JAX package's, on the CPU: each clip on the same
``(parameter, gradient)`` pairs, one gradient None, with the norms above
and below the bound. ``GradClipByValue`` exactly (a clamp); the norm clips
at rtol 1e-6 (the port's norms come from ``torch._foreach_norm``, which
sums in another order than ``jnp.sum(jnp.square(g))``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
import torch_jax_seed  # noqa: F401  (caps torch's threads)

SHAPES = [(4, 3), (3,), (2, 2, 5)]

# clip -> (arguments, tolerance)
CLIPS = {
    'GradClipByValue': ([(-0.5, 0.3), (0.4,)], 0.0),
    'GradClipByNorm': ([(1.0,), (100.0,)], 1e-6),
    'GradClipByGlobalNorm': ([(1.0,), (100.0,)], 1e-6),
}


def grads():
    rng = np.random.default_rng(5)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize('args_i', [0, 1], ids=['bound', 'loose'])
@pytest.mark.parametrize('name', list(CLIPS))
def test_clip_matches_jax(name, args_i):
    args, rtol = CLIPS[name][0][args_i], CLIPS[name][1]
    gs = grads()
    names = ['w', 'b', 'none', 'v']
    port_in = [('w', torch.from_numpy(gs[0])), ('b', torch.from_numpy(gs[1])),
               ('none', None), ('v', torch.from_numpy(gs[2]))]
    jax_in = [(n, None if g is None else np.asarray(g))
              for n, g in zip(names, [gs[0], gs[1], None, gs[2]])]
    got = getattr(fluid.dygraph_grad_clip, name)(*args)(port_in)
    want = getattr(jfluid.dygraph_grad_clip, name)(*args)(jax_in)
    assert [p for p, _ in got] == names
    for (_, g), (_, w) in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=0)
    # the inputs are left as they were
    np.testing.assert_array_equal(port_in[0][1].numpy(), gs[0])
    if args_i == 1 and name != 'GradClipByValue':
        for (_, g), a in zip([got[0], got[1], got[3]], gs):
            np.testing.assert_array_equal(g.numpy(), a)


def test_module_is_the_ports_and_names_the_three_clips():
    assert fluid.dygraph_grad_clip.__name__ == \
        'paddle_tpu_torch.dygraph_grad_clip'
    assert fluid.dygraph_grad_clip.__all__ == \
        jfluid.dygraph_grad_clip.__all__
    clip = fluid.dygraph_grad_clip.GradClipByValue(-2.0)
    assert (clip.min_value, clip.max_value) == (-2.0, 2.0)
    assert clip([]) == [] and clip([('p', None)]) == [('p', None)]
