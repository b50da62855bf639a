"""The port's public ops take the reference's parameters, and the ones it
took over in doing so behave as the reference's do (on the CPU).

- Every public callable of ``paddle_tpu_torch.ops.{nn_ops, loss_ops,
  optimizer_ops, pallas_conv, math_ops, tensor_ops}`` that the reference's
  module of the same name also has is held to the reference's parameter
  names, kinds and defaults (``inspect.signature``), so a call written for
  the reference binds the same way in the port. So are the static graph's
  entry points that a Fluid script calls (``program_guard``, the layers
  LeNet uses, ``simple_img_conv_pool``, ``append_backward``,
  ``Executor.run`` and ``Optimizer.minimize``), and those of the static
  ResNet recipe's surface (the new layers and schedules,
  ``CompiledProgram``, ``io``'s save and load, the Predictor), and the
  control-flow layers and recurrent cells the PTB LM slice ported, and
  the decoders, beam-search layers and ops and ``sequence_mask`` of the
  static seq2seq slice, and static AMP's ops (the logical ops, the loss
  scaling's two), ``RecomputeOptimizer`` and ``Config.enable_bf16``, and
  the ops and static layers of the dygraph layers slice (A.4c: the
  activations, the 3-D and transposed convolutions, ``group_norm``,
  ``bilinear_tensor_product``, ops/extra_ops.py's four and
  ``temporal_shift``). So are
  the dygraph API's layer constructors, ``Layer``'s methods, the learning-rate schedules,
  ``save_dygraph``/``load_dygraph``, ``to_variable`` and ``guard``, and
  so are the ERNIE finetune slice's names (regularizers, clips,
  ``decorate``, the ERNIE model and ``finetune_optimizer``,
  ``TrainStep``), and so are the serving tier's (the prefix cache, the
  handoff's payload and worker, the router, their knobs, the pool's
  whole-block transfer and the engine's prefix and handoff methods), and
  so are the Fluid top-level surface's (``DataFeeder``, the metrics,
  ``WeightedAverage``, ``Trainer``, ``CheckpointConfig``, ``Inferencer``,
  ``device_guard``, ``require_version``, ``load_op_library``,
  ``memory_optimize``, ``release_memory``, the ``debugging`` functions,
  ``memory_usage``, ``summary``, ``op_freq_statistic``, ``probe_backend``
  and the host tools'; ``install_check`` and ``run_check`` add a last
  ``place=None``, named in ``TOP_LEVEL_ADDITIONS``); the
  port may add a keyword-only ``device``, and the Layer methods torch
  itself calls keep torch's arguments through ``*torch_args`` /
  ``**torch_kwargs``.
- ``softmax_with_cross_entropy`` with ``soft_label`` and on another
  ``axis``, against the JAX op: atol 1e-6 (one log-softmax in f32, the
  same formula).
- The quantized-pool scales of ``paged_attention`` and
  ``paged_prefill_attention`` go with an int8 pool and only with it: one
  without the other, or either with an f32 or bf16 pool, raises naming it.
- ``fused_conv1x1_bn_act(force_pallas=False)``, the reference's unfused
  formulation, against the JAX op's: f32 atol and rtol 1e-5 (sums in
  another order); bf16 within one bf16 ulp of the larger value plus 1e-6
  (both round the product, the affine's product and its sum to bf16 in
  the same order; they differ only where an f32 sum straddles a rounding
  boundary). Its gradients against ``jax.grad``: atol 1e-5, rtol 1e-4.
"""
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import loss_ops as jax_loss
from paddle_tpu.ops import pallas_conv as jpc
from paddle_tpu_torch.ops import loss_ops, nn_ops, pallas_conv
import torch_jax_seed  # noqa: F401  (caps torch's threads)

# (module, op) of every public op both packages have
SHARED_OPS = [
    ('nn_ops', 'paged_attention'), ('nn_ops', 'paged_prefill_attention'),
    ('nn_ops', 'fused_attention'), ('nn_ops', 'conv2d'),
    ('nn_ops', 'pool2d'), ('nn_ops', 'batch_norm'),
    ('nn_ops', 'softmax'), ('nn_ops', 'dropout'),
    ('nn_ops', 'log_softmax'), ('nn_ops', 'layer_norm'),
    ('nn_ops', 'lookup_table'),
    ('loss_ops', 'softmax_with_cross_entropy'), ('loss_ops', 'accuracy'),
    ('optimizer_ops', 'sgd'), ('optimizer_ops', 'momentum'),
    ('optimizer_ops', 'adam'),
    ('pallas_conv', 'fused_conv1x1_bn_act'),
    ('pallas_conv', 'stem_space_to_depth'),
    ('math_ops', 'elementwise_add'), ('math_ops', 'elementwise_sub'),
    ('math_ops', 'elementwise_mul'), ('math_ops', 'elementwise_div'),
    ('math_ops', 'scale'), ('math_ops', 'matmul'), ('math_ops', 'mul'),
    ('math_ops', 'mean'), ('math_ops', 'reduce_sum'),
    ('math_ops', 'reduce_mean'), ('math_ops', 'not_equal'),
    ('math_ops', 'elementwise_max'), ('math_ops', 'sum_op'),
    ('math_ops', 'clip'), ('math_ops', 'clip_by_norm'),
    ('math_ops', 'sqrt'), ('math_ops', 'square'), ('math_ops', 'sign'),
    ('tensor_ops', 'cast'), ('tensor_ops', 'reshape'),
    ('tensor_ops', 'fill_constant'), ('tensor_ops', 'transpose'),
    ('tensor_ops', 'one_hot'),
    # the static script surface around PaddleCV's ResNet recipe
    ('math_ops', 'elementwise_min'), ('math_ops', 'elementwise_pow'),
    ('math_ops', 'exp'), ('math_ops', 'log_'), ('math_ops', 'floor'),
    ('math_ops', 'ceil'), ('math_ops', 'cos'), ('math_ops', 'pow_op'),
    ('math_ops', 'reduce_max'), ('math_ops', 'reduce_min'),
    ('math_ops', 'equal'), ('math_ops', 'less_than'),
    ('math_ops', 'less_equal'), ('math_ops', 'greater_than'),
    ('math_ops', 'greater_equal'), ('math_ops', 'increment'),
    ('tensor_ops', 'concat'), ('tensor_ops', 'split'),
    ('tensor_ops', 'stack'), ('tensor_ops', 'unstack'),
    ('tensor_ops', 'squeeze'), ('tensor_ops', 'unsqueeze'),
    ('tensor_ops', 'gather'), ('tensor_ops', 'expand'),
    ('tensor_ops', 'assign'), ('tensor_ops', 'fill_constant_batch_size_like'),
    ('tensor_ops', 'fill_zeros_like'), ('tensor_ops', 'fill_any_like'),
    ('tensor_ops', 'top_k'), ('tensor_ops', 'arange'),
    ('loss_ops', 'cross_entropy'),
    ('loss_ops', 'sigmoid_cross_entropy_with_logits'),
    ('loss_ops', 'square_error_cost'),
    # the static control flow and the recurrent cells
    ('math_ops', 'sigmoid'), ('math_ops', 'tanh'),
    ('tensor_ops', 'slice_op'), ('tensor_ops', 'reverse'),
    ('tensor_ops', 'where'),
    # the static seq2seq decoding slice
    ('math_ops', 'elementwise_mod'), ('math_ops', 'elementwise_floordiv'),
    ('tensor_ops', 'arg_max'), ('tensor_ops', 'transpose_batch_time'),
    ('rnn_ops', 'beam_search_step'), ('rnn_ops', 'gather_tree'),
    ('random_ops', 'sampling_id'), ('sequence_ops', 'sequence_mask'),
    # static mixed precision
    ('math_ops', 'logical_and'), ('math_ops', 'logical_or'),
    ('math_ops', 'logical_xor'), ('math_ops', 'logical_not'),
    ('optimizer_ops', 'check_finite_and_unscale'),
    ('optimizer_ops', 'update_loss_scaling'),
    # the rest of the optimizer surface
    *(('optimizer_ops', op) for op in (
        'lars_momentum', 'adamax', 'adagrad', 'decayed_adagrad', 'rmsprop',
        'adadelta', 'ftrl', 'lamb', 'dpsgd', 'dgc_momentum')),
    # the rest of the dygraph layers and the activations
    *(('math_ops', op) for op in (
        'logsigmoid', 'atan', 'tanh_shrink', 'rsqrt', 'abs_', 'sin', 'acos',
        'asin', 'cosh', 'sinh', 'round_', 'reciprocal', 'softplus',
        'softsign', 'erf', 'gelu', 'leaky_relu', 'relu6', 'elu', 'selu',
        'prelu', 'brelu', 'soft_relu', 'stanh', 'hard_sigmoid',
        'hard_swish', 'swish', 'hard_shrink', 'softshrink',
        'thresholded_relu', 'maxout')),
    *(('nn_ops', op) for op in (
        'conv3d', 'conv2d_transpose', 'conv3d_transpose', 'group_norm',
        'bilinear_tensor_product')),
    *(('extra_ops', op) for op in (
        'spectral_norm', 'nce', 'gru_unit', 'tree_conv')),
    ('tensor_ops', 'temporal_shift')]
MODULES = sorted({m for m, _ in SHARED_OPS})


def modules(name):
    return (importlib.import_module(f'paddle_tpu_torch.ops.{name}'),
            importlib.import_module(f'paddle_tpu.ops.{name}'))


def public_callables(mod):
    """Names of the functions ``mod`` itself defines and does not hide."""
    return {n for n, f in vars(mod).items()
            if not n.startswith('_') and callable(f)
            and getattr(f, '__module__', None) == mod.__name__}


@pytest.mark.parametrize('name', MODULES)
def test_the_shared_op_list_is_complete(name):
    port, ref = modules(name)
    shared = {n for n in public_callables(port) if hasattr(ref, n)}
    assert shared == {op for m, op in SHARED_OPS if m == name}


@pytest.mark.parametrize('module,op', SHARED_OPS,
                         ids=[f'{m}.{op}' for m, op in SHARED_OPS])
def test_op_takes_the_reference_parameters(module, op):
    port, ref = modules(module)

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(getattr(port, op)) == params(getattr(ref, op))


# (module of both packages, attribute path) of the static graph's entry
# points a Fluid script calls
FLUID_ENTRY_POINTS = [
    ('framework', 'program_guard'), ('layers', 'fc'), ('layers', 'conv2d'),
    ('layers', 'pool2d'), ('layers', 'data'), ('layers', 'softmax'),
    ('layers', 'accuracy'), ('nets', 'simple_img_conv_pool'),
    ('backward', 'append_backward'), ('executor', 'Executor.run'),
    ('optimizer', 'Adam.minimize'),
    # the static script surface around PaddleCV's ResNet recipe
    ('layers', 'cross_entropy'), ('layers', 'piecewise_decay'),
    ('layers', 'cosine_decay'), ('layers', 'embedding'),
    ('layers', 'layer_norm'), ('layers', 'concat'), ('layers', 'topk'),
    ('layers', 'split'), ('layers', 'assign'), ('layers', 'increment'),
    ('layers', 'less_than'), ('compiler', 'CompiledProgram'),
    ('compiler', 'CompiledProgram.with_data_parallel'),
    ('io', 'save_persistables'), ('io', 'load_persistables'),
    ('io', 'save_inference_model'), ('io', 'load_inference_model'),
    ('io', 'save'), ('io', 'load'), ('inference', 'Predictor'),
    ('inference', 'Config'),
    # the static control flow and the recurrent cells of the PTB LM slice
    ('layers', 'cond'), ('layers', 'case'), ('layers', 'switch_case'),
    ('layers', 'while_loop'), ('layers', 'While'), ('layers', 'While.block'),
    ('layers', 'StaticRNN'), ('layers', 'StaticRNN.step_input'),
    ('layers', 'StaticRNN.memory'), ('layers', 'StaticRNN.update_memory'),
    ('layers', 'StaticRNN.step_output'), ('layers', 'Switch'),
    ('layers', 'Switch.case'), ('layers', 'IfElse'),
    ('layers', 'DynamicRNN'), ('layers', 'DynamicRNN.step_input'),
    ('layers', 'DynamicRNN.memory'), ('layers', 'DynamicRNN.update_memory'),
    ('layers', 'create_array'), ('layers', 'array_write'),
    ('layers', 'array_read'), ('layers', 'array_length'),
    ('layers', 'is_empty'), ('layers', 'tensor_array_to_tensor'),
    ('layers', 'reverse'), ('layers', 'RNNCell.get_initial_states'),
    ('layers', 'GRUCell'), ('layers', 'LSTMCell'), ('layers', 'rnn'),
    ('layers', 'birnn'), ('layers', 'lstm'),
    # the static seq2seq decoding slice
    ('layers', 'BeamSearchDecoder'), ('layers', 'BeamSearchDecoder.step'),
    ('layers', 'BeamSearchDecoder.finalize'), ('layers', 'dynamic_decode'),
    ('layers', 'gather_tree'), ('layers', 'beam_search'),
    ('layers', 'beam_search_decode'), ('layers', 'BasicDecoder'),
    ('layers', 'BasicDecoder.step'), ('layers', 'TrainingHelper'),
    ('layers', 'GreedyEmbeddingHelper'), ('layers', 'SampleEmbeddingHelper'),
    ('layers', 'sequence_mask'), ('layers', 'sequence_lod.sequence_mask'),
    # static mixed precision and recompute
    ('optimizer', 'RecomputeOptimizer'),
    ('optimizer', 'RecomputeOptimizer._set_checkpoints'),
    ('optimizer', 'RecomputeOptimizer.minimize'),
    ('inference', 'Config.enable_bf16'),
    # the static layers of the dygraph layers slice (A.4c)
    *(('layers', name) for name in (
        'conv3d', 'conv2d_transpose', 'conv3d_transpose', 'group_norm',
        'spectral_norm', 'prelu', 'nce', 'bilinear_tensor_product',
        'gru_unit'))]


@pytest.mark.parametrize('module,path', FLUID_ENTRY_POINTS,
                         ids=[f'{m}.{p}' for m, p in FLUID_ENTRY_POINTS])
def test_fluid_entry_point_takes_the_reference_parameters(module, path):
    def resolve(pkg):
        obj = importlib.import_module(f'{pkg}.{module}')
        for part in path.split('.'):
            obj = getattr(obj, part)
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(obj).parameters.values()]

    assert resolve('paddle_tpu_torch') == resolve('paddle_tpu')


# ------------------------------------------------------------- dygraph API

# Layer methods that torch itself calls with its own arguments
# (functional_call's ``remove_duplicate``, ``state_dict``'s ``keep_vars``,
# ``train(mode)``, ``register_buffer``'s ``persistent``): these may take
# them through ``*torch_args`` / ``**torch_kwargs`` after Paddle's
TORCH_CALLED = {'parameters', 'named_parameters', 'buffers', 'named_buffers',
                'state_dict', 'train', 'register_buffer'}


def _params(fn, torch_called=False):
    """(name, kind, default) of ``fn``'s parameters, without the port's
    keyword-only ``device`` and, where torch calls the method, its
    ``*torch_args`` / ``**torch_kwargs``."""
    out = []
    for p in inspect.signature(fn).parameters.values():
        if p.name == 'device' and p.kind == p.KEYWORD_ONLY:
            continue
        if torch_called and p.name in ('torch_args', 'torch_kwargs'):
            continue
        out.append((p.name, p.kind, p.default))
    return out


DYGRAPH_LAYERS = ['Conv2D', 'Pool2D', 'BatchNorm', 'Linear', 'Embedding',
                  'LayerNorm', 'Dropout', 'Conv3D', 'Conv2DTranspose',
                  'Conv3DTranspose', 'GroupNorm', 'SpectralNorm', 'PRelu',
                  'BilinearTensorProduct', 'GRUUnit', 'NCE', 'TreeConv']


@pytest.mark.parametrize('name', DYGRAPH_LAYERS)
def test_dygraph_layer_takes_the_reference_parameters(name):
    from paddle_tpu.dygraph import nn as jnn
    from paddle_tpu_torch.dygraph import nn as pnn
    assert _params(getattr(pnn, name)) == _params(getattr(jnn, name))


def _layer_methods():
    from paddle_tpu.dygraph.layers import Layer
    return sorted(n for n, f in vars(Layer).items()
                  if callable(f) and (not n.startswith('_')
                                      or n == '__init__'))


@pytest.mark.parametrize('name', _layer_methods())
def test_layer_method_takes_the_reference_parameters(name):
    from paddle_tpu.dygraph.layers import Layer as JLayer
    from paddle_tpu_torch.dygraph.layers import Layer
    got = _params(getattr(Layer, name), name in TORCH_CALLED)
    assert got == _params(getattr(JLayer, name))


SCHEDULE_CLASSES = ['LearningRateDecay', 'PiecewiseDecay', 'NaturalExpDecay',
                    'ExponentialDecay', 'InverseTimeDecay', 'PolynomialDecay',
                    'CosineDecay', 'LinearLrWarmup', 'NoamDecay']


@pytest.mark.parametrize('name', SCHEDULE_CLASSES)
def test_schedule_takes_the_reference_parameters(name):
    from paddle_tpu.dygraph import learning_rate_scheduler as jsched
    from paddle_tpu_torch.dygraph import learning_rate_scheduler as psched
    assert _params(getattr(psched, name)) == _params(getattr(jsched, name))


# (module of both packages, attribute path) of what the ERNIE finetune
# slice ported: regularizers, clips, AMP's decorate, the ERNIE model and
# recipe, and TrainStep (gradient merge)
FINETUNE_NAMES = [
    ('regularizer', 'L1Decay'), ('regularizer', 'L2Decay'),
    ('regularizer', 'append_regularization_ops'),
    ('clip', 'GradientClipByValue'), ('clip', 'GradientClipByNorm'),
    ('clip', 'GradientClipByGlobalNorm'), ('clip', 'ErrorClipByValue'),
    ('clip', 'set_gradient_clip'), ('clip', 'append_gradient_clip_ops'),
    ('contrib.mixed_precision', 'decorate'),
    ('contrib.mixed_precision', 'AutoMixedPrecisionLists'),
    ('contrib.mixed_precision', 'OptimizerWithMixedPrecision'),
    ('contrib.mixed_precision', 'OptimizerWithMixedPrecision.minimize'),
    ('contrib.mixed_precision', 'OptimizerWithMixedPrecision.'
                                'get_loss_scaling'),
    ('contrib.mixed_precision', 'OptimizerWithMixedPrecision.'
                                'overflow_steps'),
    ('contrib.mixed_precision', 'cast_model_to_bf16'),
    ('models.ernie', 'ErnieConfig.base'),
    ('models.ernie', 'ErnieForSequenceClassification'),
    ('models.ernie', 'ErnieForSequenceClassification.forward'),
    ('models.ernie', 'finetune_optimizer'), ('dygraph.jit', 'TrainStep')]


@pytest.mark.parametrize('module,path', FINETUNE_NAMES,
                         ids=[f'{m}.{p}' for m, p in FINETUNE_NAMES])
def test_finetune_name_takes_the_reference_parameters(module, path):
    def resolve(pkg):
        obj = importlib.import_module(f'{pkg}.{module}')
        for part in path.split('.'):
            obj = getattr(obj, part)
        return _params(obj)

    assert resolve('paddle_tpu_torch') == resolve('paddle_tpu')


@pytest.mark.parametrize('module,name', [
    ('checkpoint', 'save_dygraph'), ('checkpoint', 'load_dygraph'),
    ('base', 'to_variable'), ('base', 'guard'),
    ('base', 'enable_dygraph'), ('tape', 'grad')],
    ids=lambda v: v)
def test_dygraph_function_takes_the_reference_parameters(module, name):
    port = importlib.import_module(f'paddle_tpu_torch.dygraph.{module}')
    ref = importlib.import_module(f'paddle_tpu.dygraph.{module}')
    assert _params(getattr(port, name)) == _params(getattr(ref, name))


# (module of both packages, attribute path) of the serving tier's slice:
# the prefix cache, the handoff, the router, their knobs and the pool's and
# engine's new methods
SERVING_TIER_NAMES = [
    ('serving.tier.knobs', 'parse_float_env'),
    ('serving.tier.knobs', 'parse_replicas_env'),
    ('serving.tier.prefix_cache', 'PrefixCache'),
    ('serving.tier.prefix_cache', 'PrefixCache.match'),
    ('serving.tier.prefix_cache', 'PrefixCache.acquire_table'),
    ('serving.tier.prefix_cache', 'PrefixCache.insert'),
    ('serving.tier.prefix_cache', 'PrefixCache.evict_idle'),
    ('serving.tier.disagg', 'KVPayload'),
    ('serving.tier.disagg', 'KVPayload.from_bytes'),
    ('serving.tier.disagg', 'PrefillReplica.prefill_to_payload'),
    ('serving.tier.disagg', 'PrefillReplica'),
    ('serving.tier.disagg', 'LocalPrefillWorker.submit'),
    ('serving.tier.disagg', 'LocalPrefillWorker.drain_completed'),
    ('serving.tier.router', 'Router'),
    ('serving.tier.router', 'Router.stream_generate'),
    ('serving.tier.router', 'Router.generate'),
    ('serving.tier.router', 'Router.generate_nonstream'),
    ('serving.tier.router', 'Router.rolling_restart'),
    ('serving.tier.router', 'Router.add_replica'),
    ('serving.tier.router', 'Router.remove_replica'),
    ('serving.tier.router', 'Router.fleet_metrics_text'),
    ('serving.tier.router', 'RouterServer'),
    ('serving.tier.router', 'Replica'),
    ('serving.decode.kv_cache', 'BlockTable'),
    ('serving.decode.kv_cache', 'BlockAllocator.retain'),
    ('serving.decode.kv_cache', 'BlockAllocator.release'),
    ('serving.decode.kv_cache', 'KVCachePool.read_blocks'),
    ('serving.decode.kv_cache', 'KVCachePool.read_block_scales'),
    ('serving.decode.kv_cache', 'KVCachePool.write_whole_blocks'),
    ('serving.decode.engine', 'DecodeEngine.reserve_table'),
    ('serving.decode.engine', 'DecodeEngine.publish_prefix'),
    ('serving.decode.engine', 'DecodeEngine.inject_prefill')]


@pytest.mark.parametrize('module,path', SERVING_TIER_NAMES,
                         ids=[f'{m}.{p}' for m, p in SERVING_TIER_NAMES])
def test_serving_tier_name_takes_the_reference_parameters(module, path):
    def resolve(pkg):
        obj = importlib.import_module(f'{pkg}.{module}')
        for part in path.split('.'):
            obj = getattr(obj, part)
        return _params(obj)

    assert resolve('paddle_tpu_torch') == resolve('paddle_tpu')


# (module of both packages, attribute path) of the Fluid top-level
# surface's slice (ROADMAP A.13)
TOP_LEVEL_NAMES = [
    ('data_feeder', 'DataFeeder'), ('data_feeder', 'DataFeeder.feed'),
    ('data_feeder', 'DataFeeder.feed_batch'),
    *(('metrics', f'{c}{m}') for c in (
        'MetricBase', 'CompositeMetric', 'Precision', 'Recall', 'Accuracy',
        'ChunkEvaluator', 'EditDistance', 'Auc')
      for m in ('', '.update', '.eval')),
    ('metrics', 'CompositeMetric.add_metric'), ('metrics', 'DetectionMAP'),
    ('average', 'WeightedAverage'), ('average', 'WeightedAverage.add'),
    ('average', 'WeightedAverage.eval'),
    ('contrib.trainer', 'Trainer'), ('contrib.trainer', 'Trainer.train'),
    ('contrib.trainer', 'Trainer.test'), ('contrib.trainer', 'Trainer.stop'),
    ('contrib.trainer', 'Trainer.save_params'),
    ('contrib.trainer', 'Trainer.save_inference_model'),
    ('contrib.trainer', 'CheckpointConfig'),
    ('contrib.trainer', 'BeginEpochEvent'),
    ('contrib.trainer', 'EndEpochEvent'),
    ('contrib.trainer', 'BeginStepEvent'),
    ('contrib.trainer', 'EndStepEvent'),
    ('contrib.inferencer', 'Inferencer'),
    ('contrib.inferencer', 'Inferencer.infer'),
    ('framework', 'device_guard'), ('framework', 'require_version'),
    ('framework', 'load_op_library'), ('transpiler', 'memory_optimize'),
    ('transpiler', 'release_memory'),
    ('debugging', 'enable_check_nan_inf'),
    ('debugging', 'check_nan_inf_enabled'),
    ('debugging', 'nonfinite_summary'), ('debugging', 'check_numerics'),
    ('debugging', 'assert_all_finite'), ('debugging', 'device_report'),
    ('debugging', 'install_check'), ('install_check', 'run_check'),
    ('contrib.memory_usage_calc', 'memory_usage'),
    ('contrib.memory_usage_calc', 'device_memory_stats'),
    ('contrib.memory_usage_calc', 'print_memory_report'),
    ('contrib.model_stat', 'summary'),
    ('contrib.op_frequence', 'op_freq_statistic'),
    ('utils.backend_probe', 'probe_backend'),
    ('utils.plot', 'Ploter'), ('utils.plot', 'Ploter.append'),
    ('utils.plot', 'Ploter.plot'), ('utils.dump_config', 'dump_config'),
    ('debugger', 'draw_block_graphviz'), ('debugger', 'pprint_block_codes'),
    ('debugger', 'pprint_program_codes'), ('debugger', 'repr_var'),
    ('debugger', 'repr_op'), ('debugger', 'prepare_fast_nan_inf_debug'),
    ('debugger', 'run_fast_nan_inf_debug'), ('net_drawer', 'draw_graph'),
    ('net_drawer', 'parse_graph'), ('op', 'get_all_op_protos'),
    ('op', 'OpInfo'), ('op', 'OperatorFactory.get_op_creation_info'),
    ('param_attr', 'WeightNormParamAttr'),
    ('core.places', 'cuda_pinned_places'), ('core.places', 'tpu_places'),
    ('log_helper', 'get_logger'), ('annotations', 'deprecated'),
    ('default_scope_funcs', 'scoped_function'),
    ('default_scope_funcs', 'var'), ('default_scope_funcs', 'find_var')]

# the port's additions to the reference's parameters in that slice: the
# JAX package's self-test runs on its default device, the port's on the
# card unless the caller passes a place
TOP_LEVEL_ADDITIONS = {('debugging', 'install_check'): ('place', None),
                       ('install_check', 'run_check'): ('place', None)}


@pytest.mark.parametrize('module,path', TOP_LEVEL_NAMES,
                         ids=[f'{m}.{p}' for m, p in TOP_LEVEL_NAMES])
def test_top_level_name_takes_the_reference_parameters(module, path):
    def resolve(pkg):
        obj = importlib.import_module(f'{pkg}.{module}')
        for part in path.split('.'):
            obj = getattr(obj, part)
        return _params(obj)

    got, want = resolve('paddle_tpu_torch'), resolve('paddle_tpu')
    added = TOP_LEVEL_ADDITIONS.get((module, path))
    if added is not None:
        name, default = added
        assert got[-1] == (name, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                           default)
        got = got[:-1]
    assert got == want


# (module of both packages, attribute path) of the stateless serving slice
# (ROADMAP A.7b) and the observability core (A.11)
STATELESS_SERVING_NAMES = [
    *(('serving.engine', f'InferenceEngine{m}') for m in (
        '', '.validate', '.bucket_for', '.run_batch', '.infer',
        '.warmup')),
    ('serving.engine', 'bucket_ladder'),
    *(('serving.batcher', f'MicroBatcher{m}') for m in (
        '', '.submit', '.predict', '.close')),
    ('serving.batcher', 'PredictionFuture.result'),
    ('serving.batcher', 'PredictionFuture.add_done_callback'),
    ('serving.server', 'ServingServer'),
    ('serving.server', 'ServingServer.shutdown'),
    ('serving.server', 'create_server'),
    ('serving.decode.scheduler', 'DecodeScheduler.submit'),
    ('serving.tier.router', 'Router.scrape_replica_metrics'),
    *(('observability', n) for n in (
        'enable', 'disable', 'telemetry_guard', 'span', 'instant', 'inc',
        'set_gauge', 'observe', 'log_step', 'reset', 'dump_artifacts')),
    *(('observability.metrics', f'MetricsRegistry.{m}') for m in (
        'counter', 'gauge', 'histogram', 'prometheus_text')),
    ('observability.tracer', 'StepTracer.complete'),
    ('observability.trace_context', 'TraceContext'),
    *(('observability.distributed', n) for n in (
        'record_span', 'record_clock_offset', 'set_process_label',
        'parse_prometheus_text', 'merge_fleet_metrics', 'WindowedSeries',
        'series', 'parse_slo_spec', 'SLOMonitor', 'StragglerMonitor',
        'StragglerMonitor.evaluate', 'publish_host_snapshot',
        'aggregate_fleet_snapshots'))]


@pytest.mark.parametrize('module,path', STATELESS_SERVING_NAMES,
                         ids=[f'{m}.{p}' for m, p in STATELESS_SERVING_NAMES])
def test_stateless_serving_name_takes_the_reference_parameters(module,
                                                               path):
    def resolve(pkg):
        obj = importlib.import_module(f'{pkg}.{module}')
        for part in path.split('.'):
            obj = getattr(obj, part)
        return _params(obj)

    assert resolve('paddle_tpu_torch') == resolve('paddle_tpu')


# (module of both packages, attribute path) of dygraph-to-static (A.4d) and
# dygraph data parallelism on torch.distributed (A.9a)
A4D_A9A_NAMES = [
    *(('dygraph.jit', n) for n in (
        'functionalize', 'TracedLayer', 'TracedLayer.trace',
        'TracedLayer.__call__', 'TracedLayer.save_inference_model',
        'InputSpec', 'ProgramTranslator.enable',
        'ProgramTranslator.get_output', 'StaticFunction',
        'StaticFunction.__call__', 'declarative', 'to_static',
        '_find_layers')),
    ('io', '_save_jit_model'),
    *(('dygraph.parallel', n) for n in (
        'ParallelEnv', 'prepare_context', 'DataParallel',
        'DataParallel.forward', 'DataParallel.scale_loss',
        'DataParallel.apply_collective_grads', '_allreduce_bundles',
        '_cross_process_allreduce')),
    *(('fleet_runtime.bootstrap', n) for n in (
        'FleetSpec', 'discover_fleet_env', 'bootstrap', 'process_index',
        'process_count', 'is_host0', 'fleet_barrier', 'broadcast_from_host0',
        'all_hosts_agree', 'fleet_allreduce_scalars', 'free_port',
        'local_fleet', 'LocalFleet', 'LocalFleet.wait')),
    *(('distributed.launch', n) for n in (
        'init_parallel_env', 'get_rank', 'get_world_size', 'launch')),
    *(('parallel.collective', n) for n in (
        'allreduce_sum', 'allreduce_mean', 'allreduce_max', 'allreduce_min',
        'allgather', 'reduce_scatter', 'broadcast', 'alltoall', 'ppermute',
        'barrier', 'c_allreduce_sum', 'c_allreduce_sum_bucket',
        'c_allreduce_max', 'c_allreduce_min', 'c_allreduce_prod',
        'c_allgather', 'c_broadcast', 'c_reducescatter',
        'c_sync_calc_stream', 'c_sync_comm_stream')),
    *(('parallel.quant_collectives', n) for n in (
        'resolve_comm_dtype', 'block_quantize', 'block_dequantize',
        'qallreduce_sum', 'qallreduce_mean', 'qreduce_scatter_sum',
        'wire_bytes', 'record_collective', 'quant_error_stats',
        'record_quant_error')),
    ('parallel_executor', 'ParallelExecutor'),
    ('parallel_executor', 'ParallelExecutor.run')]


@pytest.mark.parametrize('module,path', A4D_A9A_NAMES,
                         ids=[f'{m}.{p}' for m, p in A4D_A9A_NAMES])
def test_a4d_a9a_name_takes_the_reference_parameters(module, path):
    def resolve(pkg):
        obj = importlib.import_module(f'{pkg}.{module}')
        for part in path.split('.'):
            obj = getattr(obj, part)
        return _params(obj)

    assert resolve('paddle_tpu_torch') == resolve('paddle_tpu')


# ------------------------------------------------ softmax_with_cross_entropy

def test_soft_label_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 11)).astype(np.float32) * 3
    label = rng.random((6, 11)).astype(np.float32)
    label /= label.sum(-1, keepdims=True)
    want_loss, want_sm = jax_loss.softmax_with_cross_entropy(
        logits, label, soft_label=True)
    loss, sm = loss_ops.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label), soft_label=True)
    assert loss.shape == (6, 1)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(sm.numpy(), np.asarray(want_sm), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize('soft', [False, True], ids=['hard', 'soft'])
def test_axis_1_of_a_3d_input_matches_jax(soft):
    """Classes on axis 1 of (N, C, T), a hard label (N, 1, T) with an
    ignored entry, or a soft label of the logits' shape."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 5)).astype(np.float32) * 2
    if soft:
        label = rng.random((3, 7, 5)).astype(np.float32)
        label /= label.sum(1, keepdims=True)
    else:
        label = rng.integers(0, 7, (3, 1, 5)).astype(np.int64)
        label[1, 0, 2] = -100
    kw = {'soft_label': soft, 'axis': 1, 'return_softmax': True,
          'numeric_stable_mode': False}
    want_loss, want_sm = jax_loss.softmax_with_cross_entropy(logits, label,
                                                             **kw)
    loss, sm = loss_ops.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label), **kw)
    assert loss.shape == (3, 1, 5) == np.asarray(want_loss).shape
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(sm.numpy(), np.asarray(want_sm), atol=1e-6,
                               rtol=0)
    if not soft:
        assert loss[1, 0, 2].item() == 0.0


# -------------------------------------------------------- paged attention

def paged_operands():
    q = torch.zeros(2, 2, 16)
    pages = torch.zeros(2, 4, 4, 16)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    return q, pages, tables, torch.ones(2, dtype=torch.int32)


def _other(which):
    return {'k': 'v', 'v': 'k'}[which]


@pytest.mark.parametrize('which', ['k', 'v'])
def test_paged_attention_scales_are_not_ported(which):
    """The scales are ported (ROADMAP A.6): an int8 pool takes both, so
    giving one alone raises ``ValueError`` naming the missing one, and an
    f32 or bf16 pool takes none, so giving one raises naming it; an int8
    pool with both runs."""
    q, pages, tables, ctx = paged_operands()
    scales = {f'{which}_scales': torch.ones(2, 4, 4)}
    p8 = pages.to(torch.int8)
    with pytest.raises(ValueError, match=f'{_other(which)}_scales is '
                                         f'missing'):
        nn_ops.paged_attention(q, p8, p8, tables, ctx, **scales)
    for pool in (pages, pages.bfloat16()):
        with pytest.raises(ValueError, match=f'{which}_scales given'):
            nn_ops.paged_attention(q, pool, pool, tables, ctx, **scales)
    both = {'k_scales': torch.ones(2, 4, 4), 'v_scales': torch.ones(2, 4, 4)}
    assert nn_ops.paged_attention(q, p8, p8, tables, ctx,
                                  **both).shape == q.shape


@pytest.mark.parametrize('which', ['k', 'v'])
def test_paged_prefill_attention_scales_are_not_ported(which):
    """As for ``paged_attention``: an int8 pool needs both scales, an f32 or
    bf16 pool takes none, each miss or extra raises ``ValueError`` naming
    the argument, and an int8 pool with both runs."""
    _, pages, tables, _ = paged_operands()
    q = torch.zeros(1, 2, 3, 16)
    scales = {f'{which}_scales': torch.ones(2, 4, 4)}
    p8 = pages.to(torch.int8)
    with pytest.raises(ValueError, match=f'{_other(which)}_scales is '
                                         f'missing'):
        nn_ops.paged_prefill_attention(q, q, q, p8, p8, tables[:1],
                                       **scales)
    for pool in (pages, pages.bfloat16()):
        with pytest.raises(ValueError, match=f'{which}_scales given'):
            nn_ops.paged_prefill_attention(q, q, q, pool, pool, tables[:1],
                                           **scales)
    both = {'k_scales': torch.ones(2, 4, 4), 'v_scales': torch.ones(2, 4, 4)}
    assert nn_ops.paged_prefill_attention(q, q, q, p8, p8, tables[:1],
                                          **both).shape == q.shape


@pytest.mark.parametrize('ppcb', [0, -1, 2.0, True, None])
def test_paged_attention_checks_pages_per_compute_block(ppcb):
    q, pages, tables, ctx = paged_operands()
    with pytest.raises(ValueError, match='pages_per_compute_block'):
        nn_ops.paged_attention(q, pages, pages, tables, ctx,
                               pages_per_compute_block=ppcb)


def test_paged_attention_ignores_pages_per_compute_block():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 2, 16), np.float32))
    pages = torch.from_numpy(rng.standard_normal((2, 4, 4, 16), np.float32))
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    ctx = torch.tensor([6, 3], dtype=torch.int32)
    want = nn_ops.paged_attention(q, pages, pages, tables, ctx)
    for ppcb in (1, 3, np.int64(8)):
        got = nn_ops.paged_attention(q, pages, pages, tables, ctx, None,
                                     None, pages_per_compute_block=ppcb)
        assert torch.equal(got, want)


@pytest.mark.parametrize('which', ['k', 'v'])
def test_paged_prefill_checks_the_raw_projections_shape(which):
    _, pages, tables, _ = paged_operands()
    q = torch.zeros(1, 2, 3, 16)
    raw = {'k': q, 'v': q}
    raw[which] = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match=f'{which} .* q'):
        nn_ops.paged_prefill_attention(q, raw['k'], raw['v'], pages, pages,
                                       tables[:1])


def test_paged_prefill_does_not_read_the_raw_projections():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 5, 16), np.float32))
    pages = torch.from_numpy(rng.standard_normal((2, 4, 4, 16), np.float32))
    tables = torch.tensor([[2, 1]], dtype=torch.int32)
    a = nn_ops.paged_prefill_attention(q, q, q, pages, pages, tables)
    b = nn_ops.paged_prefill_attention(q, torch.full_like(q, 1e30),
                                       torch.full_like(q, float('nan')),
                                       pages, pages, tables)
    assert torch.equal(a, b)


# ------------------------------------------ fused_conv1x1_bn_act, unfused

# (B, H, W, C, O): the reference's parity shapes and one with a deeper K
UNFUSED_SHAPES = {'c16-o12': (2, 8, 8, 16, 12), 'c6-o5': (1, 4, 4, 6, 5),
                  'c64-o24': (2, 5, 7, 64, 24)}


def conv_inputs(shape, seed):
    b, h, w, c, o = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            (rng.standard_normal((1, 1, c, o)) * 0.3).astype(np.float32),
            (rng.random(o) + 0.5).astype(np.float32),
            (rng.standard_normal(o) * 0.1).astype(np.float32))


def port_conv_args(x, w, scale, shift, dtype):
    oihw = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(oihw).to(dtype),
            torch.from_numpy(scale), torch.from_numpy(shift))


@pytest.mark.parametrize('act', [None, 'relu'], ids=['none', 'relu'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('shape', list(UNFUSED_SHAPES))
def test_force_pallas_false_matches_the_jax_unfused_op(shape, dtype, act):
    x, w, scale, shift = conv_inputs(UNFUSED_SHAPES[shape], 4)
    tdt, jdt = {'f32': (torch.float32, jnp.float32),
                'bf16': (torch.bfloat16, jnp.bfloat16)}[dtype]
    want = np.asarray(jpc.fused_conv1x1_bn_act(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), scale, shift, act=act,
        force_pallas=False)).astype(np.float32)
    nn_ops.reset_launch_counts()
    got = pallas_conv.fused_conv1x1_bn_act(
        *port_conv_args(x, w, scale, shift, tdt), act=act,
        force_pallas=False)
    assert got.dtype == tdt
    assert set(nn_ops.launch_counts().values()) == {0}
    got = got.float().numpy()
    if dtype == 'f32':
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        big = np.maximum(np.abs(got), np.abs(want))
        ulp = np.ldexp(1.0, np.frexp(big)[1] - 8)
        assert np.all(np.abs(got - want) <= ulp + 1e-6), \
            np.abs(got - want).max()


@pytest.mark.parametrize('act', [None, 'relu'], ids=['none', 'relu'])
def test_force_pallas_false_gradients_match_jax(act):
    x, w, scale, shift = conv_inputs(UNFUSED_SHAPES['c16-o12'], 5)
    g = np.random.default_rng(6).standard_normal((2, 8, 8, 12)).astype(
        np.float32)

    def f(*a):
        return jnp.sum(jpc.fused_conv1x1_bn_act(
            *a, act=act, force_pallas=False) * g)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(x, w, scale, shift)
    leaves = [a.requires_grad_()
              for a in port_conv_args(x, w, scale, shift, torch.float32)]
    (pallas_conv.fused_conv1x1_bn_act(*leaves, act=act, force_pallas=False)
     * torch.from_numpy(g)).sum().backward()
    got = [leaves[0].grad.numpy(),
           leaves[1].grad.numpy().transpose(2, 3, 1, 0),     # OIHW -> HWIO
           leaves[2].grad.numpy(), leaves[3].grad.numpy()]
    for name, gg, ww in zip(('x', 'w', 'scale', 'shift'), got, want):
        np.testing.assert_allclose(gg, np.asarray(ww), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize('force', [None, True])
def test_force_pallas_none_and_true_run_the_kernels_plain_version(force):
    """On the CPU both run the kernel's plain version (the f32 sum, the
    affine on it, one rounding), not the unfused formulation."""
    args = port_conv_args(*conv_inputs(UNFUSED_SHAPES['c64-o24'], 7),
                          torch.bfloat16)
    got = pallas_conv.fused_conv1x1_bn_act(*args, act='relu',
                                           force_pallas=force)
    x, w, scale, shift = args
    want = pallas_conv.fused_conv1x1_bn_act_ref(
        x, w, scale.bfloat16(), shift.bfloat16(), act='relu')
    assert torch.equal(got, want)


def test_force_pallas_takes_only_none_true_or_false():
    args = port_conv_args(*conv_inputs(UNFUSED_SHAPES['c6-o5'], 8),
                          torch.float32)
    with pytest.raises(ValueError, match='force_pallas'):
        pallas_conv.fused_conv1x1_bn_act(*args, force_pallas='yes')
