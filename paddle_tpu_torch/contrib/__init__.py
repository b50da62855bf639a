"""Contributed modules of the port (counterpart of paddle_tpu/contrib/):
``mixed_precision`` (``decorate``, ``AutoMixedPrecisionLists``),
``memory_usage_calc``, ``model_stat``, ``op_frequence``, the high-level
``trainer`` and ``inferencer``, and ``extend_optimizer``
(``extend_with_decoupled_weight_decay``).

Every other public name of the JAX package's contrib is a stand-in that
raises ``NotImplementedError`` naming its ROADMAP item (_not_ported.py):
``slim``, ``quantize`` and ``reader`` (A.11); ``decoder``, ``layers`` and
``extra`` (A.10); ``utils`` (A.9); and the
names the JAX package takes from them."""
from .. import _not_ported
from . import (extend_optimizer, inferencer, memory_usage_calc,
               mixed_precision, model_stat, op_frequence, trainer)
from .extend_optimizer import extend_with_decoupled_weight_decay
from .inferencer import Inferencer
from .memory_usage_calc import (device_memory_stats, memory_usage,
                                print_memory_report)
from .mixed_precision import AutoMixedPrecisionLists, decorate
from .model_stat import summary
from .op_frequence import op_freq_statistic
from .trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,
                      EndEpochEvent, EndStepEvent, Trainer)

# module -> (ROADMAP item, the JAX package's contrib names taken from it:
# (name, is a class))
NOT_PORTED = {
    'slim': ('A.11', [('PostTrainingQuantization', True),
                      ('WeightQuantization', True), ('Compressor', True)]),
    'quantize': ('A.11', [('QuantizeTranspiler', True)]),
    'reader': ('A.11', [('distributed_batch_reader', False)]),
    'extra': ('A.10', [('BasicLSTMUnit', True), ('BasicGRUUnit', True),
                       ('basic_lstm', False), ('basic_gru', False),
                       ('fused_elemwise_activation', False),
                       ('partial_concat', False), ('partial_sum', False),
                       ('shuffle_batch', False), ('tree_conv', False),
                       ('multiclass_nms2', False)]),
    'decoder': ('A.10', [('InitState', True), ('StateCell', True),
                         ('TrainingDecoder', True),
                         ('BeamSearchDecoder', True)]),
    'layers': ('A.10', [('sequence_topk_avg_pooling', False),
                        ('var_conv_2d', False),
                        ('match_matrix_tensor', False),
                        ('fused_embedding_seq_pool', False),
                        ('search_pyramid_hash', False),
                        ('ctr_metric_bundle', False)]),
    'utils': ('A.9', [('HDFSClient', True), ('multi_download', False),
                      ('multi_upload', False),
                      ('convert_dist_to_sparse_program', False),
                      ('load_persistables_for_increment', False),
                      ('load_persistables_for_inference', False)]),
}

def _stand_ins():
    out = {}
    for module, (item, names) in NOT_PORTED.items():
        out[module] = _not_ported.stand_in_module(f'contrib.{module}', item)
        for name, is_class in names:
            make = (_not_ported.stand_in_class if is_class
                    else _not_ported.stand_in)
            out[name] = make(f'contrib.{name}', item)
    return out


globals().update(_stand_ins())

__all__ = ['mixed_precision', 'decorate', 'AutoMixedPrecisionLists',
           'memory_usage_calc', 'memory_usage', 'device_memory_stats',
           'print_memory_report', 'model_stat', 'summary', 'op_frequence',
           'op_freq_statistic', 'trainer', 'Trainer', 'CheckpointConfig',
           'BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent',
           'EndStepEvent', 'inferencer', 'Inferencer', 'extend_optimizer',
           'extend_with_decoupled_weight_decay']
