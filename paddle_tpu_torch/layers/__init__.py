"""fluid.layers of the port (counterpart of paddle_tpu/layers/): the layer
functions of nn.py, tensor.py, loss.py, io.py, control_flow.py, rnn.py,
sequence_lod.py and learning_rate_scheduler.py, ``accuracy``, and the
Variable operators of math_op_patch.py (applied at import, as in the JAX
package).

Every public name of the JAX package's ``layers`` exists here: 183 of its
340 callables run. Those the port does not run yet are callables that
raise ``NotImplementedError`` naming their ROADMAP item, 120 from the one
table :data:`NOT_PORTED` (A.11 the readers and host callbacks, A.10 the
sequence/LoD, detection and distribution layers and the layers over ops
the port has not registered) and 37 generated layers over such ops
(layers/nn.py). A generated layer that runs takes its attributes by
position after its input slots, in Paddle's documented order
(layers/nn.py ``_POSITIONAL``). The modules ``detection`` and ``distributions`` raise the
same way on any attribute, ``sequence_lod`` on any but
``sequence_mask``."""
import functools
import types
import warnings

from . import (common, control_flow, io, learning_rate_scheduler, loss,
               math_op_patch, nn, sequence_lod, tensor, utils)
from .common import apply_op_layer as _apply
from .common import generate_layer_fn
from .common import generate_layer_fn as generate_activation_fn
from .control_flow import *  # noqa: F401,F403
from .io import data, fluid_data
from .learning_rate_scheduler import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .math_op_patch import monkey_patch_variable
from .nn import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403  (the rnn() function over the module)
from .sequence_lod import sequence_mask
from .tensor import *  # noqa: F401,F403
from .utils import (assert_same_structure, convert_to_list, is_sequence,
                    map_structure, pack_sequence_as)

monkey_patch_variable()


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-``k`` accuracy of ``input`` against ``label``: the first output
    of the accuracy op."""
    return _apply('accuracy', {'pred': input, 'label': label}, {'k': k})[0]


def autodoc(comment=''):
    """Append ``comment`` to the decorated function's docstring."""
    def deco(fn):
        fn.__doc__ = (fn.__doc__ or '') + comment
        return fn
    return deco


def templatedoc(op_type=None):
    """A docstring passthrough (there are no op protos to template)."""
    def deco(fn):
        return fn
    return deco


def deprecated(since='', instead='', extra_message=''):
    """A decorator whose function warns ``DeprecationWarning`` on call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            warnings.warn(
                f'{fn.__name__} is deprecated'
                + (f' since {since}' if since else '')
                + (f'; use {instead}' if instead else '')
                + (f'. {extra_message}' if extra_message else ''),
                DeprecationWarning, stacklevel=2)
            return fn(*a, **k)
        return wrapped
    return deco


_WHY = {
    'A.10': ('the sequence/LoD, detection and distribution layers and the '
             'layers over ops the port has not registered'),
    'A.11': 'the readers and host callbacks',
}

# name -> ROADMAP item, for every public name of the JAX package's layers
# that the port does not run yet
NOT_PORTED = dict.fromkeys([
    'py_reader', 'double_buffer', 'read_file', 'create_py_reader_by_data',
    'py_func', 'Print', 'load',
], 'A.11')
NOT_PORTED.update(dict.fromkeys([
    # the LoD recurrent layers
    'dynamic_gru', 'dynamic_lstm', 'dynamic_lstmp', 'lstm_unit',
    # distributions
    'Categorical', 'MultivariateNormalDiag', 'Normal', 'Uniform',
    # detection
    'anchor_generator', 'bipartite_match', 'box_clip', 'box_coder',
    'box_decoder_and_assign', 'collect_fpn_proposals', 'density_prior_box',
    'detection_map', 'detection_output', 'distribute_fpn_proposals',
    'generate_mask_labels', 'generate_proposal_labels', 'generate_proposals',
    'iou_similarity', 'locality_aware_nms', 'multi_box_head',
    'multiclass_nms', 'polygon_box_transform', 'prior_box',
    'retinanet_detection_output', 'retinanet_target_assign',
    'roi_perspective_transform', 'rpn_target_assign', 'sigmoid_focal_loss',
    'ssd_loss', 'target_assign', 'yolo_box', 'yolov3_loss',
    # sequences and LoD
    'sequence_concat', 'sequence_conv', 'sequence_enumerate',
    'sequence_expand', 'sequence_expand_as', 'sequence_first_step',
    'sequence_last_step', 'sequence_pad', 'sequence_pool',
    'sequence_reshape', 'sequence_reverse', 'sequence_scatter',
    'sequence_slice', 'sequence_softmax', 'sequence_unpad', 'lod_append',
    'lod_rank_table', 'lod_reset', 'reorder_lod_tensor_by_rank',
    'im2sequence', 'row_conv', 'linear_chain_crf', 'crf_decoding',
    'chunk_eval', 'ctc_greedy_decoder', 'edit_distance', 'warpctc',
    # layers over ops not registered in the port
    'adaptive_pool2d', 'adaptive_pool3d', 'affine_grid', 'auc',
    'bpr_loss', 'center_loss', 'continuous_value_model', 'crop',
    'crop_tensor', 'data_norm', 'deformable_conv',
    'deformable_roi_pooling', 'diag', 'dice_loss', 'eye', 'filter_by_instag',
    'get_tensor_from_selected_rows', 'hash', 'hsigmoid',
    'huber_loss', 'image_resize', 'image_resize_short', 'instance_norm',
    'kldiv_loss', 'l2_normalize', 'linspace', 'lrn', 'margin_rank_loss',
    'merge_selected_rows', 'multiplex', 'npair_loss', 'pool3d',
    'prroi_pool', 'psroi_pool', 'rank', 'rank_loss',
    'resize_bilinear', 'resize_nearest', 'resize_trilinear', 'roi_align',
    'roi_pool', 'sampled_softmax_with_cross_entropy',
    'scatter_nd', 'shape', 'similarity_focus', 'size', 'smooth_l1',
    'teacher_student_sigmoid_loss', 'unique', 'unique_with_counts',
], 'A.10'))


def _not_ported(name, item):
    def layer(*args, **kwargs):
        raise NotImplementedError(
            f'layers.{name} is not ported yet: ROADMAP {item}, '
            f'{_WHY[item]}')
    layer.__name__ = layer.__qualname__ = name
    layer.__doc__ = f'Not ported yet (ROADMAP {item}): raises.'
    return layer


def _not_ported_module(name):
    mod = types.ModuleType(f'{__name__}.{name}',
                           f'layers.{name}: not ported yet (ROADMAP A.10)')

    def getattr_(attr):
        if attr.startswith('__'):
            raise AttributeError(attr)
        raise NotImplementedError(f'layers.{name}.{attr} is not ported yet '
                                  f'(ROADMAP A.10)')
    mod.__getattr__ = getattr_
    return mod


# the names the JAX package's layers/control_flow.py exports and the port
# does not run: they are set on the port's control_flow module too
_IN_CONTROL_FLOW = ('Print', 'lod_rank_table', 'reorder_lod_tensor_by_rank')

for _name, _item in NOT_PORTED.items():
    globals()[_name] = _not_ported(_name, _item)
    if _name in _IN_CONTROL_FLOW:
        setattr(control_flow, _name, globals()[_name])
detection = _not_ported_module('detection')
distributions = _not_ported_module('distributions')
del _name, _item
