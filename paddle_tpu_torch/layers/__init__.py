"""fluid.layers of the port (counterpart of paddle_tpu/layers/): the layer
functions of nn.py, tensor.py, loss.py and io.py, and ``accuracy``."""
from . import common, io, loss, nn, tensor, utils
from .common import apply_op_layer as _apply
from .common import generate_layer_fn
from .io import data, fluid_data
from .loss import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .utils import (assert_same_structure, convert_to_list, is_sequence,
                    map_structure, pack_sequence_as)


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-``k`` accuracy of ``input`` against ``label``: the first output
    of the accuracy op."""
    return _apply('accuracy', {'pred': input, 'label': label}, {'k': k})[0]
