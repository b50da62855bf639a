"""``paddle.utils`` (counterpart of paddle_tpu/utils/): the training-curve
``Ploter``, the configuration dump and the bounded CUDA start-up probe
(``backend_probe``)."""
from .dump_config import dump_config
from .plot import PlotData, Ploter

__all__ = ['Ploter', 'PlotData', 'dump_config']
