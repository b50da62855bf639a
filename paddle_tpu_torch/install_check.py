"""``fluid.install_check`` (counterpart of paddle_tpu/install_check.py):
``run_check()`` trains a small linear model one step on the card, end to
end, and raises on a failure."""
from .debugging import install_check as _install_check

__all__ = ['run_check']


def run_check(place=None):
    """Raise on a failure, log success. ``place`` is the port's addition:
    the card if None (which raises without one), else e.g. ``CPUPlace()``."""
    _install_check(place)
