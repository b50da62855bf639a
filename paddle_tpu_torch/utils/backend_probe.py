"""Bounded CUDA start-up (counterpart of paddle_tpu/utils/backend_probe.py).

The first touch of the card (``torch.cuda.init()``) can hang on a wedged
card. ``probe_backend`` bounds it:

- ``isolated=True`` (the default): a child process initialises CUDA first,
  under the timeout; only once it has answered does this process
  initialise, in-process under a watchdog thread. A hang or a failure in
  the child leaves this process untouched.
- ``isolated=False``: the in-process watchdog only (one initialisation;
  after a hang the process's CUDA state is unusable, so exit).

Either raises ``BackendInitTimeout`` on a hang and ``BackendInitError`` on a
fast failure, a missing card included. The port never carries on on the
CPU instead: a run meant for the card stops."""
from __future__ import annotations

import os
import subprocess
import sys
import threading

__all__ = ['probe_backend', 'BackendInitTimeout', 'BackendInitError',
           'DEFAULT_TIMEOUT_ENV']

DEFAULT_TIMEOUT_ENV = 'PADDLE_TPU_BACKEND_TIMEOUT'
# the child spends part of its time on interpreter start-up and the torch
# import; it is granted apart, so the timeout stays the card's time to
# answer
_CHILD_STARTUP_GRACE_S = 30.0

_CHILD = """
import torch
if not torch.cuda.is_available():
    raise SystemExit('no CUDA device is available')
torch.cuda.init()
print('PROBE_OK', 'cuda', torch.cuda.device_count(), flush=True)
"""


class BackendInitTimeout(RuntimeError):
    """CUDA start-up did not answer within the timeout. ``parent_clean``:
    whether this process is untouched (the child hung), or hung itself."""

    def __init__(self, msg, parent_clean=False):
        super().__init__(msg)
        self.parent_clean = parent_clean


class BackendInitError(RuntimeError):
    """CUDA start-up failed fast (no card, a CUDA error). ``parent_clean``
    as on :class:`BackendInitTimeout`."""

    def __init__(self, msg, parent_clean=True):
        super().__init__(msg)
        self.parent_clean = parent_clean


def _timeout_msg(timeout):
    return (f'CUDA start-up did not answer within {timeout:.0f}s '
            f'(CUDA_VISIBLE_DEVICES='
            f'{os.environ.get("CUDA_VISIBLE_DEVICES", "")!r}); the card does '
            f'not respond')


def _init_in_process(timeout):
    """Initialise CUDA under a daemon watchdog thread: (devices, 'cuda')."""
    probe = {}

    def touch():
        try:
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError('no CUDA device is available')
            torch.cuda.init()
            probe['devices'] = [torch.device('cuda', i)
                                for i in range(torch.cuda.device_count())]
        except BaseException as e:  # handed to the caller's thread
            probe['error'] = e

    t = threading.Thread(target=touch, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise BackendInitTimeout(_timeout_msg(timeout), parent_clean=False)
    if 'error' in probe:
        e = probe['error']
        raise BackendInitError(
            f'CUDA start-up failed: {type(e).__name__}: {e}',
            parent_clean=False) from e
    return probe['devices'], 'cuda'


def probe_backend(timeout=None, isolated=True):
    """(devices, 'cuda') with CUDA initialised in this process, or raise
    :class:`BackendInitTimeout` / :class:`BackendInitError` (module
    docstring). ``timeout`` defaults to $PADDLE_TPU_BACKEND_TIMEOUT or 120
    seconds."""
    if timeout is None:
        timeout = float(os.environ.get(DEFAULT_TIMEOUT_ENV, '120'))
    if not isolated:
        return _init_in_process(timeout)
    try:
        out = subprocess.run([sys.executable, '-c', _CHILD],
                             capture_output=True, text=True,
                             timeout=timeout + _CHILD_STARTUP_GRACE_S)
    except subprocess.TimeoutExpired:
        raise BackendInitTimeout(_timeout_msg(timeout), parent_clean=True)
    if out.returncode != 0 or 'PROBE_OK' not in out.stdout:
        detail = (out.stderr or out.stdout).strip()
        raise BackendInitError(
            f'CUDA start-up failed in the probe process '
            f'(rc={out.returncode}); its output ends:\n{detail[-2000:]}',
            parent_clean=True)
    return _init_in_process(timeout)
