"""The JAX package's global seed pinned for a port parity test.

The JAX package's startup programs draw from
``paddle_tpu.core.random.default_generator``, a global of the process
that several of its own test files seed and leave seeded. Under xdist's
``--dist loadfile`` the files a worker ran before decide the startup
values a parity test sees. A parity test file imports
:func:`jax_seed_pinned` (autouse), so each of its tests starts from seed
0 alone and in the suite, and leaves the seed as it found it."""
import pytest


@pytest.fixture(autouse=True)
def jax_seed_pinned():
    from paddle_tpu import framework
    from paddle_tpu.core import random
    state, seed = random.default_generator.state(), framework.get_global_seed()
    random.seed(0)
    yield
    random.default_generator.set_state(state)
    framework.manual_seed(seed)
