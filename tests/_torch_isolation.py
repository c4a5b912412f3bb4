"""Test isolation for the port's parity tests.

The JAX package's amp front end (``apex_tpu.amp``) patches ``torch``
functions in place — ``torch.matmul`` and friends cast to half
precision under O1 — and a test that initialises amp may leave its
handle active.  A port test run later in the same worker process would
then compute its plain PyTorch versions in half precision.  Importing
:func:`restore_torch_from_amp` into a test module runs it around every
test of that module: a leftover amp handle is deactivated, which puts
the original ``torch`` functions back.
"""
import sys

import pytest


def _deactivate_amp():
    amp_mod = sys.modules.get("apex_tpu.amp.amp")
    handle = amp_mod.current_handle() if amp_mod is not None else None
    if handle is not None:
        handle._deactivate()


@pytest.fixture(autouse=True)
def restore_torch_from_amp():
    _deactivate_amp()
    yield
