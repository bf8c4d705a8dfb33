"""The port's host-to-card staging (reporter_tpu_torch/device.py
``host_to_device``) on the CPU: there it is today's copy,
``torch.from_numpy(x).to("cpu")``, the array's own memory, for every
dtype the staging sites hand it. On a card it copies through pinned
memory with ``non_blocking=True``; tests/test_torch_kernels_gpu.py holds
that under sync-debug "error", and chip_smoke.py's [analysis:device] the
five staging sites."""

import numpy as np
import pytest
import torch

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
from reporter_tpu_torch.device import host_to_device


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64, np.int16,
                                   np.int8, np.bool_])
def test_host_to_device_on_the_cpu_is_the_array(dtype):
    x = (np.arange(24) % 3).astype(dtype).reshape(4, 6)
    t = host_to_device(x, "cpu")
    plain = torch.from_numpy(x).to("cpu")
    assert t.dtype == plain.dtype and t.shape == plain.shape
    assert torch.equal(t, plain)
    assert t.data_ptr() == x.ctypes.data       # no copy: the array itself
    assert not t.is_pinned()


def test_host_to_device_takes_a_device_object_and_a_non_contiguous_array():
    x = np.arange(40, dtype=np.float32).reshape(5, 8)[:, ::2]
    t = host_to_device(x, torch.device("cpu"))
    assert torch.equal(t, torch.from_numpy(x))
