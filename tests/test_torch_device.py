"""marqo_tpu_torch picks its serving device by name, never by falling back.

Startup keeps a MARQO_BEST_AVAILABLE_DEVICE that is already set; otherwise
it serves on CUDA, and without a CUDA device it raises (the JAX package
fell back to the CPU and said so only in a log line). A request's explicit
device "cpu" still works. These tests run on the CPU, so "no CUDA" is the
real state of this host or ``torch.cuda.is_available`` patched to False.
"""

import pytest
import torch

from marqo_tpu_torch.api.app import generate_config, on_start
from marqo_tpu_torch.core.exceptions import DeviceError
from marqo_tpu_torch.inference.types import Device


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MARQO_BEST_AVAILABLE_DEVICE", raising=False)


def test_startup_without_cuda_and_without_the_variable_raises(no_cuda):
    with pytest.raises(DeviceError, match="MARQO_BEST_AVAILABLE_DEVICE=cpu"):
        on_start(generate_config())


def test_best_available_without_cuda_raises(no_cuda):
    with pytest.raises(DeviceError, match="MARQO_BEST_AVAILABLE_DEVICE=cpu"):
        Device.best_available()
    with pytest.raises(DeviceError):
        Device.normalize(None)


def test_best_available_with_cuda_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert Device.best_available() == Device.CUDA


@pytest.mark.parametrize("value,device", [("cpu", Device.CPU),
                                          ("cuda", Device.CUDA)])
def test_a_set_variable_is_kept(no_cuda, monkeypatch, value, device):
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", value)
    assert Device.normalize(None) == device


def test_startup_keeps_an_explicit_cpu(no_cuda, monkeypatch):
    import os
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
    monkeypatch.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
    config = generate_config()
    try:
        on_start(config)
        assert os.environ["MARQO_BEST_AVAILABLE_DEVICE"] == "cpu"
    finally:
        config.index_meta_cache.stop_refresh_thread()


@pytest.mark.parametrize("name", ["cpu", "CPU"])
def test_an_explicit_cpu_request_needs_no_cuda(no_cuda, name):
    assert Device.normalize(name) == Device.CPU
