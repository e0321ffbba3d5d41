"""Shared inference-layer types."""

from enum import Enum


class Modality(str, Enum):
    """Parity: reference s2_inference/multimodal_model_load.py Modality."""
    TEXT = "language"
    IMAGE = "image"
    VIDEO = "video"
    AUDIO = "audio"


class Device(str, Enum):
    """The reference's device enum {cpu, cuda} (reference enums.Device)."""
    CPU = "cpu"
    CUDA = "cuda"

    @classmethod
    def normalize(cls, device) -> "Device":
        if device is None:
            from marqo_tpu_torch.api import configs
            best = configs.read_env_vars_and_defaults("MARQO_BEST_AVAILABLE_DEVICE")
            return cls.normalize(best) if best else cls.best_available()
        if isinstance(device, cls):
            return device
        d = str(device).lower()
        # "cuda"/"cuda:1", and marqo_tpu's "tpu" and "gpu", name the accelerator
        if d.startswith(("cuda", "gpu", "tpu")):
            return cls.CUDA
        return cls.CPU

    @classmethod
    def best_available(cls) -> "Device":
        """CUDA when PyTorch sees a CUDA device. Without one this raises: a
        host whose CUDA is broken must not serve on the CPU unnoticed.
        Serving on the CPU is asked for by name, with
        MARQO_BEST_AVAILABLE_DEVICE=cpu or a request's device "cpu"."""
        import torch
        if not torch.cuda.is_available():
            from marqo_tpu_torch.core.exceptions import DeviceError
            raise DeviceError(
                "No CUDA device is available to PyTorch. To serve on the CPU "
                "on purpose, set MARQO_BEST_AVAILABLE_DEVICE=cpu")
        return cls.CUDA
