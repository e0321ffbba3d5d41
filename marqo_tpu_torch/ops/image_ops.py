"""Image preprocessing for CLIP-family vision towers, in PyTorch (port of
marqo_tpu/ops/image_ops.py).

Decode and EXIF orientation run once on the host (PIL, ``host_decode``)
and give a uint8 RGB array. Resize, center crop and normalize below are
tensor ops on whatever device the image lies on. The CLIP serve path does
not use them: it resizes on the host with PIL and normalizes inside the
vision tower (models/clip.py).

Resize parity: ``jax.image.resize(..., "bicubic", antialias=True)`` is the
Keys cubic (a = -0.5) with antialiasing, which is what
``F.interpolate(..., mode="bicubic", antialias=True, align_corners=False)``
computes; torch's bicubic without antialias uses a = -0.75 and differs.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# OpenAI CLIP normalization constants (also used by open_clip defaults)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_shorter_side(image: torch.Tensor, target: int) -> torch.Tensor:
    """Resize a float (H, W, C) image so the shorter side equals ``target``
    (aspect preserved)."""
    h, w = image.shape[0], image.shape[1]
    if h <= w:
        new_h, new_w = target, max(1, int(round(w * target / h)))
    else:
        new_h, new_w = max(1, int(round(h * target / w))), target
    resized = F.interpolate(image.permute(2, 0, 1)[None], size=(new_h, new_w),
                            mode="bicubic", antialias=True,
                            align_corners=False)
    return resized[0].permute(1, 2, 0)


def center_crop(image: torch.Tensor, size: int) -> torch.Tensor:
    h, w = image.shape[0], image.shape[1]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return image[top:top + size, left:left + size, :]


def normalize(image_f32: torch.Tensor,
              mean: Tuple[float, ...] = CLIP_MEAN,
              std: Tuple[float, ...] = CLIP_STD) -> torch.Tensor:
    mean_t = torch.tensor(mean, dtype=image_f32.dtype, device=image_f32.device)
    std_t = torch.tensor(std, dtype=image_f32.dtype, device=image_f32.device)
    return (image_f32 - mean_t) / std_t


def preprocess_image(image_u8: torch.Tensor, image_size: int,
                     mean: Tuple[float, ...] = CLIP_MEAN,
                     std: Tuple[float, ...] = CLIP_STD) -> torch.Tensor:
    """uint8 (H, W, 3) → normalized float32 (size, size, 3)."""
    x = image_u8.float() / 255.0
    x = resize_shorter_side(x, image_size)
    x = center_crop(x, image_size)
    return normalize(x, mean, std)


def preprocess_batch(images_u8: torch.Tensor, image_size: int,
                     mean: Tuple[float, ...] = CLIP_MEAN,
                     std: Tuple[float, ...] = CLIP_STD) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, size, size, 3) normalized float32."""
    return torch.stack([preprocess_image(im, image_size, mean, std)
                        for im in images_u8])


def host_decode(content) -> np.ndarray:
    """Host-side decode + EXIF orientation → uint8 RGB ndarray.

    Accepts PIL images, file paths, raw bytes, or ndarrays (parity:
    reference clip_utils.py:130-218 format handling; network download lives
    in tensor_search/add_docs.py)."""
    from PIL import Image, ImageOps
    import io

    if isinstance(content, np.ndarray):
        if content.dtype != np.uint8:
            raise ValueError("ndarray images must be uint8 RGB")
        return content
    if isinstance(content, bytes):
        img = Image.open(io.BytesIO(content))
    elif isinstance(content, str):
        img = Image.open(content)
    elif isinstance(content, Image.Image):
        img = content
    else:
        raise ValueError(f"Unsupported image content type {type(content)}")
    img = ImageOps.exif_transpose(img)
    return np.asarray(img.convert("RGB"), dtype=np.uint8)
