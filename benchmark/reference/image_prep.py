"""open_clip's image preprocessing, plainly: decode, apply the EXIF
orientation, convert to RGB, resize the shorter side to ``size`` with
bicubic resampling (torchvision's ``Resize(size)`` on a PIL image: the
longer side becomes int(size x long / short)), take the centre ``size``
square (torchvision's ``CenterCrop``: offsets rounded), scale to [0, 1] and
normalise by CLIP's mean and standard deviation.
"""

import io

import numpy as np
import torch
from PIL import Image, ImageOps

from reference.clip import MEAN, STD


def pixels(data: bytes, size: int) -> torch.Tensor:
    """JPEG bytes -> (3, size, size) float32."""
    img = ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB")
    w, h = img.size
    if w <= h:
        new = (size, int(size * h / w))
    else:
        new = (int(size * w / h), size)
    img = img.resize(new, Image.BICUBIC)
    left = int(round((new[0] - size) / 2.0))
    top = int(round((new[1] - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    x = torch.from_numpy(np.asarray(img, dtype=np.float32) / 255.0)
    x = (x - torch.tensor(MEAN)) / torch.tensor(STD)
    return x.permute(2, 0, 1).contiguous()
