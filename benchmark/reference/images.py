"""Product-photo stand-ins made from the seed: JPEG bytes (quality 90),
640 to 1024 pixels on the long side and 480 to 768 on the short, in both
orientations. Each is a smooth field of colour (a 16 x 12 grid of random
colours, bicubically enlarged) with a few shapes on it, so that it has
edges and gradients as a photograph does, and compresses as one.
"""

import io

import numpy as np
from PIL import Image, ImageDraw


def jpeg(seed: int, index: int) -> bytes:
    rng = np.random.default_rng([seed, 0x6a7067, index])
    long_side = int(rng.integers(640, 1025))
    short_side = int(rng.integers(480, min(768, long_side) + 1))
    size = (long_side, short_side) if rng.random() < 0.5 else \
        (short_side, long_side)
    grid = rng.integers(0, 256, size=(12, 16, 3), dtype=np.uint8)
    img = Image.fromarray(grid).resize(size, Image.BICUBIC)
    draw = ImageDraw.Draw(img)
    for _ in range(int(rng.integers(3, 9))):
        x0, x1 = sorted(rng.integers(0, size[0], size=2).tolist())
        y0, y1 = sorted(rng.integers(0, size[1], size=2).tolist())
        color = tuple(int(c) for c in rng.integers(0, 256, size=3))
        if rng.random() < 0.5:
            draw.rectangle((x0, y0, x1, y1), fill=color)
        else:
            draw.ellipse((x0, y0, x1, y1), fill=color)
    out = io.BytesIO()
    img.save(out, format="JPEG", quality=90)
    return out.getvalue()
