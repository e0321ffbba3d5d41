"""Image patching ("patch models"): split images into sub-image chunks.

Parity: reference src/marqo/s2_inference/processing/image.py:46 chunk_image
and its patcher classes:
  simple / overlap — grid boxes (PatchifySimple, image.py:120-151)
  dino-v1 / dino-v2 — DINO ViT CLS-attention maps → Otsu threshold →
      contour boxes (PatchifyViT image.py:314-377, DINO_utils.py:87-173);
      v1 averages |attention| over heads, v2 keeps per-head positive maps
  marqo-yolo / yolox — YOLOX-S objectness boxes (PatchifyYolox
      image.py:411-445, yolox_utils.py)
  frcnn — torchvision Faster R-CNN proposals (PatchifyPytorch)
All model-based methods share the reference's box pipeline
(PatchifyModel.process, image.py:294-311): filter by area/aspect →
replace tiny boxes with centered 100×100 → clip → class-agnostic NMS
(iou 0.6) → top-10 → prepend the full image.

Device shape: detectors are PyTorch modules (models/dino_vit.py,
models/yolox.py, models/frcnn.py) on the serving device
(Device.normalize(None)), one image per call and one copy back to the host
per image, with the box pipeline in numpy on the host; on CUDA each
patcher replays one CUDA graph of its model (inference/graphs.py): DINO's
attention map, YOLOX's outputs, Faster R-CNN's level outputs in one
tensor, captured at its first image. Real detector
weights are hub-gated offline (like the reference's torch-hub/onnx
downloads); MARQO_PATCH_MODELS_RANDOM_INIT=TRUE runs deterministic
random-init detectors (weights drawn from a torch.Generator seeded from
the method's name) so the full path is testable. Each patch becomes one
chunk+vector; the bounding-box string is the stored chunk.
"""

import hashlib
import threading
from typing import List, Tuple

import numpy as np

from marqo_tpu_torch.core.exceptions import InvalidArgumentError, ModelLoadError

WORK_SIZE = (240, 240)      # reference get_default_size()
MIN_AREA = 60 * 60          # reference PatchifyModel min_area
MAX_ASPECT = 4.0            # reference filter_boxes max_aspect_ratio
REPLACE_SIZE = (100, 100)   # reference PatchifyModel new_size
IOU_THRESH = 0.6
TOP_K = 10
TOP_K_SCORES = 100

_patchers = {}
_patchers_lock = threading.Lock()


def _random_init_enabled() -> bool:
    from marqo_tpu_torch.api import configs
    return str(configs.read_env_vars_and_defaults(
        "MARQO_PATCH_MODELS_RANDOM_INIT") or "").upper() == "TRUE"


# --- box pipeline (numpy ports of reference image_utils.py) -------------------

def _filter_boxes(boxes: List, min_area: float = MIN_AREA,
                  max_aspect: float = MAX_ASPECT) -> List[int]:
    inds = []
    for ind, bb in enumerate(boxes):
        w, h = bb[2] - bb[0], bb[3] - bb[1]
        if w <= 0 or h <= 0:
            continue
        if w * h > min_area and max(w, h) / min(w, h) < max_aspect:
            inds.append(ind)
    return inds


def _replace_small_boxes(boxes: List, min_area: float = MIN_AREA,
                         new_size: Tuple = REPLACE_SIZE) -> List[Tuple]:
    out = []
    for box in boxes:
        if (box[2] - box[0]) * (box[3] - box[1]) < min_area:
            xc = (box[2] - box[0]) / 2 + box[0]
            yc = (box[3] - box[1]) / 2 + box[1]
            box = (xc - new_size[0] / 2, yc - new_size[1] / 2,
                   xc + new_size[0] / 2, yc + new_size[1] / 2)
        out.append(box)
    return out


def _clip_boxes(boxes: List, xmax: float, ymax: float) -> List[Tuple]:
    return [(max(0.0, b[0]), max(0.0, b[1]),
             min(float(xmax), b[2]), min(float(ymax), b[3])) for b in boxes]


def _nms(boxes: List, scores: List, iou_thresh: float = IOU_THRESH
         ) -> List[int]:
    """Class-agnostic NMS (torchvision.ops.nms semantics)."""
    if not boxes:
        return []
    arr = np.asarray(boxes, dtype=np.float32)
    scr = np.asarray(scores, dtype=np.float32).reshape(-1)
    x1, y1, x2, y2 = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    areas = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
    order = scr.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-9)
        order = order[1:][iou <= iou_thresh]
    return keep


def _rescale_box(box, from_size, to_size):
    sx = to_size[0] / from_size[0]
    sy = to_size[1] / from_size[1]
    return (box[0] * sx, box[1] * sy, box[2] * sx, box[3] * sy)


def _process_boxes(boxes: List, scores: List, work_size: Tuple
                   ) -> List[Tuple]:
    """The reference PatchifyModel.process ordering (image.py:294-303)."""
    inds = _filter_boxes(boxes)
    boxes = [boxes[i] for i in inds]
    if len(scores) and len(inds) <= len(scores):
        scores = [scores[i] for i in inds]
    boxes = _replace_small_boxes(boxes)
    boxes = _clip_boxes(boxes, work_size[0], work_size[1])
    if len(boxes) > 1 and len(scores) == len(boxes):
        keep = _nms(boxes, scores)
        boxes = [boxes[i] for i in keep]
    return boxes[:TOP_K]


# --- grid methods --------------------------------------------------------------

def _grid_boxes(width: int, height: int, hn: int = 3, wn: int = 3,
                overlap: bool = False) -> List[Tuple[int, int, int, int]]:
    """hn×wn grid (reference PatchifySimple defaults 3×3, configurable via
    the method url's hn/wn params) plus the full image; with ``overlap``,
    half-stride shifted boxes are added."""
    boxes = [(0, 0, width, height)]
    cell_w, cell_h = width / wn, height / hn
    for i in range(hn):
        for j in range(wn):
            boxes.append((int(j * cell_w), int(i * cell_h),
                          int((j + 1) * cell_w), int((i + 1) * cell_h)))
    if overlap:
        for i in range(hn - 1):
            for j in range(wn - 1):
                boxes.append((int((j + 0.5) * cell_w), int((i + 0.5) * cell_h),
                              int((j + 1.5) * cell_w), int((i + 1.5) * cell_h)))
    seen = set()
    out = []
    for b in boxes:
        if b not in seen:
            seen.add(b)
            out.append(b)
    return out


def _serving_device():
    """The serving device (Device.normalize(None)) as a torch.device."""
    import torch

    from marqo_tpu_torch.inference.types import Device
    return torch.device("cuda" if Device.normalize(None) == Device.CUDA
                        else "cpu")


def _seeded_generator(name: bytes, device):
    """A torch.Generator on ``device`` seeded from ``name``'s sha256."""
    import torch
    seed = int.from_bytes(hashlib.sha256(name).digest()[:4], "little")
    return torch.Generator(device=device).manual_seed(seed)


# --- DINO attention patcher ----------------------------------------------------

class _DinoPatcher:
    """dino-v1/dino-v2 (reference PatchifyViT): last-block CLS attention →
    pixel-space maps → Otsu threshold → contour boxes, scored by area."""

    def __init__(self, attention_method: str):
        import torch

        from marqo_tpu_torch.inference.graphs import EncoderGraphs
        from marqo_tpu_torch.models.dino_vit import DinoViTConfig, init_params
        self.method = attention_method  # 'abs' (v1) | 'pos' (v2)
        self.config = DinoViTConfig.vit_small(patch_size=16)
        self.device = _serving_device()
        if _random_init_enabled():
            self.model = init_params(
                self.config, _seeded_generator(b"dino", self.device),
                dtype=torch.bfloat16, device=self.device)
        else:
            self.model = self._load_real_weights()
        # this patcher's own graphs and lock: v1 and v2 hold a model each
        self.graphs = EncoderGraphs(self.device)

    def _load_real_weights(self):
        import os

        from marqo_tpu_torch.api import configs
        from marqo_tpu_torch.models.dino_vit import model_from_dino_state_dict
        path = configs.read_env_vars_and_defaults("MARQO_DINO_WEIGHTS_PATH")
        if path and os.path.exists(str(path)):
            import torch
            state = torch.load(str(path), map_location="cpu")
            return model_from_dino_state_dict(state, self.config,
                                              dtype=torch.bfloat16,
                                              device=self.device)
        raise ModelLoadError(
            "DINO patch models need their checkpoint on disk: set "
            "MARQO_DINO_WEIGHTS_PATH to a facebookresearch/dino "
            "dino_vits16 state dict (torch hub has no egress in this "
            "deployment), or set MARQO_PATCH_MODELS_RANDOM_INIT=TRUE for "
            "a synthetic-weight smoke mode.")

    def attention(self, pixels: np.ndarray):
        """(1, size, size, 3) uint8 → the last block's CLS attention maps,
        (1, heads, n_side, n_side) fp32 on the device: on CUDA the replay
        of this patcher's graph, captured at its first image."""
        import torch

        from marqo_tpu_torch.inference import batching
        model = self.model
        graphs = batching.card_graphs(self.graphs)
        if graphs is None:
            with torch.inference_mode():
                return model.last_selfattention(
                    torch.from_numpy(pixels).to(self.device))
        return graphs.run("dino", model.patch_embedding.dtype,
                          model.last_selfattention, pixels,
                          static=(model.config,))

    def boxes(self, image: np.ndarray) -> Tuple[List[Tuple], List[float]]:
        import cv2
        size = self.config.image_size
        resized = cv2.resize(image, (size, size),
                             interpolation=cv2.INTER_LINEAR)
        attn = self.attention(resized[None]).cpu().numpy()[0]
        # upsample patch grid → pixels (reference: nearest, scale=patch)
        maps = np.repeat(np.repeat(attn, self.config.patch_size, axis=1),
                         self.config.patch_size, axis=2)
        if self.method == "abs":      # dino-v1 (image.py:352-355)
            maps = np.abs(maps).mean(0)[None]
        else:                          # dino-v2: positive parts per head
            maps = np.where(maps < 0, 0, maps)
        boxes: List[Tuple] = []
        for attention in maps:
            boxes += self._attention_to_bboxes(attention)
        # no detector scores: area ranks boxes (reference _calc_scores_bb)
        scores = [(b[2] - b[0]) * (b[3] - b[1]) for b in boxes]
        if len(scores) > TOP_K_SCORES:
            order = np.argsort(scores)[::-1][:TOP_K_SCORES]
            boxes = [boxes[i] for i in order]
            scores = [scores[i] for i in order]
        work = (size, size)
        return [_rescale_box(b, work, WORK_SIZE) for b in boxes], scores

    @staticmethod
    def _attention_to_bboxes(attention: np.ndarray) -> List[Tuple]:
        """Otsu threshold + external contours (reference
        DINO_utils.py:146-173 attention_to_bboxs)."""
        import cv2
        peak = float(attention.max())
        if peak <= 0:
            return []
        gray = (attention / peak * 255.0).astype(np.uint8)
        _, thresh = cv2.threshold(gray, 0, 255,
                                  cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        cnts = cv2.findContours(thresh, cv2.RETR_EXTERNAL,
                                cv2.CHAIN_APPROX_SIMPLE)
        cnts = cnts[0] if len(cnts) == 2 else cnts[1]
        boxes = []
        for contour in cnts:
            x, y, w, h = cv2.boundingRect(contour)
            boxes.append((x, y, x + w, y + h))
        return boxes


# --- YOLOX patcher ---------------------------------------------------------------

class _YoloxPatcher:
    """marqo-yolo / yolox (reference PatchifyYolox): letterboxed 384² input,
    objectness-scored boxes decoded exactly like demo_postprocess."""

    def __init__(self):
        from marqo_tpu_torch.inference.graphs import EncoderGraphs
        from marqo_tpu_torch.models.yolox import YoloxConfig, init_params
        self.config = YoloxConfig()
        self.device = _serving_device()
        if _random_init_enabled():
            self.model = init_params(self.config,
                                     _seeded_generator(b"yolox", self.device),
                                     device=self.device)
        else:
            raise ModelLoadError(
                "marqo-yolo/yolox patch models need converted weights: the "
                "reference ships Marqo/marqo-yolo-v2 yolox_s.onnx, which "
                "cannot be downloaded in this deployment. Set "
                "MARQO_PATCH_MODELS_RANDOM_INIT=TRUE for a synthetic-weight "
                "smoke mode.")
        self.graphs = EncoderGraphs(self.device)

    def outputs(self, pixels: np.ndarray):
        """(1, size, size, 3) fp32 letterboxed BGR → (1, N, 85) fp32 on
        the device: on CUDA the replay of this patcher's graph, captured
        at its first image. The capture is of the model itself, whose
        forward turns cuDNN's TF32 off: a capture of its body alone would
        keep TF32 plans in every replay."""
        import torch

        from marqo_tpu_torch.inference import batching
        model = self.model
        graphs = batching.card_graphs(self.graphs)
        if graphs is None:
            with torch.inference_mode():
                return model(torch.from_numpy(pixels).to(self.device))
        return graphs.run("yolox", model.backbone.stem.conv.w.dtype, model,
                          pixels, static=(self.config,))

    def boxes(self, image: np.ndarray) -> Tuple[List[Tuple], List[float]]:
        import cv2

        from marqo_tpu_torch.models.yolox import decode_outputs
        size = self.config.input_size
        work = cv2.resize(image, WORK_SIZE,
                          interpolation=cv2.INTER_LINEAR)[..., ::-1]  # BGR
        # letterbox (reference preprocess_yolox: pad value 114)
        ratio = min(size / work.shape[0], size / work.shape[1])
        resized = cv2.resize(work, (int(work.shape[1] * ratio),
                                    int(work.shape[0] * ratio)),
                             interpolation=cv2.INTER_LINEAR)
        # a batch of one with a real batch stride (``[None]`` gives it
        # stride 0, and the CPU's convolutions then round otherwise)
        padded = np.full((1, size, size, 3), 114, dtype=np.float32)
        padded[0, :resized.shape[0], :resized.shape[1]] = resized
        outputs = self.outputs(padded).cpu().numpy()
        preds = decode_outputs(outputs, (size, size))[0]
        boxes_cxcywh = preds[:, :4]
        scores = preds[:, 4:5]
        boxes = np.empty_like(boxes_cxcywh)
        boxes[:, 0] = boxes_cxcywh[:, 0] - boxes_cxcywh[:, 2] / 2
        boxes[:, 1] = boxes_cxcywh[:, 1] - boxes_cxcywh[:, 3] / 2
        boxes[:, 2] = boxes_cxcywh[:, 0] + boxes_cxcywh[:, 2] / 2
        boxes[:, 3] = boxes_cxcywh[:, 1] + boxes_cxcywh[:, 3] / 2
        boxes /= ratio
        flat_scores = scores.reshape(-1)
        if flat_scores.size > TOP_K_SCORES:
            order = np.argsort(flat_scores)[::-1][:TOP_K_SCORES]
            boxes = boxes[order]
            flat_scores = flat_scores[order]
        return [tuple(map(float, b)) for b in boxes], \
            [float(s) for s in flat_scores]


class _FrcnnPatcher:
    """frcnn (reference PatchifyPytorch over torchvision
    fasterrcnn_resnet50_fpn): class-agnostic region proposals from the
    Faster R-CNN proposal stage (models/frcnn.py), ranked by RPN
    objectness. Scale: tests use a width-reduced backbone
    (MARQO_FRCNN_WIDTH) since resnet-50 at 384² is slow on a 1-core CPU."""

    def __init__(self):
        from marqo_tpu_torch.api import configs
        from marqo_tpu_torch.inference.graphs import EncoderGraphs
        from marqo_tpu_torch.models.frcnn import FrcnnConfig, init_params
        width = float(configs.read_env_vars_and_defaults(
            "MARQO_FRCNN_WIDTH") or 1.0)
        self.config = FrcnnConfig(width=width)
        self.device = _serving_device()
        if _random_init_enabled():
            self.model = init_params(self.config,
                                     _seeded_generator(b"frcnn", self.device),
                                     device=self.device)
        else:
            raise ModelLoadError(
                "frcnn patching needs torchvision fasterrcnn_resnet50_fpn "
                "weights, which cannot be downloaded in this deployment "
                "(torchvision absent, no egress). Set "
                "MARQO_PATCH_MODELS_RANDOM_INIT=TRUE for a synthetic-weight "
                "smoke mode, or use marqo-yolo / dino-v1 / dino-v2.")
        self.graphs = EncoderGraphs(self.device)

    def levels(self, pixels: np.ndarray):
        """(1, size, size, 3) fp32 normalized → the ten level outputs
        (each level's objectness, then its deltas, P2..P6) flattened into
        one fp32 tensor on the device: on CUDA the replay of this patcher's
        graph, captured at its first image, through the model's forward,
        which turns cuDNN's TF32 off."""
        import torch

        from marqo_tpu_torch.inference import batching
        from marqo_tpu_torch.models.frcnn import flatten_levels
        model = self.model

        def flat(x):
            return flatten_levels(model(x))

        graphs = batching.card_graphs(self.graphs)
        if graphs is None:
            with torch.inference_mode():
                return flat(torch.from_numpy(pixels).to(self.device))
        return graphs.run("frcnn", model.rpn.conv.w.dtype, flat, pixels,
                          static=(self.config,))

    def boxes(self, image: np.ndarray) -> Tuple[List[Tuple], List[float]]:
        import cv2

        from marqo_tpu_torch.models.frcnn import (IMAGENET_MEAN, IMAGENET_STD,
                                                  decode_proposals,
                                                  split_levels)
        size = self.config.input_size
        work = cv2.resize(image, WORK_SIZE, interpolation=cv2.INTER_LINEAR)
        resized = cv2.resize(work, (size, size),
                             interpolation=cv2.INTER_LINEAR)
        pixels = (resized.astype(np.float32) / 255.0 -
                  np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
        # one copy back to the host for the ten level outputs
        flat = self.levels(pixels[None].astype(np.float32)).cpu().numpy()
        boxes, scores = decode_proposals(split_levels(flat, self.config),
                                         self.config)
        if scores.size > TOP_K_SCORES:
            order = np.argsort(scores)[::-1][:TOP_K_SCORES]
            boxes, scores = boxes[order], scores[order]
        scale = (WORK_SIZE[0] / size, WORK_SIZE[1] / size)
        out_boxes = [(float(b[0] * scale[0]), float(b[1] * scale[1]),
                      float(b[2] * scale[0]), float(b[3] * scale[1]))
                     for b in boxes]
        return out_boxes, [float(s) for s in scores]


def _get_patcher(method: str):
    key = method
    with _patchers_lock:
        if key not in _patchers:
            if method == "dino-v1":
                _patchers[key] = _DinoPatcher("abs")
            elif method == "dino-v2":
                _patchers[key] = _DinoPatcher("pos")
            elif method in ("marqo-yolo", "yolox"):
                _patchers[key] = _YoloxPatcher()
            elif method == "frcnn":
                _patchers[key] = _FrcnnPatcher()
        return _patchers.get(key)


def clear_patchers() -> None:
    with _patchers_lock:
        _patchers.clear()


def _parse_patch_method(method: str) -> Tuple[str, dict]:
    """Split a method 'url' like ``simple?hn=2&wn=3`` into (base, params)
    (reference _process_patch_method, image_utils.py:281-301; options hn/
    wn for the grid methods, nms/filter_bb for the detector methods)."""
    from urllib.parse import parse_qsl, urlparse
    parsed = urlparse(str(method))
    params = dict(parse_qsl(parsed.query))
    return parsed.path, params


def _str2bool(value: str) -> bool:
    return str(value).lower() in ("1", "true", "yes")


def chunk_image(image: np.ndarray, method: str
                ) -> Tuple[List[np.ndarray], List[str]]:
    """image: uint8 (H, W, 3) → (patches, bbox-string chunks). The first
    patch is always the full image (reference keeps the original in the
    index); bbox strings are in original-image coordinates. ``method``
    accepts reference-style option urls, e.g. ``simple?hn=2&wn=3``."""
    if image.ndim != 3 or image.shape[2] != 3:
        raise InvalidArgumentError("chunk_image expects an (H, W, 3) image")
    height, width = image.shape[0], image.shape[1]
    method, params = _parse_patch_method(method)
    # reference PATCH_MODELS alias spellings (s2_inference/constants.py:27)
    method = {"fastercnn": "frcnn", "dino/v1": "dino-v1",
              "dino/v2": "dino-v2"}.get(method, method)
    if method in ("simple", "overlap"):
        hn = int(params.get("hn", 3))
        wn = int(params.get("wn", 3))
        boxes = _grid_boxes(width, height, hn=hn, wn=wn,
                            overlap=(method == "overlap"))
    elif method in ("frcnn", "dino-v1", "dino-v2", "marqo-yolo", "yolox"):
        patcher = _get_patcher(method)
        raw_boxes, scores = patcher.boxes(image)
        kept = _process_boxes(raw_boxes, scores, WORK_SIZE)
        full = (0, 0, width, height)
        boxes = [full] + [
            tuple(int(round(v)) for v in
                  _rescale_box(b, WORK_SIZE, (width, height)))
            for b in kept]
    else:
        raise InvalidArgumentError(
            f"Unknown patch method `{method}`. Available: simple, overlap, "
            f"frcnn, dino-v1, dino-v2, marqo-yolo, yolox")
    patches = []
    chunks = []
    for (left, top, right, bottom) in boxes:
        left, top = max(0, int(left)), max(0, int(top))
        right, bottom = min(width, int(right)), min(height, int(bottom))
        if right <= left or bottom <= top:
            continue
        patches.append(image[top:bottom, left:right])
        chunks.append(str([left, top, right, bottom]))
    return patches, chunks
