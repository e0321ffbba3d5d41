#!/usr/bin/env python3
"""Where the device time of marqo_tpu_torch's encoders goes, on a CUDA
card: an e5-base-v2-width random-init text encoder (bf16) runs a padded
ingest batch and a packed one, the same weights quantized (int8 W8A8,
kernel B3) the padded batch, the ViT-L/14 image tower (bf16, random init)
a batch of images, and the towers of ViT-B-16-SigLIP (texts at 64
positions, images at 224 px), NLLB-SigLIP base (texts of mixed lengths,
images at 384 px), RN50 and convnext_base (images at 224 px), CoCa
ViT-L-14 (images and texts), EVA02-L-14-336 (images at 336 px) and
LanguageBind at ViT-L/14 width (audio clips of 992 frames; 2 videos of 8
frames through the video tower), and the detectors of the patch methods
and the image reranker (DINO ViT-S/16 on one 224 px image, YOLOX-S and
Faster R-CNN R50-FPN on one 384 px image, each as served (TF32 off in
its convolutions) and with cuDNN's TF32 on, and OWL-ViT B/32 scoring --hits 768 px images against one query),
LanguageBind's text and image towers (--texts, --images), and the query
encoders: stella_en_400M on a 1 x 16 query and a 16 x 128 batch, and the
ms-marco-MiniLM-L-6 cross-encoder on --hits pairs in their bucket,
all at full width with random weights, under torch.profiler. The script
prints one
JSON line per batch with the device time by kernel family (attention
kernel, matmuls, the rest), the top kernels, and the device's busy share of
the wall time.

    python3 scripts/profile_torch_encoder.py [--batch 256] [--seq 128]
                                             [--images 16] [--texts 16]
                                             [--hits 10]

Needs a CUDA device; exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

E5_BASE = {"vocab_size": 30522, "hidden_size": 768, "num_layers": 12,
           "num_heads": 12, "intermediate_size": 3072}


# ViT-L/14 (bench.py:209-213)
VIT_L14_TEXT = {"hidden_size": 768, "num_layers": 12, "num_heads": 12,
                "intermediate_size": 3072, "projection_dim": 768}
VIT_L14_VISION = {"image_size": 224, "patch_size": 14, "hidden_size": 1024,
                  "num_layers": 24, "num_heads": 16, "intermediate_size": 4096,
                  "projection_dim": 768}


def family(name: str) -> str:
    # both attention kernels (B1, B2) instantiate the tile loops of
    # csrc/attention_tile.cuh (mma.sync, FMA) and attention_tile_sm90.cuh
    # (wgmma)
    if "attention_tile_kernel" in name or "attention_sm90_kernel" in name:
        return "attention_kernel"
    # B3's two kernels (csrc/w8a8_matmul.cu: w8a8_quantize_rows, w8a8_gemm)
    if "w8a8_" in name:
        return "w8a8_kernel"
    if any(t in name.lower() for t in ("gemm", "cutlass", "sm90_xmma",
                                       "cublas", "nvjet")):
        return "matmul"
    if "conv" in name.lower() or "cudnn" in name.lower():
        return "conv"
    return "other"


def profile(fn, steps: int):
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1000
    kernels = {}
    for event in prof.key_averages():
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = event.cuda_time_total
        if device_us and event.device_type.name == "CUDA":
            kernels[event.key] = kernels.get(event.key, 0.0) + device_us
    return kernels, wall_ms


def clip_family_towers(torch, rng, n_images: int, n_texts: int) -> list:
    """(name, fn, docs, rows, seq) for the SigLIP, NLLB-SigLIP, RN50 and
    convnext_base towers at chip_smoke.py's full widths, random weights,
    through their wrappers' modules; texts are tokenized as the wrappers
    do it."""
    import chip_smoke as cs
    from marqo_tpu_torch.inference.loaders import load_model
    from marqo_tpu_torch.inference.types import Device
    out = []
    for key, name, arch, dims, size, text in (
            ("siglip_b16", "ViT-B-16-SigLIP", cs.SIGLIP_B16, cs.SIGLIP_DIMS,
             224, True),
            ("nllb_siglip_base", "nllb-clip-base-siglip", cs.NLLB_SIGLIP_BASE,
             cs.NLLB_SIGLIP_DIMS, 384, True),
            ("rn50", "RN50", cs.RN50, cs.RN50_DIMS, 224, False),
            ("convnext_base", "convnext_base", cs.CONVNEXT_BASE,
             cs.CONVNEXT_BASE_DIMS, 224, False)):
        model = load_model(name, {"name": name, "type": "open_clip",
                                  "random_init": True, "dimensions": dims,
                                  "image_size": size, "architecture": arch},
                           Device.CUDA)
        pixels = torch.from_numpy(rng.integers(
            0, 256, (n_images, size, size, 3), dtype=np.uint8)).cuda()
        grid = model.encoder.vision.config.grid ** 2 if text else size

        def run(tower, inputs):
            def fn():
                with torch.inference_mode():
                    tower(inputs)
            return fn

        out.append((f"{key}_images", run(model.encoder.vision, pixels),
                    n_images, n_images, grid))
        if text:
            ids = torch.from_numpy(model._tokenize(
                cs._text_lengths(n_texts, seed=0))).cuda()
            out.append((f"{key}_texts", run(model.encoder.text, ids),
                        n_texts, n_texts, int(ids.shape[1])))
    return out


def new_family_towers(torch, rng, n_images: int, n_texts: int) -> list:
    """(name, fn, docs, rows, seq) for the CoCa ViT-L-14 (images and texts),
    EVA02-L-14-336 (images) and LanguageBind ViT-L/14 (audio clips of 992
    frames, and 2 videos of 8 frames through the video tower) towers at
    chip_smoke.py's full widths, random weights, through their wrappers'
    modules."""
    import chip_smoke as cs
    from marqo_tpu_torch.inference.loaders import load_model
    from marqo_tpu_torch.inference.types import Device
    from marqo_tpu_torch.models.languagebind import (VideoTowerConfig,
                                                     init_video_tower)

    def run(tower, inputs):
        def fn():
            with torch.inference_mode():
                tower(inputs)
        return fn

    def pixels(size, n=n_images):
        return torch.from_numpy(rng.integers(
            0, 256, (n, size, size, 3), dtype=np.uint8)).cuda()

    out = []
    coca = load_model("coca_ViT-L-14", {
        "name": "open_clip/coca_ViT-L-14/laion2b_s13b_b90k",
        "type": "open_clip", "random_init": True, "dimensions": cs.COCA_DIMS,
        "image_size": 224, "architecture": cs.COCA_L14}, Device.CUDA)
    ids = torch.from_numpy(coca._tokenize(
        cs._text_lengths(n_texts, seed=0))).cuda()
    out += [("coca_l14_images", run(coca.encoder.vision, pixels(224)),
             n_images, n_images, 257),
            ("coca_l14_texts", run(coca.encoder.text, ids), n_texts,
             n_texts, int(ids.shape[1]) + 1)]
    eva = load_model("EVA02-L-14-336", {
        "name": "open_clip/EVA02-L-14-336/merged2b_s6b_b61k",
        "type": "open_clip", "random_init": True,
        "dimensions": cs.EVA02_DIMS, "image_size": cs.EVA02_IMAGE_SIZE,
        "architecture": cs.EVA02_L14_336}, Device.CUDA)
    out.append(("eva02_l14_336_images",
                run(eva.encoder.vision, pixels(cs.EVA02_IMAGE_SIZE)),
                n_images, n_images, eva.vision_config.grid ** 2 + 1))
    lb = load_model("languagebind-l14", {
        "type": "languagebind", "random_init": True,
        "dimensions": cs.LANGUAGEBIND_DIMS, "image_size": 224,
        "architecture": cs.LANGUAGEBIND_L14}, Device.CUDA)
    mels = torch.from_numpy(rng.standard_normal(
        (n_images, 128, lb.audio_config.n_frames)).astype(np.float32)).cuda()
    config = VideoTowerConfig(projection_dim=cs.LANGUAGEBIND_DIMS)
    video = init_video_tower(config, torch.Generator("cuda").manual_seed(0),
                             dtype=torch.bfloat16, device="cuda")
    frames = torch.from_numpy(rng.integers(
        0, 256, (cs.VIDEO_COUNT, config.num_frames, 224, 224, 3),
        dtype=np.uint8)).cuda()
    lb_ids = torch.from_numpy(lb._tokenize(
        cs._text_lengths(n_texts, seed=0))).cuda()
    out += [("languagebind_texts", run(lb.encoder.text, lb_ids), n_texts,
             n_texts, int(lb_ids.shape[1])),
            ("languagebind_images", run(lb.encoder.vision, pixels(224)),
             n_images, n_images, 257),
            ("languagebind_audio", run(lb.encoder.audio, mels), n_images,
             n_images, lb.audio_config.n_tokens + 1),
            ("languagebind_video", run(video, frames), cs.VIDEO_COUNT,
             cs.VIDEO_COUNT * config.num_frames, 257)]
    return out


def query_encoders(torch, rng, n_hits: int) -> list:
    """(name, fn, docs, rows, seq) for the text encoders on the query path
    at chip_smoke.py's full widths, random weights, eagerly: Stella
    (stella_en_400M) on a 1 x 16 query and a 16 x 128 batch, and the
    cross-encoder (ms-marco-MiniLM-L-6) scoring ``n_hits`` pairs padded to
    their batch bucket at 128 positions, as a rerank does."""
    import chip_smoke as cs
    from marqo_tpu_torch.inference.batching import pick_batch_bucket
    from marqo_tpu_torch.inference.loaders import load_model
    from marqo_tpu_torch.inference.types import Device
    from marqo_tpu_torch.models.cross_encoder import (TorchCrossEncoder,
                                                      cross_encoder_scores)
    stella = load_model("stella-en-400m", {
        "name": "stella-en-400m", "type": "hf_stella", "random_init": True,
        "dimensions": cs.STELLA_DIMS, "tokens": 512,
        "architecture": cs.STELLA_400M}, Device.CUDA)
    reranker = TorchCrossEncoder("ms-marco-MiniLM-L-6-v2", Device.CUDA,
                                 {"random_init": True,
                                  "architecture": cs.MINILM_L6})
    reranker.load()

    def rows(n, S, vocab, types=False):
        return [torch.from_numpy(a).cuda() for a in
                cs.padded_token_rows((n, S), vocab, rng, types)]

    def run(fn, *inputs):
        def step():
            with torch.inference_mode():
                fn(*inputs)
        return step

    out = []
    for n, S in ((1, 16), (16, 128)):
        out.append((f"stella_{n}x{S}",
                    run(stella.encode_tokens, stella.encoder,
                        *rows(n, S, stella.config.vocab_size)), n, n, S))
    bucket = pick_batch_bucket(n_hits)
    out.append(("cross_encoder_hits",
                run(cross_encoder_scores, reranker.model,
                    *rows(bucket, 128, reranker.config.vocab_size,
                          types=True)), n_hits, bucket, 128))
    return out


def detector_models(torch, rng, n_hits: int) -> list:
    """(name, fn, docs, rows, seq) for the patchers' detectors at their
    served configurations (DINO ViT-S/16 in bf16 on one 224 px image;
    YOLOX-S and Faster R-CNN R50-FPN in fp32 on one 384 px image, as
    served, their forward turning cuDNN's TF32 off, and their forward's
    body under PyTorch's default, TF32 on) and OWL-ViT B/32 (bf16) scoring
    ``n_hits`` 768 px images against one query, random weights."""
    from marqo_tpu_torch.models import dino_vit, frcnn, owl_vit, yolox

    def generator():
        return torch.Generator("cuda").manual_seed(0)

    dino = dino_vit.init_params(dino_vit.DinoViTConfig.vit_small(),
                                generator(), dtype=torch.bfloat16,
                                device="cuda")
    yolo = yolox.init_params(yolox.YoloxConfig(), generator(),
                             device="cuda")
    rcnn = frcnn.init_params(frcnn.FrcnnConfig(), generator(),
                             device="cuda")
    owl_config = owl_vit.OwlViTConfig.base_patch32()
    owl = owl_vit.init_owl_params(owl_config, generator(),
                                  dtype=torch.bfloat16, device="cuda")

    def pixels(n, size):
        return torch.from_numpy(rng.integers(
            0, 256, (n, size, size, 3), dtype=np.uint8)).cuda()

    letterboxed = pixels(1, 384).float()
    normalized = torch.from_numpy(rng.standard_normal(
        (1, 384, 384, 3)).astype(np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(
        5, 77, (1, owl_config.text.max_positions)).astype(np.int32)).cuda()

    def run(fn, *inputs):
        def step():
            with torch.inference_mode():
                fn(*inputs)
        return step

    def detect(images, query):
        return owl_vit.detect(owl, images, query)

    return [("dino_vit_s16_image", run(dino.last_selfattention,
                                       pixels(1, 224)), 1, 1, 197),
            ("yolox_s_image", run(yolo, letterboxed), 1, 1, 384),
            ("yolox_s_image_tf32_on", run(yolo._forward, letterboxed),
             1, 1, 384),
            ("frcnn_r50_fpn_image", run(rcnn, normalized), 1, 1, 384),
            ("frcnn_r50_fpn_image_tf32_on",
             run(rcnn._forward, normalized), 1, 1, 384),
            ("owl_vit_b32_rerank", run(detect, pixels(n_hits, 768), ids),
             n_hits, n_hits, 577)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_encoder: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--images", type=int, default=16)
    parser.add_argument("--texts", type=int, default=16)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--hits", type=int, default=10)
    args = parser.parse_args()

    import copy

    from marqo_tpu_torch.models.bert import (TextEncoderConfig,
                                             encode_tokens,
                                             encode_tokens_packed,
                                             init_encoder, quantize_encoder)
    from marqo_tpu_torch.ops.packing import pack_sequences
    config = TextEncoderConfig(**E5_BASE)
    encoder = init_encoder(config, torch.Generator("cuda").manual_seed(0),
                           dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    B, S = args.batch, args.seq
    # log-normal lengths around 70 tokens, as a realistic ingest mix
    lengths = np.clip(rng.lognormal(np.log(60), 0.5, B), 4, S).astype(int)
    ids = rng.integers(5, config.vocab_size, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids *= mask
    packed = pack_sequences([ids[i, :lengths[i]] for i in range(B)],
                            seq_len=S, pad_id=0)
    dev = {k: torch.from_numpy(v).cuda() for k, v in (
        ("ids", ids), ("mask", mask), ("pids", packed.input_ids),
        ("seg", packed.segment_ids), ("pos", packed.positions),
        ("idx", packed.seq_index))}

    def padded():
        with torch.inference_mode():
            encode_tokens(encoder, dev["ids"], dev["mask"])

    int8_encoder = quantize_encoder(copy.deepcopy(encoder))

    def padded_int8():
        with torch.inference_mode():
            encode_tokens(int8_encoder, dev["ids"], dev["mask"])

    def packed_run():
        with torch.inference_mode():
            encode_tokens_packed(encoder, dev["pids"], dev["seg"],
                                 dev["pos"], dev["idx"], packed.n_sequences)

    from marqo_tpu_torch.models.clip import (CLIPTextConfig,
                                             CLIPVisionConfig,
                                             encode_clip_image,
                                             init_clip_params)
    clip_model = init_clip_params(
        CLIPTextConfig(**VIT_L14_TEXT), CLIPVisionConfig(**VIT_L14_VISION),
        torch.Generator("cuda").manual_seed(0), dtype=torch.bfloat16,
        device="cuda")
    pixels = torch.from_numpy(rng.integers(
        0, 256, (args.images, 224, 224, 3), dtype=np.uint8)).cuda()

    def images():
        with torch.inference_mode():
            encode_clip_image(clip_model, pixels)

    towers = clip_family_towers(torch, rng, args.images, args.texts)
    towers += new_family_towers(torch, rng, args.images, args.texts)
    towers += detector_models(torch, rng, args.hits)
    towers += query_encoders(torch, rng, args.hits)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name, fn, docs, rows, seq in (
            ("padded", padded, B, B, S),
            ("packed", packed_run, B, int(packed.input_ids.shape[0]), S),
            ("padded_int8", padded_int8, B, B, S),
            ("vit_l14_images", images, args.images, args.images, 257),
            *towers):
        kernels, wall_ms = profile(fn, args.steps)
        total_us = sum(kernels.values())
        by_family = {}
        for key, us in kernels.items():
            by_family[family(key)] = by_family.get(family(key), 0.0) + us
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({
            "batch": name, "docs": docs, "rows": rows, "seq": seq,
            "device_ms_per_step": total_us / 1000 / args.steps,
            "wall_ms_per_step": wall_ms / args.steps,
            "device_busy_share": total_us / 1000 / wall_ms,
            "share_by_family": {k: v / total_us for k, v in
                                sorted(by_family.items())},
            "top_kernels_ms_per_step": [[k[:80], us / 1000 / args.steps]
                                        for k, us in top],
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
