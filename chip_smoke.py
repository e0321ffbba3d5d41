#!/usr/bin/env python3
"""Smoke run of marqo_tpu_torch (the PyTorch/CUDA port) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one Hopper card. It builds
the CUDA kernels from marqo_tpu_torch/csrc/ with nvcc, then runs these
phases and prints one JSON object per phase:

  1. env           torch/CUDA versions, compute capability (must be 9.0)
  2. build         seconds to build (or load) the kernels' library
  3. kernel        B1, masked attention, against its plain twin: both mask
                   modes, fp32 and bf16, at (B, 12, S, 64) for S in
                   16/128/512
  4. fused_kernel  B2, flash attention, against its plain twin: no mask,
                   pad_mask and packed segment ids, fp32 and bf16, at
                   (4, 16, S, D) for the ViT towers' (tokens, head dim),
                   and at the main path's own shapes: (16, 16, 257, 64)
                   with no mask, (16, 12, 128, 64) padded and packed
  5. encoder       e5-base-v2-width encoder on the same random weights:
                   B1 ("kernel") and B2 ("flash") paths against the twin
                   path, padded and packed
  6. clip_encoder  the ViT-L/14 towers at full width and depth, random
                   weights: the vision tower on B2 against the twin, batch 16
  7. serve         the in-process HTTP server: an e5-base-v2-width
                   random-init index, 256 documents of mixed lengths,
                   TENSOR and HYBRID searches and an embed; both B1 modes
                   must have run
  8. clip_serve    the same server: an open_clip ViT-L/14 random-init index
                   with treatUrlsAndPointersAsImages, 64 documents with an
                   image file, a caption and a multimodal_combination
                   field; TENSOR searches by text, by an image path and
                   weighted, and an image embed; B2's no-mask mode must
                   have run during the adds and the image search
  9. timing        kernel and twin times, ViT-L/14 images per second on
                   the kernel and twin paths, add throughput and search
                   latency (information only)

then the card's name and power limit as nvidia-smi gives them, a
{"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. Every kernel launch counter is set to 0 just
before each path (encoder, clip_encoder, serve, clip_serve) and read just
after it. Any failed check raises and the script exits non-zero. Without a
CUDA device, or outside a checkout, it exits non-zero before printing
anything. JAX is never imported.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
B1_SOURCE = "marqo_tpu_torch/csrc/masked_attention.cu"
B1_REPLACES = "marqo_tpu/ops/flash_attention.py:36"
B2_SOURCE = "marqo_tpu_torch/csrc/fused_attention.cu"
B2_REPLACES = "marqo_tpu/ops/fused_attention.py:102"
# as tests/test_flash_attention.py:39 and tests/test_fused_attention.py:87
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
E5_BASE = {"vocab_size": 30522, "hidden_size": 768, "num_layers": 12,
           "num_heads": 12, "intermediate_size": 3072}
# ViT-L/14 (bench.py:209-213, BASELINE config 3)
VIT_L14_TEXT = {"vocab_size": 49408, "hidden_size": 768, "num_layers": 12,
                "num_heads": 12, "intermediate_size": 3072,
                "max_positions": 77, "projection_dim": 768}
VIT_L14_VISION = {"image_size": 224, "patch_size": 14, "hidden_size": 1024,
                  "num_layers": 24, "num_heads": 16, "intermediate_size": 4096,
                  "projection_dim": 768}
# B2's checks, (B, N, S, D, modes): every mode at batch 4 over the ViT
# towers' (tokens, head dim), B/32, L/14, L/14@336, and the open_clip H
# (80), H-14-378 (730 tokens) and bigG (104) head dims; then the shapes the
# main path gives B2: the ViT-L/14 tower and the CLIP serve path (no mask,
# batch 16), and the encoder phase's "flash" path, padded and packed
FUSED_MODES = ("nomask", "pad_mask", "segment_ids")
FUSED_CASES = tuple((4, 16, S, D, FUSED_MODES) for S, D in (
    (50, 64), (257, 64), (577, 64), (257, 80), (730, 80), (257, 104))) + (
    (16, 16, 257, 64, ("nomask",)),
    (16, 12, 128, 64, ("pad_mask", "segment_ids")))
CLIP_DOCS = 64


class SmokeFailure(RuntimeError):
    pass


def check(condition, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, iters: int) -> dict:
    """plain, kernel, kernel, plain: drift shows as a gap in a pair."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}


# --- launch counters ---------------------------------------------------------

def _counter_modules():
    from marqo_tpu_torch.ops import flash_attention, fused_attention
    return {"masked_attention": flash_attention, "fused_attention":
            fused_attention}


def reset_counts() -> None:
    for module in _counter_modules().values():
        for mode in module.LAUNCHES:
            module.LAUNCHES[mode] = 0


def read_counts() -> dict:
    return {f"{name}_{mode}": count
            for name, module in _counter_modules().items()
            for mode, count in module.LAUNCHES.items()}


def count_delta(before: dict, after: dict) -> dict:
    return {name: after[name] - before[name] for name in after}


# --- inputs ------------------------------------------------------------------

def attention_inputs(B, N, S, D, dtype, seed):
    """Inputs for both attention kernels, on the card: q, k, v (B, N, S, D)
    ~ 0.3*N(0, 1) (tests/test_fused_attention.py's scale); a padding mask
    whose first rows are full, 1-token, half and all-pad; packed segment
    ids with several documents per row, a pad tail of 0 (pad queries) and
    an all-pad last row."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(0.3 * rng.standard_normal(
        (B, N, S, D), dtype=np.float32)).to(DEVICE, dtype)
        for _ in range(3))
    lengths = rng.integers(1, S + 1, B)
    first = (S, 1, S // 2, 0)[:B]
    lengths[:len(first)] = first
    pad = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    seg = np.zeros((B, S), dtype=np.int32)
    for b in range(B - 1 if B > 1 else B):
        pos, sid, end = 0, 1, S - S // 8
        while pos < end:
            n = int(rng.integers(1, max(2, S // 4)))
            seg[b, pos:min(pos + n, end)] = sid
            pos, sid = pos + n, sid + 1
    return (q, k, v, torch.from_numpy(pad).to(DEVICE),
            torch.from_numpy(seg).to(DEVICE))


def write_images(directory: str, n: int, seed: int) -> list:
    """PNG files from a numpy seed: a colour field under a gradient and
    noise, 160x120 to 640x480, both orientations."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        w, h = int(rng.integers(160, 641)), int(rng.integers(120, 481))
        if i % 2:
            w, h = h, w
        base = rng.integers(0, 256, size=3)
        ramp = np.linspace(0, 1, w)[None, :, None] * rng.integers(
            -120, 120, size=3)
        noise = rng.normal(0, 25, size=(h, w, 3))
        pixels = np.clip(base + ramp + noise, 0, 255).astype(np.uint8)
        paths.append(os.path.join(directory, f"img{i}.png"))
        Image.fromarray(pixels).save(paths[-1])
    return paths


def min_cos(a, b) -> float:
    import torch
    return float(torch.nn.functional.cosine_similarity(a, b).min())


# --- phases ------------------------------------------------------------------

def phase_kernel(fa, torch):
    errors = {"padding": 0.0, "segment": 0.0}
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for S, B in ((16, 32), (128, 32), (512, 8)):
            q, k, v, pad, seg = attention_inputs(B, 12, S, 64, dtype, seed=S)
            for mode, mask, kernel, plain in (
                    ("padding", pad, fa.attention_padding,
                     fa.attention_padding_reference),
                    ("segment", seg, fa.attention_segment,
                     fa.attention_segment_reference)):
                out = kernel(q, k, v, mask)
                torch.cuda.synchronize()
                ref = plain(q, k, v, mask)
                check(out.dtype == dtype and out.shape == q.shape,
                      f"kernel output {out.dtype} {tuple(out.shape)}")
                check(bool(torch.isfinite(out).all()),
                      f"non-finite kernel output ({mode}, {dname}, S={S})")
                err = float((out.float() - ref.float()).abs().max())
                results.append({"mode": mode, "dtype": dname, "shape":
                                [B, 12, S, 64], "max_abs_err": err})
                check(err <= ATOL[dname],
                      f"kernel vs twin ({mode}, {dname}, S={S}): max abs "
                      f"err {err} > {ATOL[dname]}")
                errors[mode] = max(errors[mode], err)
    emit("kernel", ok=True, atol=ATOL, results=results)
    return errors


def phase_fused_kernel(fused, torch):
    errors = {"nomask": 0.0, "segment": 0.0}
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, N, S, D, names in FUSED_CASES:
            shape = [B, N, S, D]
            q, k, v, pad, seg = attention_inputs(B, N, S, D, dtype,
                                                 seed=B * S * D)
            masks = {"nomask": {}, "pad_mask": {"pad_mask": pad},
                     "segment_ids": {"segment_ids": seg}}
            for name in names:
                mask = masks[name]
                mode = "segment" if mask else "nomask"
                out = fused.fused_attention(q, k, v, **mask)
                torch.cuda.synchronize()
                ref = fused.fused_attention_reference(q, k, v, **mask)
                check(out.dtype == dtype and out.shape == q.shape,
                      f"fused output {out.dtype} {tuple(out.shape)}")
                check(bool(torch.isfinite(out).all()),
                      f"non-finite fused output ({name}, {dname}, {shape})")
                err = float((out.float() - ref.float()).abs().max())
                results.append({"mode": name, "dtype": dname,
                                "shape": shape, "max_abs_err": err})
                check(err <= ATOL[dname],
                      f"fused kernel vs twin ({name}, {dname}, {shape}): "
                      f"max abs err {err} > {ATOL[dname]}")
                errors[mode] = max(errors[mode], err)
    emit("fused_kernel", ok=True, atol=ATOL, results=results)
    return errors


def phase_encoder(torch):
    from dataclasses import replace

    from marqo_tpu_torch.models.bert import (TextEncoderConfig,
                                             encode_tokens,
                                             encode_tokens_packed,
                                             init_encoder)
    from marqo_tpu_torch.ops.packing import pack_sequences
    config = TextEncoderConfig(**E5_BASE)
    generator = torch.Generator(device=DEVICE).manual_seed(1)
    encoder = init_encoder(config, generator, dtype=torch.bfloat16,
                           device=DEVICE)
    rng = torch.Generator().manual_seed(2)
    B, S = 16, 128
    lengths = torch.randint(4, S + 1, (B,), generator=rng)
    ids = torch.randint(5, config.vocab_size, (B, S), generator=rng,
                        dtype=torch.int32)
    mask = (torch.arange(S)[None] < lengths[:, None]).int()
    ids = ids * mask
    seqs = [ids[i, :lengths[i]].numpy() for i in range(B)]
    packed = pack_sequences(seqs, seq_len=S, pad_id=0)
    on = {name: torch.from_numpy(getattr(packed, name)).to(DEVICE)
          for name in ("input_ids", "segment_ids", "positions", "seq_index")}

    def run(impl):
        encoder.config = replace(config, attention_impl=impl)
        with torch.inference_mode():
            padded = encode_tokens(encoder, ids.to(DEVICE), mask.to(DEVICE))
            pk = encode_tokens_packed(encoder, on["input_ids"],
                                      on["segment_ids"], on["positions"],
                                      on["seq_index"], packed.n_sequences)
        return padded, pk

    reset_counts()
    plain_padded, plain_packed = run("plain")
    padded, packed_out = run("kernel")
    flash_padded, flash_packed = run("flash")
    launches = read_counts()
    encoder.config = config

    cos = {"padded_kernel_vs_plain": min_cos(padded, plain_padded),
           "packed_kernel_vs_plain": min_cos(packed_out, plain_packed),
           "packed_vs_padded": min_cos(packed_out, padded),
           "padded_flash_vs_plain": min_cos(flash_padded, plain_padded),
           "packed_flash_vs_plain": min_cos(flash_packed, plain_packed)}
    for name, value in cos.items():
        check(value > 1 - 1e-3, f"encoder {name}: cosine {value}")
    check(padded.shape == (B, E5_BASE["hidden_size"]) and
          bool(torch.isfinite(padded).all()),
          "encoder output shape/finiteness")
    for name in ("masked_attention_padding", "masked_attention_segment",
                 "fused_attention_segment"):
        check(launches[name] > 0, f"encoder phase did not launch {name}: "
              f"{launches}")
    emit("encoder", ok=True, shape=[B, S], packed_rows=int(
        packed.input_ids.shape[0]), min_cosine=cos, launches=launches)
    return launches


def phase_clip_encoder(torch, batch: int = 16):
    """The ViT-L/14 towers on random weights; returns the model and a
    pixel batch for the timing phase."""
    from dataclasses import replace

    import numpy as np

    from marqo_tpu_torch.models.clip import (CLIPTextConfig,
                                             CLIPVisionConfig,
                                             encode_clip_image,
                                             encode_clip_text,
                                             init_clip_params)
    text_config = CLIPTextConfig(**VIT_L14_TEXT)
    vision_config = CLIPVisionConfig(**VIT_L14_VISION)
    generator = torch.Generator(device=DEVICE).manual_seed(4)
    model = init_clip_params(text_config, vision_config, generator,
                             dtype=torch.bfloat16, device=DEVICE)
    rng = np.random.default_rng(5)
    size = vision_config.image_size
    pixels = torch.from_numpy(rng.integers(
        0, 256, (batch, size, size, 3), dtype=np.uint8)).to(DEVICE)
    ids = rng.integers(1, text_config.vocab_size - 1,
                       (batch, text_config.max_positions)).astype(np.int32)
    ids[np.arange(batch), rng.integers(2, text_config.max_positions,
                                       batch)] = text_config.eos_token_id
    reset_counts()
    with torch.inference_mode():
        kernel = encode_clip_image(model, pixels)
        model.vision.config = replace(vision_config, attention_impl="plain")
        plain = encode_clip_image(model, pixels)
        model.vision.config = vision_config
        text = encode_clip_text(model, torch.from_numpy(ids).to(DEVICE))
    launches = read_counts()
    projection = vision_config.projection_dim
    cos = min_cos(kernel, plain)
    check(cos > 1 - 1e-3, f"ViT-L/14 kernel vs plain: cosine {cos}")
    for name, out in (("image", kernel), ("text", text)):
        check(out.shape == (batch, projection) and
              bool(torch.isfinite(out).all()),
              f"ViT-L/14 {name} output {tuple(out.shape)} not finite")
    check(launches["fused_attention_nomask"] == vision_config.num_layers,
          f"ViT-L/14: expected one B2 no-mask launch per layer: {launches}")
    emit("clip_encoder", ok=True, batch=batch, tokens=(
        size // vision_config.patch_size) ** 2 + 1,
        min_cosine={"image_kernel_vs_plain": cos}, launches=launches)
    return model, pixels


class HttpServer:
    """The port's HTTP app on a free localhost port, in this process."""

    def __init__(self):
        from marqo_tpu_torch.api.app import (build_app, generate_config,
                                             on_start)
        from marqo_tpu_torch.api.http_framework import serve
        config = generate_config()
        on_start(config)
        self.server = serve(build_app(config), host="127.0.0.1", port=0,
                            background=True)
        self.port = self.server.server_address[1]

    def req(self, method, path, body=None):
        import urllib.request
        r = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=600) as resp:
            return json.load(resp)

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _model_devices(model_type) -> set:
    from marqo_tpu_torch.inference import vectorise
    return {str(p.device.type)
            for entry in vectorise._available_models.values()
            if isinstance(entry["model"], model_type)
            for p in entry["model"].encoder.parameters()}


def phase_serve(server, torch):
    from marqo_tpu_torch.inference.loaders import TorchHFTextModel
    req = server.req
    props = {"name": "smoke-e5-base-v2", "type": "hf",
             "random_init": True, "pooling_method": "mean",
             "tokens": 128, "dimensions": E5_BASE["hidden_size"],
             "architecture": E5_BASE}
    req("POST", "/indexes/smoke",
        {"model": "smoke-e5-base-v2", "modelProperties": props})
    rng = torch.Generator().manual_seed(3)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
             "golf", "hotel", "india", "juliet", "kilo", "lima", "mike",
             "november", "oscar", "papa", "quebec", "romeo", "sierra"]

    def text(n_words):
        idx = torch.randint(0, len(words), (n_words,), generator=rng)
        return " ".join(words[i] for i in idx.tolist())

    docs = [{"_id": f"d{i}", "title": text(2 + i % 5),
             "body": text(int(torch.randint(3, 60, (1,), generator=rng)))}
            for i in range(256)]
    reset_counts()
    # the first add loads the model onto the card: keep it out of the
    # timed adds
    res = req("POST", "/indexes/smoke/documents",
              {"documents": [{"_id": "warm", "title": text(4),
                              "body": text(30)}],
               "tensorFields": ["title", "body"]})
    check(res["errors"] is False, f"add_documents errors: {res}")
    start = time.perf_counter()
    for b in range(0, len(docs), 64):
        res = req("POST", "/indexes/smoke/documents",
                  {"documents": docs[b:b + 64],
                   "tensorFields": ["title", "body"]})
        check(res["errors"] is False, f"add_documents errors: {res}")
    add_seconds = time.perf_counter() - start
    add_launches = read_counts()
    latencies = []
    for i in range(8):
        for method in ("TENSOR", "HYBRID"):
            t0 = time.perf_counter()
            res = req("POST", "/indexes/smoke/search",
                      {"q": text(3 + i), "searchMethod": method,
                       "limit": 5})
            latencies.append((time.perf_counter() - t0) * 1000)
            check(len(res["hits"]) > 0, f"{method} search: no hits")
    # a document's own text finds that document first
    probe = max(docs, key=lambda d: len(d["body"]))
    res = req("POST", "/indexes/smoke/search",
              {"q": probe["body"], "searchMethod": "TENSOR", "limit": 3})
    check(res["hits"][0]["_id"] == probe["_id"],
          f"own-text query: top hit {res['hits'][0]['_id']}, expected "
          f"{probe['_id']}")
    emb = req("POST", "/indexes/smoke/embed",
              {"content": ["alpha bravo charlie"]})["embeddings"]
    norm = float(torch.tensor(emb[0]).norm()) if len(emb) == 1 else 0.0
    check(len(emb) == 1 and len(emb[0]) == E5_BASE["hidden_size"] and
          abs(norm - 1) < 1e-3,
          f"embed: expected one finite unit 768-d vector (norm {norm})")
    launches = read_counts()
    stats = req("GET", "/indexes/smoke/stats")
    devices = _model_devices(TorchHFTextModel)
    check(devices == {DEVICE}, f"model parameters on {devices}")
    check(launches["masked_attention_padding"] > 0 and
          launches["masked_attention_segment"] > 0,
          f"serve phase did not run both kernel modes: {launches}")
    emit("serve", ok=True, docs=len(docs) + 1,
         documents_in_index=stats.get("numberOfDocuments"),
         vectors_in_index=stats.get("numberOfVectors"),
         searches=len(latencies), launches=launches,
         launches_during_add=add_launches, model_devices=sorted(devices))
    return launches, add_seconds, len(docs), latencies


def phase_clip_serve(server, torch):
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    req = server.req
    arch = {"vocab_size": VIT_L14_TEXT["vocab_size"],
            "text_hidden_size": VIT_L14_TEXT["hidden_size"],
            "text_layers": VIT_L14_TEXT["num_layers"],
            "text_heads": VIT_L14_TEXT["num_heads"],
            "text_intermediate": VIT_L14_TEXT["intermediate_size"],
            "patch_size": VIT_L14_VISION["patch_size"],
            "vision_hidden_size": VIT_L14_VISION["hidden_size"],
            "vision_layers": VIT_L14_VISION["num_layers"],
            "vision_heads": VIT_L14_VISION["num_heads"],
            "vision_intermediate": VIT_L14_VISION["intermediate_size"]}
    dims = VIT_L14_VISION["projection_dim"]
    props = {"name": "smoke-open-clip-vit-l-14", "type": "open_clip",
             "random_init": True, "dimensions": dims,
             "image_size": VIT_L14_VISION["image_size"], "architecture": arch}
    req("POST", "/indexes/clip", {"model": "smoke-open-clip-vit-l-14",
                                  "modelProperties": props,
                                  "treatUrlsAndPointersAsImages": True})
    colours = ["red", "green", "blue", "yellow", "purple", "orange", "grey",
               "white"]
    fields = {"tensorFields": ["image", "caption", "combo"],
              "mappings": {"combo": {"type": "multimodal_combination",
                                     "weights": {"image": 0.7,
                                                 "caption": 0.3}}}}
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_images(tmp, CLIP_DOCS + 1, seed=6)
        docs = [{"_id": f"img{i}", "image": paths[i],
                 "caption": f"a {colours[i % 8]} photo, number {i}"}
                for i in range(CLIP_DOCS)]
        reset_counts()
        # the first add loads the model onto the card
        res = req("POST", "/indexes/clip/documents", {
            "documents": [{"_id": "warm", "image": paths[-1],
                           "caption": "a warm-up photo"}], **fields})
        check(res["errors"] is False, f"clip add_documents errors: {res}")
        before = read_counts()
        start = time.perf_counter()
        for b in range(0, CLIP_DOCS, 16):
            res = req("POST", "/indexes/clip/documents",
                      {"documents": docs[b:b + 16], **fields})
            check(res["errors"] is False, f"clip add_documents errors: {res}")
        add_seconds = time.perf_counter() - start
        add_launches = count_delta(before, read_counts())
        res = req("POST", "/indexes/clip/search",
                  {"q": "a red photo", "searchMethod": "TENSOR", "limit": 5})
        check(len(res["hits"]) > 0, "clip text search: no hits")
        before = read_counts()
        probe = CLIP_DOCS // 3
        res = req("POST", "/indexes/clip/search",
                  {"q": paths[probe], "searchMethod": "TENSOR", "limit": 3})
        image_launches = count_delta(before, read_counts())
        check(res["hits"][0]["_id"] == f"img{probe}",
              f"image query: top hit {res['hits'][0]['_id']}, expected "
              f"img{probe}")
        weighted = req("POST", "/indexes/clip/search", {
            "q": {paths[1]: 1.0, "a green photo": 0.1},
            "searchMethod": "TENSOR", "limit": 5})
        check(len(weighted["hits"]) > 0, "weighted search: no hits")
        emb = req("POST", "/indexes/clip/embed",
                  {"content": [paths[2]]})["embeddings"]
    launches = read_counts()
    norm = float(torch.tensor(emb[0]).norm()) if len(emb) == 1 else 0.0
    check(len(emb) == 1 and len(emb[0]) == dims and abs(norm - 1) < 1e-3,
          f"clip embed: expected one unit {dims}-d vector (norm {norm})")
    stats = req("GET", "/indexes/clip/stats")
    check(stats.get("numberOfDocuments") == CLIP_DOCS + 1,
          f"clip index documents: {stats}")
    check(stats.get("numberOfVectors") == 3 * (CLIP_DOCS + 1),
          f"clip index vectors (image, caption, combination): {stats}")
    devices = _model_devices(TorchCLIPModel)
    check(devices == {DEVICE}, f"CLIP parameters on {devices}")
    for window, counts in (("adds", add_launches),
                           ("image search", image_launches)):
        check(counts["fused_attention_nomask"] > 0,
              f"B2 no-mask mode did not run during the {window}: {counts}")
    emit("clip_serve", ok=True, docs=CLIP_DOCS + 1,
         documents_in_index=stats.get("numberOfDocuments"),
         vectors_in_index=stats.get("numberOfVectors"),
         image_query_top_hit=res["hits"][0]["_id"],
         weighted_query_top_hit=weighted["hits"][0]["_id"],
         launches=launches, launches_during_add=add_launches,
         launches_during_image_search=image_launches,
         model_devices=sorted(devices))
    return launches, add_seconds


def phase_timing(fa, fused, torch, clip_model, pixels):
    from dataclasses import replace

    from marqo_tpu_torch.models.clip import encode_clip_image
    rows = []
    for B, S in ((256, 128), (1, 32)):
        q, k, v, pad, seg = attention_inputs(B, 12, S, 64, torch.bfloat16,
                                             seed=B)
        for mode, mask, kernel, plain in (
                ("padding", pad, fa.attention_padding,
                 fa.attention_padding_reference),
                ("segment", seg, fa.attention_segment,
                 fa.attention_segment_reference)):
            rows.append({"kernel": "masked_attention", "mode": mode,
                         "shape": [B, 12, S, 64], "dtype": "bfloat16",
                         **paired_ms(lambda: kernel(q, k, v, mask),
                                     lambda: plain(q, k, v, mask),
                                     20 if B > 1 else 200)})
    for B, N, S in ((16, 16, 257), (1, 16, 257), (256, 12, 128)):
        q, k, v, _, seg = attention_inputs(B, N, S, 64, torch.bfloat16,
                                           seed=B)
        for mode, mask in (("nomask", {}), ("segment", {"segment_ids": seg})):
            rows.append({"kernel": "fused_attention", "mode": mode,
                         "shape": [B, N, S, 64], "dtype": "bfloat16",
                         **paired_ms(
                             lambda: fused.fused_attention(q, k, v, **mask),
                             lambda: fused.fused_attention_reference(
                                 q, k, v, **mask),
                             20 if B > 1 else 200)})
    config = clip_model.vision.config
    plain_config = replace(config, attention_impl="plain")

    def vit(vision_config):
        def run():
            clip_model.vision.config = vision_config
            with torch.inference_mode():
                encode_clip_image(clip_model, pixels)
        return run

    vit_ms = paired_ms(vit(config), vit(plain_config), 10)
    clip_model.vision.config = config
    batch = pixels.shape[0]
    vit_row = {"batch": batch, "images_per_s": batch * 1000 / vit_ms["ms"],
               "plain_images_per_s": batch * 1000 / vit_ms["plain_ms"],
               **vit_ms}
    return rows, vit_row


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(ROOT, "marqo_tpu_torch",
                                       "__init__.py")):
        print("chip_smoke: run from the root of a marqo-tpu checkout "
              "(marqo_tpu_torch/ not found)", file=sys.stderr)
        return 2
    # the port must run without JAX and without the JAX package
    sys.modules["jax"] = None
    sys.modules["marqo_tpu"] = None
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"
    os.environ["MARQO_MODELS_TO_PRELOAD"] = "[]"
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    capability = torch.cuda.get_device_capability(0)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         capability=list(capability), nvidia_smi=smi)
    check(capability == (9, 0), f"expected compute capability (9, 0), got "
          f"{capability}")

    from marqo_tpu_torch.ops import _build
    from marqo_tpu_torch.ops import flash_attention as fa
    from marqo_tpu_torch.ops import fused_attention as fused
    prebuilt = _build.library_path().is_file()
    start = time.perf_counter()
    library = _build.load_library()
    emit("build", ok=True, seconds=time.perf_counter() - start,
         prebuilt=prebuilt, library=os.path.relpath(library._name, ROOT),
         flags=_build.NVCC_FLAGS)

    errors = phase_kernel(fa, torch)
    fused_errors = phase_fused_kernel(fused, torch)
    encoder_launches = phase_encoder(torch)
    clip_model, pixels = phase_clip_encoder(torch)
    server = HttpServer()
    try:
        launches, add_seconds, n_docs, latencies = phase_serve(server, torch)
        clip_launches, clip_add_seconds = phase_clip_serve(server, torch)
    finally:
        server.close()

    timing, vit = phase_timing(fa, fused, torch, clip_model, pixels)
    emit("timing", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         kernel_vs_twin=timing, vit_l14=vit,
         add_docs_per_s=n_docs / add_seconds, add_seconds=add_seconds,
         clip_add_docs_per_s=CLIP_DOCS / clip_add_seconds,
         clip_add_seconds=clip_add_seconds,
         search_median_ms=statistics.median(latencies), search_ms=latencies,
         note="information only")

    def timed(kernel, mode, shape):
        return next(row for row in timing if row["kernel"] == kernel and
                    row["mode"] == mode and row["shape"] == shape)

    kernels = []
    for mode in ("padding", "segment"):
        row = timed("masked_attention", mode, [256, 12, 128, 64])
        kernels.append({
            "name": f"masked_attention_{mode}", "route": "cuda",
            "source": B1_SOURCE, "replaces": B1_REPLACES,
            "launches": launches[f"masked_attention_{mode}"],
            "max_abs_err": errors[mode], "ms": row["ms"],
            "plain_ms": row["plain_ms"]})
    # B2's no-mask mode at the ViT-L/14 shape, launched by the CLIP serve
    # path; its segment mode at the encoder's ingest shape, launched by the
    # encoder's "flash" path
    for mode, shape, counts in (
            ("nomask", [16, 16, 257, 64], clip_launches),
            ("segment", [256, 12, 128, 64], encoder_launches)):
        row = timed("fused_attention", mode, shape)
        kernels.append({
            "name": f"fused_attention_{mode}", "route": "cuda",
            "source": B2_SOURCE, "replaces": B2_REPLACES,
            "launches": counts[f"fused_attention_{mode}"],
            "max_abs_err": fused_errors[mode], "ms": row["ms"],
            "plain_ms": row["plain_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
