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
                   16/128/512 and at (32, 12, 128, 32) (the cross-encoder's
                   head dim); each on contiguous inputs and on the
                   encoders' own layouts (views of (B, S, N*D) projection
                   outputs, chunks of Stella's fused qkv projection); the
                   output must be the (B, S, N, D)-strided view; bf16
                   within 4e-3 + 1e-2 |ref|, a bound the twin with a
                   softmax scale off by 10% must fail (check_attention);
                   bf16 on both tile loops (the one ops/flash_attention.py
                   `tile_loop` picks, then the other, forced)
  4. fused_kernel  B2, flash attention, against its plain twin: no mask,
                   pad_mask and packed segment ids, fp32 and bf16, at
                   (4, 16, S, D) for the ViT towers' (tokens, head dim),
                   and at the main path's own shapes: (16, 16, 257, 64)
                   with no mask, (16, 12, 128, 64) padded and packed, and
                   the detectors' (1, 6, 197, 64) and (10, 12, 577, 64)
                   with no mask; in the same three layouts, on both bf16
                   tile loops and to the same bounds as phase 3
  5. quant_kernel  B3, the fused W8A8 linear layer, against its plain
                   twin, fp32 and bf16, equal bit for bit: M in
                   1/32/37/4096/17408 over the registry's BERT (K, N)
                   widths, ragged M, N and K (output rows whose stride is
                   not a multiple of 16 bytes among them), then e5-base's
                   four linear shapes ((768, 768), (768, 2304) for the
                   packed q, k, v, (768, 3072), (3072, 768)) at M = 32768,
                   17408 and 32; the int8 serve path's own (M, K, N) are
                   held in w8a8_path
  6. c1_shapes     ROADMAP C1's repair: B1 (both modes) at head dims 48, 72
                   and 80 on (32, 8, 128), B2 no-mask at SigLIP SO400M's
                   (8, 16, 729, 72), to phase 3's bounds; B3 at K = 5120 and
                   4112 (the two-pass quantizer) and int8 layers at K = 40
                   and 200 (zero-padded), bit for bit
  7. encoder       e5-base-v2-width encoder on the same random weights:
                   B1 ("kernel") and B2 ("flash") paths against the twin
                   path, padded and packed
  8. int8_encoder  the same width with quantize=True: the B3 path against
                   the twin path, padded and packed (four B3 launches per
                   block: q, k and v are one GEMM); the int8 encoder
                   against the bf16 one on the same weights
  9. clip_encoder  the ViT-L/14 towers at full width and depth, random
                   weights: the vision tower on B2 against the twin, batch 16
 10. serve         the in-process HTTP server: an e5-base-v2-width
                   random-init index, 256 documents of mixed lengths,
                   TENSOR and HYBRID searches and an embed; both B1 modes
                   must have run
 11. clip_serve    the same server: an open_clip ViT-L/14 random-init index
                   with treatUrlsAndPointersAsImages, 64 documents with an
                   image file, a caption and a multimodal_combination
                   field; TENSOR searches by text, by an image path and
                   weighted, and an image embed; B2's no-mask mode must
                   have run during the adds and the image search
 12. int8_serve    the serve phase's index with quantize: true; B3 must
                   have run during the adds and during the searches, B1 too;
                   B3's launches by linear layer (K, N) and M
 13. rerank        tensor_search.search on the serve phase's index with a
                   cross-encoder reranker at ms-marco-MiniLM-L-6 width: hits
                   re-sorted by the cross-encoder's scores, B1 padding ran
 14. stella_serve  an hf_stella random-init index at stella_en_400M_v5
                   width, 64 documents and the searches; B1 ran
 15. hf_clip_serve an xlm-roberta-base-ViT-B-32 random-init image index:
                   search by text and by image; B1 and B2 no-mask ran
 16. siglip_serve  the same server: a ViT-B-16-SigLIP random-init image
                   index at full width (Marqo/marqo-fashionSigLIP's shape),
                   searches by text and by image; exactly 12 B2 no-mask
                   launches per tower call; the vectors against the plain
                   twins' on the card (cosine >= 1 - 1e-3)
 17. coca_serve    an open_clip coca_ViT-L-14 random-init image index at
                   full width (text 768/12/12, vision 1024/24/16 at patch
                   14, 256 pooler queries, a 12-layer decoder): searches by
                   text and by image, exactly 24 B2 no-mask launches per
                   image tower call and none elsewhere; teacher-forced
                   caption logits on 4 pairs and an 8-token greedy caption;
                   vectors and logit rows against the plain twins (cosine
                   >= 1 - 1e-3)
 18. languagebind_serve
                   a LanguageBind random-init index at ViT-L/14 width: 3
                   WAV files (12 s, two 10 s chunks each, log-mel on the
                   card) and image documents, searches by audio and by
                   text; 24 B2 no-mask launches per audio (497 tokens) or
                   image tower call; against the plain twins
 19. languagebind_video
                   the video tower at VideoTowerConfig's defaults (ViT-L/14,
                   8 frames, temporal attention) on 2 videos: 48 B2 no-mask
                   launches per video (temporal at (257, 16, 8, 64), spatial
                   at (8, 16, 257, 64)); against the plain twins
 20. nllb_siglip_encode
                   NLLB-SigLIP base at full width (M2M-100 1024/16 heads,
                   vocab 256206; ViT-B-16 at 384 px): texts of mixed
                   lengths on B1 padding, images on B2 no-mask, against the
                   plain twins on the card
 21. conv_clip_encode
                   RN50 and convnext_base (224 px) at full width, text and
                   images; no kernel of ours runs there, so each bf16 tower
                   is held against itself in fp32 on the card
 22. eva02_encode  EVA02-L-14-336 at full width through load_model: 16
                   images (577 tokens, RoPE, SwiGLU 2730) with 24 B2
                   no-mask launches per image tower call, 16 texts; against
                   the plain twins
 23. patch_serve   the detector patch methods behind the same
                   server, random weights at full width: one index per
                   method (dino-v1, dino-v2, marqo-yolo, frcnn) on the
                   ViT-L/14 model, 8 images of 640x480; every add a 200,
                   every chunk a box inside its image, the full image
                   first; inside chunk_image exactly 11 B2 no-mask
                   launches per DINO image (ViT-S/16's first 11 blocks at
                   (1, 6, 197, 64)) and none for YOLOX-S or Faster R-CNN
                   R50-FPN, 24 per ViT-L/14 tower call outside it; an
                   image query finds its document; DINO's maps against
                   the twin's (cosine >= 0.999), YOLOX's and Faster
                   R-CNN's card outputs on 4 images, with cuDNN's TF32 on
                   as a served process has it, against the same module's
                   fp32 CPU run (1e-3 of each output group's largest
                   magnitude: the forward turns TF32 off for itself); the
                   control, the forward's body with TF32 on, misses it
 24. owl_rerank    OWL-ViT B/32 (google/owlvit-base-patch32's widths, 768
                   px, 577 tokens) as the "owl/ViT-B/32" reranker of an
                   HTTP search over 10 image hits: 12 B2 no-mask launches
                   per scoring call at (10, 12, 577, 64), scores in [0, 1]
                   and highlight boxes inside their images; logits
                   (cosine >= 0.999) and boxes (1e-2) against the twin's
 25. timing        kernel, twin and library-call times (attention on
                   contiguous inputs as earlier runs timed them, and at the
                   main-path shapes also in the encoders' own layout, which
                   the kernels line reports; each attention row with the
                   tile loop that served it, the other bf16 loop's ms on
                   the same inputs and its ratio to SDPA; queued behind
                   a device sleep), B3 against the bf16 F.linear it
                   replaces and torch._int_mm, B3's row quantizer and
                   GEMM apart (torch.profiler) against their bounds; C1's
                   head dims on B1, B2 at the SigLIP towers' shapes and at
                   the CoCa, EVA02 and LanguageBind towers' (NEW_B2_SHAPES),
                   B3 at K = 5120, each with its library call; the int8
                   against the bf16 e5 encoder, the bf16 e5 encoder padded
                   and packed on a log-normal ingest batch, ViT-L/14 images
                   per second on the kernel and twin paths, add throughput
                   and search latency (information only)
 26. detector_timing
                   B2 no-mask at DINO's and OWL-ViT's shapes (queued and
                   back to back, bound, twin, SDPA, launches on the
                   phase); the detectors' device ms per image come from
                   scripts/profile_torch_encoder.py

The CUDA graphs, before timing: encoder_graphs (e5-base bf16 and int8,
ViT-L/14, loaded and warmed afresh), family_graphs (every key the other
CLIP families, the DINO patchers and the OWL reranker captured while they
served) and last_family_graphs (every key Stella, the cross-encoder, the
YOLOX and Faster R-CNN patchers and LanguageBind's four towers captured
while they served, and Stella's warmup of a 1 x 16 query and a 16 x 128
batch): each key's replay on new inputs against the eager forward under
its config, bit for bit; the kernels' launches a replay as eager's (24
B1 a Stella batch, 6 a cross-encoder batch, 24 B2 a LanguageBind image
or audio call, 48 a video); the stale-input control; host, wall and
device ms and the busy share, eager against graph; capture seconds, keys
and the card's memory. The detectors' replays, with cuDNN's TF32 on in
the process, within 1e-3 of the fp32 CPU run; a graph captured from the
forward's body outside ``fp32_convolutions`` (TF32 on) must miss it.

B1's causal instances, after the graphs and before timing: dsv2_attention,
a two-layer deepseek_v2 checkpoint at DeepSeek-V2-Lite's latent attention
widths (16 heads, q/k 192, v 128) loaded through the hf type; one request
of the bulk-ingest cell's chunks (64 titles, 128 body chunks) through the
packed, graphed path and one query through the padded path, the launch
counters set to 0 just before each and read just after, with the shapes
launched (segment-causal on the packed path alone, padding-causal on the
query's); every launched shape against the twin, fp32 and bf16, at YaRN's
softmax scale, to phase 3's bounds with the scale control; the packed
path's most launched shape (segment) and the query's (padding) timed
queued beside the twin, SDPA with the same mask as a bias, and the bound
of their own mask; both rows join the kernels line.

The serving mesh (marqo_tpu_torch/parallel/) on the one card, as a virtual
mesh (the card repeated), forced with MARQO_TPU_SERVING_MESH=TRUE and
MARQO_TPU_MESH_SHAPE; every phase above serves without one:
 27. mesh_off      without the variable, one card gives no serving mesh
 28. mesh_serve    an e5-base-width index served over a (2, 2) mesh (6
                   heads a tp shard) through HTTP, padded and packed adds
                   and searches; one padded (32 x 128) and one packed batch
                   through the loaded model: exactly 12 x 2 x 2 B1 launches
                   each, at (16, 6, 128, 64) padded, every vector against
                   the same model on one device (cosine >= 0.999); B1
                   against its twin at the shard shapes (check_attention);
                   the time per batch against the unsharded model
 29. mesh_replicated
                   ViT-L/14 images and the int8 e5 encoder over a (2, 1)
                   mesh, replicated: 24 B2 launches per group per 16-image
                   call at (8, 16, 257, 64); 4 B3 launches a block per group
                   at M = 16 x 128; against one device (cosine >= 0.999)
 30. train_step    the contrastive train step at e5-base width on the
                   (2, 2) mesh: 5 bf16 steps on 32 query/passage pairs of
                   64 tokens, the loss finite and falling; step 1 in fp32
                   on (2, 2) within 1e-4 relative of (1, 1); step time and
                   peak memory
 31. mesh_timing   B1, B2 and B3 at the mesh phases' shard shapes (queued,
                   bound, twin, library call, launches on the phase)
 32. w8a8_path     B3 at every (M, K, N) int8_serve launched it, on bf16
                   inputs: equal to its twin bit for bit (the control,
                   the twin at 0.9 x w_scale, differs), then queued beside
                   its twin, its bound, the library yardstick and bf16
                   F.linear, and the sums weighted by the path's launches;
                   the kernels line's B3 row and error come from here

The launch path, after mesh_serve and before the in-process server closes:
 33. launch        scripts/run_marqo_tpu_torch.sh in fresh processes
                   (PyTorch's backend defaults, `python` on PATH as this
                   interpreter, the checkout on PYTHONPATH): with CUDA
                   hidden, startup fails and nothing serves; run A, one
                   API process with the in-process engine, the serve
                   phase's model preloaded (startup fails unless it was
                   warmed), /device/cuda names the card with memory in
                   use, 256 documents, 8 TENSOR and 8 HYBRID searches, 16
                   texts embedded one a request (bit for bit the
                   in-process server's, whose B1 launches are counted, and
                   not the twin's) and in one request (cosine >= 1 - 1e-3);
                   run B, the script's engine role on MARQO_ENGINE_PORT and
                   two API workers over it (file coordination, shared
                   settings), 64 documents, searches until both workers
                   have answered, each worker's /device/cuda; the engine
                   never loads PyTorch; SIGTERM to each run's process
                   group: every process gone and its port free within 30 s,
                   nvidia-smi's compute processes and the card's memory as
                   before

The engine's exact scan (approximate=False), after the in-process server
closes:
 34. exact_scan    (a) engine/torch_scorer.py on the card at 1,000,000
                   random unit rows x 768 (e5-base-v2's width), 1% deleted:
                   each metric's top 64 against fp32 numpy (every score
                   within 2^-7 of |score| of its row's, every row of the
                   fp32 top 64 that beats the 64th score by more than that
                   among the ids), device ms of score and top-k, host ms
                   of top_k, upload ms, peak memory; the store's host work
                   a search (the validity list, its copy); the control,
                   dotproduct's hits held to angular's closeness on rows
                   off unit norm, must fail. (b) The index made through an
                   API worker over the script's engine role, one document
                   read back from the engine; the corpus fed with the
                   port's StoreEngine into the engine's data dir and
                   snapshotted; the engine role restarted over it (the
                   device up, from the engine's log, before
                   /engine/health answers), a worker over it, 16 exact
                   searches by a context vector through its HTTP against
                   fp32 numpy, the first under the 1,000 ms search
                   timeout; an add of 64 documents, 4 more searches. (c)
                   An engine over 49,984 rows, without PyTorch; an add of
                   32 documents crosses MIN_ROWS_FOR_DEVICE and returns
                   before the device is up; then a search against numpy.
                   SIGTERM: every process gone, the card as before

then the card's name and power limit as nvidia-smi gives them, a
{"kernels": [...]} line (each kernel with the tile loop of its timed row
and its path's launches per loop), and as the last line
{"ok": true, "device": {...}}. Every kernel launch counter is set to 0 just
before each path (the encoders and the serve phases) and read just after
it. Every phase line after the build also carries ``loop_launches``, the
attention kernels' launches per tile loop since the line before; B2 must
have run on the wgmma loop alone in clip_serve, eva02_encode,
languagebind_serve and owl_rerank. Any failed check raises and the
script exits non-zero. Without a CUDA device, or outside a checkout, it
exits non-zero before printing anything. JAX is never imported.
"""

import json
import math
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
# The attention kernels against their twins: |out - ref| <= ATOL + RTOL
# |ref| elementwise. fp32: 1e-5 (tests/test_flash_attention.py:39). bf16:
# both sides round P and the output to bf16 (2^-8 relative), so the bound is
# a share of |ref| plus a floor for outputs that cancel; on attention_inputs
# a correct kernel stays well inside it, and a 10% error in the softmax
# scale lies far outside it (SCALE_CONTROL checks that on every bf16 case).
ATOL = {"float32": 1e-5, "bfloat16": 4e-3}
RTOL = {"float32": 0.0, "bfloat16": 1e-2}
# the wrong softmax scale the bf16 tolerance must refuse
SCALE_CONTROL = 0.9
E5_BASE = {"vocab_size": 30522, "hidden_size": 768, "num_layers": 12,
           "num_heads": 12, "intermediate_size": 3072}
# ViT-L/14 (bench.py:209-213, BASELINE config 3)
VIT_L14_TEXT = {"vocab_size": 49408, "hidden_size": 768, "num_layers": 12,
                "num_heads": 12, "intermediate_size": 3072,
                "max_positions": 77, "projection_dim": 768}
VIT_L14_VISION = {"image_size": 224, "patch_size": 14, "hidden_size": 1024,
                  "num_layers": 24, "num_heads": 16, "intermediate_size": 4096,
                  "projection_dim": 768}
# B1's checks, (S, B, D): the encoder's head dim 64 at S 16/128/512, and
# the cross-encoder's (MiniLM-L-6) head dim 32
B1_CASES = ((16, 32, 64), (128, 32, 64), (512, 8, 64), (128, 32, 32))
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
# cross-encoder/ms-marco-MiniLM-L-6-v2 (head dim 32)
MINILM_L6 = {"vocab_size": 30522, "hidden_size": 384, "num_layers": 6,
             "num_heads": 12, "intermediate_size": 1536}
# dunzhang/stella_en_400M_v5 (models/stella.py stella_400m_config)
STELLA_400M = {"vocab_size": 30528, "hidden_size": 1024, "num_layers": 24,
               "num_heads": 16, "intermediate_size": 4096,
               "rope_theta": 160000.0}
STELLA_DIMS = 1024
STELLA_DOCS = 64
# open_clip xlm-roberta-base-ViT-B-32: XLM-R base text tower, ViT-B/32
XLMR_VIT_B32 = {"vocab_size": 250002, "text_hidden_size": 768,
                "text_layers": 12, "text_heads": 12,
                "text_intermediate": 3072, "patch_size": 32,
                "vision_hidden_size": 768, "vision_layers": 12,
                "vision_heads": 12, "vision_intermediate": 3072}
XLMR_VIT_B32_DIMS = 512
HF_CLIP_DOCS = 32
# B3's (K, N) grid: the registry's BERT widths (hidden 384, 768, 1024 with
# FFN 1536, 3072, 4096) in each of the encoder's linear shapes, and e5's
# packed q, k, v (768, 3 x 768)
W8A8_WIDTHS = ((768, 768), (768, 2304), (768, 3072), (3072, 768),
               (384, 1536), (1024, 4096))
W8A8_GRID_M = (1, 32, 37, 4096, 17408)
# B3's ragged (M, K, N): K tails shorter than a 128-byte stage; N = 1, 13,
# 129, 100, 1030, 770 give output rows whose bf16 stride is not a multiple
# of 16 bytes (the GEMM's element-wise store path; all but 100 in fp32
# too); tiles overhanging M and N, at a query's M = 1 and 32 and at M large
# enough for the 128-wide tiles
W8A8_RAGGED = ((5, 16, 1), (3, 48, 13), (130, 80, 129), (1, 768, 100),
               (32, 768, 1030), (4097, 3072, 770))
# e5-base's four linear shapes (q, k and v packed into one), the (K, N) the
# int8 serve path gives B3, here over rows of a 256 x 128 padded batch, a
# 136 x 128 packed one and a 32-token query: a grid, not the path's rows,
# which come from its launch count and are held in phase_w8a8_path
W8A8_E5_M = (256 * 128, 136 * 128, 32)
W8A8_PATH_WIDTHS = ((768, 768), (768, 2304), (768, 3072), (3072, 768))
# ROADMAP C1's shapes: B1 at the head dims it took only after the repair
# (48: a 384-wide 8-head encoder; 72: SigLIP SO400M; 80: open_clip H) as
# (B, N, S, D); B2's no-mask mode at SigLIP SO400M/14 at 384 px (729
# tokens, D = 72); B3 on rows longer than the one-read quantizer holds
# (K = 5120, an FFN of that width, and 4112, just past 4096), and int8
# layers whose K is no multiple of 16 (zero-padded when they load)
C1_B1_CASES = tuple((32, 8, 128, D) for D in (48, 72, 80))
C1_B2_CASES = ((8, 16, 729, 72, ("nomask",)),)
C1_W8A8_CASES = ((4096, 5120, 1280), (37, 5120, 64), (5, 4112, 16))
C1_INT8_LAYER_K = (40, 200)
# ViT-B-16-SigLIP at full width (the shape of Marqo/marqo-fashionSigLIP;
# models/siglip.py _SIGLIP_ARCHS): 768 wide, 12 + 12 layers, 12 heads, MLP
# 3072, patch 16 at 224 px (196 tokens), 64 text positions, vocab 32000
SIGLIP_B16 = {"vocab_size": 32000, "context_length": 64, "patch_size": 16,
              "text_layers": 12, "text_heads": 12, "text_intermediate": 3072,
              "vision_layers": 12, "vision_heads": 12,
              "vision_intermediate": 3072}
SIGLIP_DIMS = 768
SIGLIP_DOCS = 32
# visheratin/nllb-clip-base-siglip (models/nllb_siglip.py NLLB_SIGLIP_ARCHS):
# the NLLB-200 distilled-600M encoder (1024 wide, 12 layers, 16 heads, FFN
# 4096, vocab 256206) and ViT-B-16 SigLIP at 384 px (576 tokens), 768-d
NLLB_SIGLIP_BASE = {"vocab_size": 256206, "text_hidden_size": 1024,
                    "text_layers": 12, "text_heads": 16,
                    "text_intermediate": 4096, "max_positions": 1024,
                    "patch_size": 16, "vision_layers": 12,
                    "vision_heads": 12, "vision_intermediate": 3072}
NLLB_SIGLIP_DIMS = 768
# open_clip RN50 and convnext_base at 224 px (models/resnet_clip.py
# RESNET_CONFIGS, models/convnext_clip.py CONVNEXT_CONFIGS) with their CLIP
# text towers (512 wide, 12 layers, 8 heads)
CLIP_TEXT_512 = {"vocab_size": 49408, "text_hidden_size": 512,
                 "text_layers": 12, "text_heads": 8, "text_intermediate": 2048}
RN50 = {**CLIP_TEXT_512, "layers": (3, 4, 6, 3), "width": 64, "heads": 32}
RN50_DIMS = 1024
CONVNEXT_BASE = {**CLIP_TEXT_512, "depths": (3, 3, 27, 3),
                 "dims": (128, 256, 512, 1024)}
CONVNEXT_BASE_DIMS = 512
# the convnet towers' bf16 output against the same module in fp32 on the
# card: cosine >= 1 - CONV_COS_TOL (the CPU tests' bf16 bound)
CONV_COS_TOL = 1e-3
# B2's no-mask mode on the SigLIP paths, (B, N, S, D), batch 16 as the
# serve phase's adds give it: ViT-B-16-SigLIP's text (64 positions) and
# image (196 patches) towers; SO400M/14 at 384 px (729 patches, D = 72)
SIGLIP_ATTENTION_SHAPES = ((16, 12, 64, 64), (16, 12, 196, 64),
                           (16, 16, 729, 72))
# open_clip coca_ViT-L-14 (models/coca.py coca_vit_l14_configs): text 768
# wide, 12 layers, 12 heads, vocab 49408 (76 positions and the CLS);
# vision 1024/24/16 at patch 14 (257 tokens); 256 pooler queries over 8
# heads; a 12-layer decoder as wide as the text tower; 768-d
COCA_L14 = {"vocab_size": 49408, "text_hidden_size": 768, "text_layers": 12,
            "text_heads": 12, "text_intermediate": 3072,
            "context_length": 76, "patch_size": 14,
            "vision_hidden_size": 1024, "vision_layers": 24,
            "vision_heads": 16, "vision_intermediate": 4096,
            "n_queries": 256, "pooler_heads": 8, "decoder_layers": 12}
COCA_DIMS = 768
COCA_DOCS = 32
# open_clip EVA02-L-14-336 (models/eva02.py EVA02_ARCHS): vision 1024/24/16
# at patch 14 and 336 px (577 tokens), SwiGLU 2730; text 768/12/12, vocab
# 49408; 768-d
EVA02_L14_336 = {"vocab_size": 49408, "text_hidden_size": 768,
                 "text_layers": 12, "text_heads": 12,
                 "text_intermediate": 3072, "patch_size": 14,
                 "vision_hidden_size": 1024, "vision_layers": 24,
                 "vision_heads": 16, "swiglu_hidden": 2730}
EVA02_DIMS = 768
EVA02_IMAGE_SIZE = 336
EVA02_BATCH = 16
# LanguageBind at ViT-L/14 width (the random-init wrapper gives every tower
# one width): 1024 wide, 24 layers, 16 heads, FFN 4096; images at patch 14
# (257 tokens); audio 128 mels x 992 frames at patch 16 (496 patches and
# the class token)
LANGUAGEBIND_L14 = {"vocab_size": 49408, "hidden_size": 1024,
                    "num_layers": 24, "num_heads": 16,
                    "intermediate_size": 4096, "patch_size": 14,
                    "audio_patch": 16, "audio_frames": 992}
LANGUAGEBIND_DIMS = 768
LANGUAGEBIND_IMAGE_SIZE = 224
# audio documents: WAV files of 12 s, two 10 s chunks each at the default
# audioPreprocessing (splitLength 10, splitOverlap 3); image documents
LANGUAGEBIND_CLIPS = 3
LANGUAGEBIND_CLIP_SECONDS = 12.0
LANGUAGEBIND_IMAGES = 4
# models/languagebind.py VideoTowerConfig's fields over its defaults
# (LanguageBind_Video: ViT-L/14, 8 frames, temporal attention) and the
# videos per run
VIDEO_TOWER = {}
VIDEO_COUNT = 2
# B2's no-mask mode at this slice's towers, (B, N, S, D): CoCa ViT-B-32 at
# batch 16 (50 tokens), EVA02-L-14-336 (577), LanguageBind audio (497), and
# one video's temporal (257 tokens x 8 frames) and spatial (8 frames x 257)
# attention; CoCa ViT-L-14 and LanguageBind images are the ViT-L/14 row
NEW_B2_SHAPES = ((16, 12, 50, 64), (16, 16, 577, 64), (16, 16, 497, 64),
                 (257, 16, 8, 64), (8, 16, 257, 64))
# The detector patch methods served on one index each, with
# 640x480 images, and the OWL-ViT reranker over this many image hits.
# B2's no-mask mode runs in DINO ViT-S/16's first 11 blocks at (1, 6, 197,
# 64) per image and in OWL-ViT B/32's 12 vision blocks at (hits, 12, 577,
# 64) per scoring call
PATCH_METHODS = ("dino-v1", "dino-v2", "marqo-yolo", "frcnn")
PATCH_IMAGES = 8
PATCH_IMAGE_SIZE = (640, 480)
OWL_HITS = 10
DINO_B2_SHAPE = (1, 6, 197, 64)
OWL_B2_SHAPE = (OWL_HITS, 12, 577, 64)
# kernel against twin: DINO maps and OWL-ViT logits at cosine >= 1 - this,
# OWL-ViT boxes within OWL_BOX_TOL; YOLOX and Faster R-CNN on the card, on
# DETECTOR_IMAGES of the phase's images, with cuDNN's TF32 as served (on),
# within DETECTOR_REL_TOL of the same module's fp32 CPU run, relative to
# each output's largest magnitude
DETECTOR_COS_TOL = 1e-3
OWL_BOX_TOL = 1e-2
DETECTOR_REL_TOL = 1e-3
DETECTOR_IMAGES = 4
# the OWL-ViT model of the rerank phase (OwlViTConfig fields; empty: the
# published google/owlvit-base-patch32 widths)
OWL_VIT = {}
# the serving mesh on the one card (parallel/): a (dp, tp) = (2, 2)
# virtual mesh for the e5-base-width encoder (6 heads a tp shard), a
# (2, 1) one for the towers and the int8 encoder, which replicate; the
# padded batch of MESH_BATCH texts at 128 tokens gives B1 MESH_B1_SHAPE a
# shard, 16 images give B2 MESH_B2_SHAPE a group
MESH_SHAPE = (2, 2)
MESH_REPLICATED = (2, 1)
MESH_DOCS = 64
MESH_BATCH = 32
MESH_IMAGES = 16
MESH_B1_SHAPE = (16, 6, 128, 64)
MESH_B2_SHAPE = (8, 16, 257, 64)
# the contrastive train step at e5-base width on the (2, 2) mesh
TRAIN_PAIRS = 32
TRAIN_TOKENS = 64
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
B3_SOURCE = "marqo_tpu_torch/csrc/w8a8_matmul.cu"
B3_REPLACES = "marqo_tpu/ops/quant_matmul.py:36"
# one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
# bf16 tensor cores, int8 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(condition, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


# each emitted phase's launches per tile loop of the attention kernels
# (``read_loop_counts`` since the previous emit), by phase name
PHASE_LOOPS = {}
_loop_mark = {}


def emit(phase: str, **fields) -> None:
    """Print one phase's JSON line. Once the kernels' modules are loaded,
    the line carries ``loop_launches``: the attention kernels' launches per
    tile loop since the previous line (kept in PHASE_LOOPS)."""
    if "marqo_tpu_torch.ops.fused_attention" in sys.modules:
        now = read_loop_counts()
        if _loop_mark:
            PHASE_LOOPS[phase] = count_delta(_loop_mark, now)
            fields["loop_launches"] = PHASE_LOOPS[phase]
        _loop_mark.update(now)
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


def queued_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` where one call holds the host longer
    than the device (small shapes): the calls queue behind a device-side
    sleep long enough for the host to enqueue them all (200 µs of host
    time a call at the card's ~2 GHz), so the events around them see the
    device run them back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 200e-6 * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_queued_ms(kernel, plain, library, iters: int) -> dict:
    """As ``paired_ms`` (plain, kernel, kernel, plain), each run queued
    (``queued_ms``), with the library call's queued time and the kernel's
    back-to-back time (``cuda_ms``: the host's, where it is the longer)."""
    p1 = queued_ms(plain, iters)
    k1 = queued_ms(kernel, iters)
    k2 = queued_ms(kernel, iters)
    p2 = queued_ms(plain, iters)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
            "library_ms": queued_ms(library, iters),
            "back_to_back_ms": cuda_ms(kernel, iters)}


def kernel_times_ms(fn, iters: int, names) -> dict:
    """Device ms per call of ``fn`` spent in the kernels whose names hold
    each of ``names``, from torch.profiler over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    totals = dict.fromkeys(names, 0.0)
    for event in prof.key_averages():
        if event.device_type.name != "CUDA":
            continue
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = event.cuda_time_total
        for name in names:
            if name in event.key:
                totals[name] += device_us
    return {name: us / 1000 / iters for name, us in totals.items()}


def paired_ms(kernel, plain, iters: int) -> dict:
    """plain, kernel, kernel, plain: drift shows as a gap in a pair."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}


def bound(bytes_moved: float, operations: float, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    memory_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    compute_ms = operations / peak_ops * 1e3
    return {"bound_ms": max(memory_ms, compute_ms),
            "bound_by": "bytes" if memory_ms >= compute_ms else "operations"}


def attention_bound(B, N, S, D, mode: str, ids=None, dv=None,
                    causal=False) -> dict:
    """What this run's mask needs, in bf16: q read and the output written in
    full; K and V of the keys some query may attend to, and V of every key
    of a batch row holding a query that may attend to none (its output is
    the uniform mean of V); the int32 mask or ids read once. Q.K^T over the
    allowed (query, key) pairs and P.V over those and over every key of a
    query that sees none, at 2 operations per multiply-add, on the bf16
    tensor-core peak. ``mode``: "nomask", "padding" and "segment" (B1's
    modes), or "fused_segment" (B2's, where id 0 is a segment too);
    ``causal``: keys after the query disallowed too; ``dv``: v's and the
    output's head dim where it is not q's and k's ``D``."""
    import torch
    dv = D if dv is None else dv
    if ids is None:
        k_keys = v_keys = B * S
        qk_pairs, blind_queries = B * S * S, 0
    else:
        ids = ids.cpu().long()
        if mode == "padding":
            allowed = (ids > 0)[:, None, :].expand(B, S, S)
        elif mode == "segment":
            allowed = ((ids[:, :, None] == ids[:, None, :]) &
                       (ids[:, None, :] > 0))
        else:
            allowed = ids[:, :, None] == ids[:, None, :]
        if causal:
            allowed = allowed & torch.ones(S, S, dtype=torch.bool).tril()
        seen = allowed.any(1)     # (B, S) keys some query attends to
        blind = ~allowed.any(2)   # (B, S) queries that attend to none
        k_keys = int(seen.sum())
        v_keys = int(torch.where(blind.any(1), S, seen.sum(1)).sum())
        qk_pairs, blind_queries = int(allowed.sum()), int(blind.sum())
    bytes_moved = (B * S * (D + dv) + k_keys * D + v_keys * dv) * N * 2 + (
        0 if ids is None else 4 * B * S)
    operations = 2 * N * (D * qk_pairs + dv * (qk_pairs + blind_queries * S))
    return bound(bytes_moved, operations, PEAK_BF16_FLOPS)


def w8a8_bound(M, K, N) -> dict:
    """bf16 x read, int8 w_q and fp32 w_scale and bias read, bf16 out
    written once; 2 M K N int8 operations on the int8 tensor-core peak."""
    return bound(M * K * 2 + N * K + N * 8 + M * N * 2, 2 * M * K * N,
                 PEAK_INT8_OPS)


def quantize_bound(M, K) -> dict:
    """B3's row quantizer alone: bf16 x read, int8 x_q and fp32 x_scale
    written once (its few operations never bound it)."""
    return bound(M * K * 2 + M * K + M * 4, 0, PEAK_INT8_OPS)


# kernel names (csrc/w8a8_matmul.cu) that split B3's time in a profile
W8A8_KERNELS = ("w8a8_quantize_rows", "w8a8_gemm")


# --- launch counters ---------------------------------------------------------

def _counter_modules():
    from marqo_tpu_torch.ops import (flash_attention, fused_attention,
                                     quant_matmul)
    return {"masked_attention": flash_attention, "fused_attention":
            fused_attention, "w8a8_matmul": quant_matmul}


def reset_counts() -> None:
    for module in _counter_modules().values():
        for mode in module.LAUNCHES:
            module.LAUNCHES[mode] = 0


def read_counts() -> dict:
    """{kernel}_{mode} for the attention kernels, w8a8_matmul for B3."""
    return {name if len(module.LAUNCHES) == 1 else f"{name}_{mode}": count
            for name, module in _counter_modules().items()
            for mode, count in module.LAUNCHES.items()}


def count_delta(before: dict, after: dict) -> dict:
    return {name: after[name] - before[name] for name in after}


ATTENTION_COUNTERS = ("masked_attention", "fused_attention")


def read_loop_counts() -> dict:
    """{kernel}_{loop}: the attention kernels' launches per tile loop
    (LOOP_LAUNCHES, never reset: phases read their deltas)."""
    modules = _counter_modules()
    return {f"{name}_{loop}": count
            for name in ATTENTION_COUNTERS
            for loop, count in modules[name].LOOP_LAUNCHES.items()}


def check_loop(phase: str, kernel: str, loop: str) -> dict:
    """The phase's launches of ``kernel`` all ran on the tile loop
    ``loop``, and at least one did. Returns the kernel's counts."""
    counts = {name[len(kernel) + 1:]: n for name, n in
              PHASE_LOOPS[phase].items() if name.startswith(kernel + "_")}
    check(counts[loop] > 0 and sum(counts.values()) == counts[loop],
          f"{phase}: {kernel} ran on the tile loops {counts}, not only on "
          f"{loop}")
    return counts


# the bf16 tile loop a row was not served by, which the checks and the
# timing also run on the same inputs
OTHER_LOOP = {"wgmma": "mma_sync", "mma_sync": "wgmma"}


# --- inputs ------------------------------------------------------------------

def attention_inputs(B, N, S, D, dtype, seed):
    """Inputs for both attention kernels, on the card: q, k (B, N, S, D)
    ~ N(0, 1), so the scores have unit variance and the softmax is peaked
    (a wrong scale or a wrong key moves the output), and v ~ 0.3*N(0, 1)
    (tests/test_fused_attention.py's scale); a padding mask whose first
    rows are full, 1-token, half and all-pad; packed segment ids with
    several documents per row, a pad tail of 0 (pad queries) and an
    all-pad last row."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(scale * rng.standard_normal(
        (B, N, S, D), dtype=np.float32)).to(DEVICE, dtype)
        for scale in (1.0, 1.0, 0.3))
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


def mla_inputs(B, N, S, dtype, seed):
    """Inputs for B1's causal modes at DeepSeek-V2's latent attention
    widths, as the model hands them to the kernel: q, k (B, N, S, 192)
    views of (B, S, N, 192) tensors and v (B, N, S, 128) the value half of
    a (B, S, N, 256) kv_b output; q, k ~ N(0, 1), v ~ 0.3 N(0, 1); and
    attention_inputs' padding mask and segment ids."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(B, S, N, 192, generator=g, device=DEVICE).to(dtype)
    k = torch.randn(B, S, N, 192, generator=g, device=DEVICE).to(dtype)
    kv = (0.3 * torch.randn(B, S, N, 256, generator=g, device=DEVICE)
          ).to(dtype)
    _, _, _, pad, seg = attention_inputs(B, N, S, 8, dtype, seed)
    return (q.transpose(1, 2), k.transpose(1, 2),
            kv[..., 128:].transpose(1, 2), pad, seg)


PROJECTION_LAYOUTS = ("projection", "fused_qkv")


def projection_views(q, k, v, layout):
    """q, k, v (B, N, S, D) with the same values, laid out as the encoders
    hand them to the kernels: "projection", views x.view(B, S, N,
    D).transpose(1, 2) of one (B, S, N*D) tensor each (BERT, CLIP);
    "fused_qkv", chunks of one (B, S, 3*N*D) tensor (Stella's fused qkv
    projection)."""
    import torch
    B, N, S, D = q.shape
    if layout == "projection":
        views = [torch.empty(B, S, N * D, dtype=t.dtype, device=t.device)
                 .view(B, S, N, D).transpose(1, 2) for t in (q, k, v)]
    else:
        fused = torch.empty(B, S, 3 * N * D, dtype=q.dtype, device=q.device)
        views = [c.reshape(B, S, N, D).transpose(1, 2)
                 for c in fused.chunk(3, dim=-1)]
    for view, t in zip(views, (q, k, v)):
        view.copy_(t)
    return views


def is_projection_layout(out) -> bool:
    """out is a (B, N, S, D) view of a dense (B, S, N, D) tensor."""
    return out.transpose(1, 2).is_contiguous()


def w8a8_inputs(M, K, N, dtype, seed):
    """Inputs for B3, on the card: x (M, K) ~ N(0, 1) with rows scaled over
    four decades, an all-zero row (its scale is the 1e-8 floor) and one row
    holding a single outlier; w_q (N, K) int8 and w_scale (N,) from
    quantize_weight of 0.05*N(0, 1) weights; bias (N,) ~ N(0, 1), fp32."""
    import numpy as np
    import torch

    from marqo_tpu_torch.ops.quant import quantize_weight
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    x *= (10.0 ** rng.uniform(-2, 2, (M, 1))).astype(np.float32)
    x[0] = 0
    if M > 1:
        x[1, K // 2] = 1000.0
    w = 0.05 * rng.standard_normal((N, K), dtype=np.float32)
    w_q, w_scale = quantize_weight(torch.from_numpy(w))
    bias = torch.from_numpy(rng.standard_normal(N, dtype=np.float32))
    return (torch.from_numpy(x).to(DEVICE, dtype), w_q.to(DEVICE),
            w_scale.to(DEVICE), bias.to(DEVICE))


def bf16_ulp(t):
    """The spacing of bf16 values at |t| (8 significant bits), elementwise."""
    import torch
    tiny = torch.finfo(torch.bfloat16).tiny
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(tiny)))
                      - 7)


def attention_excess(out, ref) -> float:
    """The largest |out - ref| - RTOL |ref| over the elements: the attention
    kernels' output is within tolerance of its twin's iff this is at most
    ATOL of their dtype."""
    dname = str(out.dtype).split(".")[-1]
    ref = ref.float()
    return float(((out.float() - ref).abs() - RTOL[dname] * ref.abs()).max())


def check_attention(out, ref, control, label: str) -> dict:
    """Hold an attention kernel's output against its twin's ``ref``; in
    bf16, ``control`` (the twin with the softmax scale off by
    SCALE_CONTROL, or None where no row can show it) must fail the same
    tolerance, or the check could not see such a fault. Returns the largest
    absolute error, the excess and the control's excess (None if none)."""
    dname = str(out.dtype).split(".")[-1]
    excess = attention_excess(out, ref)
    check(excess <= ATOL[dname], f"{label}: |out - ref| exceeds {ATOL[dname]} "
          f"+ {RTOL[dname]} |ref| by {excess - ATOL[dname]}")
    missed = None
    if control is not None and dname == "bfloat16":
        missed = attention_excess(control, ref)
        check(missed > ATOL[dname], f"{label}: the bf16 tolerance passes a "
              f"softmax scale off by {SCALE_CONTROL} (excess {missed})")
    return {"max_abs_err": float((out.float() - ref.float()).abs().max()),
            "excess": excess, "control_excess": missed}


def write_images(directory: str, n: int, seed: int, size=None) -> list:
    """PNG files from a numpy seed: a colour field under a gradient and
    noise, 160x120 to 640x480, both orientations, or all (w, h) =
    ``size``."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        w, h = int(rng.integers(160, 641)), int(rng.integers(120, 481))
        if size is not None:
            w, h = size
        elif i % 2:
            w, h = h, w
        base = rng.integers(0, 256, size=3)
        ramp = np.linspace(0, 1, w)[None, :, None] * rng.integers(
            -120, 120, size=3)
        noise = rng.normal(0, 25, size=(h, w, 3))
        pixels = np.clip(base + ramp + noise, 0, 255).astype(np.uint8)
        paths.append(os.path.join(directory, f"img{i}.png"))
        Image.fromarray(pixels).save(paths[-1])
    return paths


def np_finite(array) -> bool:
    import numpy as np
    return bool(np.isfinite(array).all())


def min_cos(a, b) -> float:
    import torch
    return float(torch.nn.functional.cosine_similarity(a, b).min())


# --- phases ------------------------------------------------------------------

def layouts(q, k, v, names=("contiguous",) + PROJECTION_LAYOUTS):
    """(name, q, k, v) for each layout named: "contiguous", the inputs as
    they are; the others, the same values in that projection layout."""
    for name in names:
        yield ((name, q, k, v) if name == "contiguous" else
               (name, *projection_views(q, k, v, name)))


def kernel_outputs(out, launch, S, D, dtype):
    """(loop, output) of an attention kernel on one call: ``out``, what the
    wrapper returned on the loop its rule picks; in bf16 also the other
    bf16 loop's, from ``launch(loop)`` on the same inputs, so each check
    holds both loops (fp32 has one loop)."""
    import torch

    from marqo_tpu_torch.ops.flash_attention import tile_loop
    loop = tile_loop(S, D, dtype)
    outputs = [(loop, out)]
    if loop in OTHER_LOOP:
        outputs.append((OTHER_LOOP[loop], launch(OTHER_LOOP[loop])))
    torch.cuda.synchronize()
    return outputs


def b1_checks(fa, torch, cases):
    """B1 against its twin, both modes, fp32 and bf16, over (B, N, S, D)
    cases in the contiguous and the projection layouts. Returns the
    results and the largest absolute error per mode."""
    errors = {"padding": 0.0, "segment": 0.0}
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, N, S, D in cases:
            shape = [B, N, S, D]
            q, k, v, pad, seg = attention_inputs(B, N, S, D, dtype, seed=S)
            for layout, q, k, v in layouts(q, k, v):
                for mode, mask, kernel, plain in (
                        ("padding", pad, fa.attention_padding,
                         fa.attention_padding_reference),
                        ("segment", seg, fa.attention_segment,
                         fa.attention_segment_reference)):
                    ref = plain(q, k, v, mask)
                    control = plain(q * SCALE_CONTROL, k, v, mask)
                    for loop, out in kernel_outputs(
                            kernel(q, k, v, mask),
                            lambda loop: fa._launch(q, k, v, mask, mode,
                                                    loop=loop), S, D, dtype):
                        check(out.dtype == dtype and out.shape == q.shape and
                              is_projection_layout(out),
                              f"kernel output {out.dtype} {tuple(out.shape)} "
                              f"strides {out.stride()}")
                        label = (f"kernel vs twin ({mode}, {dname}, {shape}, "
                                 f"{layout}, {loop})")
                        check(bool(torch.isfinite(out).all()),
                              f"non-finite output: {label}")
                        result = check_attention(out, ref, control, label)
                        results.append({"mode": mode, "dtype": dname,
                                        "shape": shape, "layout": layout,
                                        "loop": loop, **result})
                        errors[mode] = max(errors[mode],
                                           result["max_abs_err"])
    return results, errors


def b2_checks(fused, torch, cases):
    """B2 against its twin, fp32 and bf16, over (B, N, S, D, modes) cases
    in the contiguous and the projection layouts. Returns the results and
    the largest absolute error per mode."""
    errors = {"nomask": 0.0, "segment": 0.0}
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, N, S, D, names in cases:
            shape = [B, N, S, D]
            q, k, v, pad, seg = attention_inputs(B, N, S, D, dtype,
                                                 seed=B * S * D)
            masks = {"nomask": {}, "pad_mask": {"pad_mask": pad},
                     "segment_ids": {"segment_ids": seg}}
            for layout, q, k, v in layouts(q, k, v):
                for name in names:
                    mask = masks[name]
                    mode = "segment" if mask else "nomask"
                    ref = fused.fused_attention_reference(q, k, v, **mask)
                    control = fused.fused_attention_reference(
                        q * SCALE_CONTROL, k, v, **mask)
                    ids = fused._segment_ids(mask.get("pad_mask"),
                                             mask.get("segment_ids"))
                    for loop, out in kernel_outputs(
                            fused.fused_attention(q, k, v, **mask),
                            lambda loop: fused._launch(q, k, v, ids,
                                                       loop=loop), S, D,
                            dtype):
                        check(out.dtype == dtype and out.shape == q.shape and
                              is_projection_layout(out),
                              f"fused output {out.dtype} {tuple(out.shape)} "
                              f"strides {out.stride()}")
                        label = (f"fused kernel vs twin ({name}, {dname}, "
                                 f"{shape}, {layout}, {loop})")
                        check(bool(torch.isfinite(out).all()),
                              f"non-finite output: {label}")
                        result = check_attention(out, ref, control, label)
                        results.append({"mode": name, "dtype": dname,
                                        "shape": shape, "layout": layout,
                                        "loop": loop, **result})
                        errors[mode] = max(errors[mode],
                                           result["max_abs_err"])
    return results, errors


def w8a8_check(qm, torch, M, K, N, dtype) -> dict:
    """B3 at (M, K, N) against its twin: equal bit for bit."""
    dname = str(dtype).split(".")[-1]
    x, w_q, w_scale, bias = w8a8_inputs(M, K, N, dtype, seed=M + K + N)
    out = qm.w8a8_matmul(x, w_q, w_scale, bias)
    torch.cuda.synchronize()
    ref = qm.w8a8_matmul_reference(x, w_q, w_scale, bias)
    check(out.dtype == dtype and tuple(out.shape) == (M, N),
          f"w8a8 output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()),
          f"non-finite w8a8 output ({dname}, {M}, {K}, {N})")
    abs_err = float((out.float() - ref.float()).abs().max())
    unequal = int((out != ref).sum())
    check(torch.equal(out, ref),
          f"w8a8 kernel vs twin ({dname}, {M}, {K}, {N}): {unequal} "
          f"values differ, max |out - ref| {abs_err}")
    return {"dtype": dname, "shape": [M, K, N], "unequal": unequal,
            "max_abs_err": abs_err}


def phase_kernel(fa, torch):
    results, errors = b1_checks(fa, torch, [(B, 12, S, D)
                                            for S, B, D in B1_CASES])
    emit("kernel", ok=True, atol=ATOL, rtol=RTOL, checks=len(results),
         results=results)
    return errors


def phase_fused_kernel(fused, torch):
    detectors = tuple((*shape, ("nomask",))
                      for shape in (DINO_B2_SHAPE, OWL_B2_SHAPE))
    results, errors = b2_checks(fused, torch, FUSED_CASES + detectors)
    emit("fused_kernel", ok=True, atol=ATOL, rtol=RTOL, checks=len(results),
         results=results)
    return errors


def phase_quant_kernel(qm, torch):
    """B3 against its twin over the test grid, the ragged cases and at
    e5-base's widths: equal bit for bit (the int32 sum is exact and both
    round each step alike). The int8 serve path's own shapes are held in
    phase_w8a8_path."""
    results = []
    cases = [(M, K, N) for M in W8A8_GRID_M for K, N in W8A8_WIDTHS]
    cases += list(W8A8_RAGGED)
    cases += [(M, K, N) for M in W8A8_E5_M for K, N in W8A8_PATH_WIDTHS]
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N in cases:
            results.append(w8a8_check(qm, torch, M, K, N, dtype))
    emit("quant_kernel", ok=True, tolerance="exact (torch.equal)",
         checks=len(results), results=results)


def phase_c1_shapes(fa, fused, qm, torch):
    """ROADMAP C1's repair on the card: B1, both modes, at head dims 48, 72
    and 80; B2's no-mask mode at SigLIP SO400M's (729 tokens, D = 72), both
    within the attention bound with the x0.9-scale control; B3 at K = 5120
    and 4112, and int8 layers whose K is no multiple of 16 (zero-padded
    weights, x padded to match), equal to their twins bit for bit."""
    from marqo_tpu_torch.models import bert
    b1_results, b1_errors = b1_checks(fa, torch, C1_B1_CASES)
    b2_results, b2_errors = b2_checks(fused, torch, C1_B2_CASES)
    w8a8_results = [w8a8_check(qm, torch, M, K, N, dtype)
                    for dtype in (torch.float32, torch.bfloat16)
                    for M, K, N in C1_W8A8_CASES]
    layer_results = []
    for dtype in (torch.float32, torch.bfloat16):
        for K in C1_INT8_LAYER_K:
            rng = torch.Generator(device=DEVICE).manual_seed(K)
            weight = (0.05 * torch.randn(96, K, generator=rng,
                                         device=DEVICE)).to(dtype)
            bias = torch.randn(96, generator=rng, device=DEVICE).to(dtype)
            x = torch.randn(33, K, generator=rng, device=DEVICE).to(dtype)
            layer = bert.Int8Linear.from_weight(weight, bias)
            before = qm.LAUNCHES["w8a8"]
            out = layer(x)
            torch.cuda.synchronize()
            w_q, w_scale = bert.quantize_weight(weight)
            ref = bert.int8_linear_reference(x, w_q, w_scale, bias)
            check(qm.LAUNCHES["w8a8"] == before + 1 and
                  torch.equal(out, ref),
                  f"int8 layer at K={K} ({dtype}) vs the unpadded twin")
            layer_results.append({"dtype": str(dtype).split(".")[-1],
                                  "K": K, "kernel_K": layer.weight_q.shape[1],
                                  "max_abs_err": float(
                                      (out.float() - ref.float()).abs().max())})
    emit("c1_shapes", ok=True, atol=ATOL, rtol=RTOL,
         tolerance_w8a8="exact (torch.equal)",
         checks=len(b1_results) + len(b2_results) + len(w8a8_results) +
         len(layer_results), b1=b1_results, b2=b2_results,
         w8a8=w8a8_results, int8_layer=layer_results)
    return b1_errors, b2_errors


def phase_int8_encoder(torch):
    """An e5-base-width encoder with quantize=True on random weights: the
    B3 path against the twin path, padded and packed; then the same weights
    unquantized in bf16. Returns both encoders for the timing phase."""
    import copy
    from dataclasses import replace

    from marqo_tpu_torch.models.bert import (TextEncoderConfig,
                                             encode_tokens,
                                             encode_tokens_packed,
                                             init_encoder, quantize_encoder)
    from marqo_tpu_torch.ops.packing import pack_sequences
    config = TextEncoderConfig(**E5_BASE)
    generator = torch.Generator(device=DEVICE).manual_seed(7)
    float_encoder = init_encoder(config, generator, dtype=torch.bfloat16,
                                 device=DEVICE)
    encoder = quantize_encoder(copy.deepcopy(float_encoder))
    int8_config = encoder.config
    rng = torch.Generator().manual_seed(8)
    B, S = 16, 128
    lengths = torch.randint(4, S + 1, (B,), generator=rng)
    ids = torch.randint(5, config.vocab_size, (B, S), generator=rng,
                        dtype=torch.int32)
    mask = (torch.arange(S)[None] < lengths[:, None]).int()
    ids = ids * mask
    packed = pack_sequences([ids[i, :lengths[i]].numpy() for i in range(B)],
                            seq_len=S, pad_id=0)
    on = {name: torch.from_numpy(getattr(packed, name)).to(DEVICE)
          for name in ("input_ids", "segment_ids", "positions", "seq_index")}

    def run(model, linear_impl="kernel"):
        model.config = replace(model.config, linear_impl=linear_impl)
        with torch.inference_mode():
            padded = encode_tokens(model, ids.to(DEVICE), mask.to(DEVICE))
            pk = encode_tokens_packed(model, on["input_ids"],
                                      on["segment_ids"], on["positions"],
                                      on["seq_index"], packed.n_sequences)
        return padded, pk

    reset_counts()
    plain_padded, plain_packed = run(encoder, "plain")
    padded, packed_out = run(encoder)
    launches = read_counts()
    encoder.config = int8_config
    bf16_padded, _ = run(float_encoder)
    cos = {"padded_kernel_vs_plain": min_cos(padded, plain_padded),
           "packed_kernel_vs_plain": min_cos(packed_out, plain_packed),
           "padded_int8_vs_bf16": min_cos(padded, bf16_padded)}
    for name in ("padded_kernel_vs_plain", "packed_kernel_vs_plain"):
        check(cos[name] > 1 - 1e-3, f"int8 encoder {name}: cosine "
              f"{cos[name]}")
    check(cos["padded_int8_vs_bf16"] > 0.99,
          f"int8 encoder against bf16: cosine {cos['padded_int8_vs_bf16']}")
    check(padded.shape == (B, E5_BASE["hidden_size"]) and
          bool(torch.isfinite(padded).all()),
          "int8 encoder output shape/finiteness")
    # four linear layers per block (q, k and v in one), padded and packed
    expected = 2 * 4 * config.num_layers
    check(launches["w8a8_matmul"] == expected,
          f"int8 encoder: expected {expected} B3 launches: {launches}")
    emit("int8_encoder", ok=True, shape=[B, S], packed_rows=int(
        packed.input_ids.shape[0]), min_cosine=cos, launches=launches)
    return encoder, float_encoder


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
        self.config = generate_config()
        on_start(self.config)
        self.server = serve(build_app(self.config), host="127.0.0.1", port=0,
                            background=True)
        self.port = self.server.server_address[1]

    def req(self, method, path, body=None):
        status, answer = http_json(self.port, method, path, body)
        check(status < 400, f"{method} {path}: {status} {answer}")
        return answer

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _loaded_models(model_type) -> list:
    from marqo_tpu_torch.inference import vectorise
    return [entry["model"] for entry in vectorise._available_models.values()
            if isinstance(entry["model"], model_type)]


def _model_devices(model_type) -> set:
    """Devices of every parameter and buffer (the int8 weights are
    buffers) of the loaded models of ``model_type``."""
    return {str(t.device.type) for model in _loaded_models(model_type)
            for t in (*model.encoder.parameters(), *model.encoder.buffers())}


def text_docs(torch, n_docs: int, seed: int = 3):
    """``n_docs`` documents of mixed lengths (a title of 2-6 words, a body
    of 3-59), and the function that drew them: ``text(n)`` gives n more
    words from the same generator."""
    rng = torch.Generator().manual_seed(seed)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
             "golf", "hotel", "india", "juliet", "kilo", "lima", "mike",
             "november", "oscar", "papa", "quebec", "romeo", "sierra"]

    def text(n_words):
        idx = torch.randint(0, len(words), (n_words,), generator=rng)
        return " ".join(words[i] for i in idx.tolist())

    docs = [{"_id": f"d{i}", "title": text(2 + i % 5),
             "body": text(int(torch.randint(3, 60, (1,), generator=rng)))}
            for i in range(n_docs)]
    return docs, text


def serve_text_index(server, torch, index: str, props: dict, n_docs: int,
                     dims: int) -> dict:
    """Drive one text index through HTTP: create it, add ``n_docs``
    documents of mixed lengths (a one-document add first loads the model),
    run 8 TENSOR and 8 HYBRID searches, query a document's own text and
    embed. Launch counts are set to 0 before the first add; returns them
    after the adds, over the searches and at the end, and the seconds of
    each CUDA graph the index's model captured at a first use (the
    in-process server warms no model), by bucket."""
    from marqo_tpu_torch.inference.loaders import TorchHFTextModel
    req = server.req
    req("POST", f"/indexes/{index}",
        {"model": props["name"], "modelProperties": props})
    docs, text = text_docs(torch, n_docs)
    fields = {"tensorFields": ["title", "body"]}
    reset_counts()
    # the first add loads the model onto the card: keep it out of the
    # timed adds
    res = req("POST", f"/indexes/{index}/documents",
              {"documents": [{"_id": "warm", "title": text(4),
                              "body": text(30)}], **fields})
    check(res["errors"] is False, f"{index} add_documents errors: {res}")
    start = time.perf_counter()
    for b in range(0, len(docs), 64):
        res = req("POST", f"/indexes/{index}/documents",
                  {"documents": docs[b:b + 64], **fields})
        check(res["errors"] is False, f"{index} add_documents errors: {res}")
    add_seconds = time.perf_counter() - start
    add_launches = read_counts()
    latencies = []
    for i in range(8):
        for method in ("TENSOR", "HYBRID"):
            t0 = time.perf_counter()
            res = req("POST", f"/indexes/{index}/search",
                      {"q": text(3 + i), "searchMethod": method,
                       "limit": 5})
            latencies.append((time.perf_counter() - t0) * 1000)
            check(len(res["hits"]) > 0, f"{index} {method} search: no hits")
    # a document's own text finds that document first
    probe = max(docs, key=lambda d: len(d["body"]))
    res = req("POST", f"/indexes/{index}/search",
              {"q": probe["body"], "searchMethod": "TENSOR", "limit": 3})
    check(res["hits"][0]["_id"] == probe["_id"],
          f"{index} own-text query: top hit {res['hits'][0]['_id']}, "
          f"expected {probe['_id']}")
    search_launches = count_delta(add_launches, read_counts())
    emb = req("POST", f"/indexes/{index}/embed",
              {"content": ["alpha bravo charlie"]})["embeddings"]
    norm = float(torch.tensor(emb[0]).norm()) if len(emb) == 1 else 0.0
    check(len(emb) == 1 and len(emb[0]) == dims and abs(norm - 1) < 1e-3,
          f"{index} embed: expected one unit {dims}-d vector (norm {norm})")
    launches = read_counts()
    stats = req("GET", f"/indexes/{index}/stats")
    check(stats.get("numberOfDocuments") == n_docs + 1,
          f"{index} documents: {stats}")
    model = _loaded_model(TorchHFTextModel, props["name"])
    return {"docs": n_docs + 1, "add_seconds": add_seconds,
            "latencies": latencies, "launches": launches,
            "add_launches": add_launches,
            "search_launches": search_launches,
            "graph_captures": {graph_label(key): graph.seconds
                               for key, graph in model.graphs.graphs.items()},
            "documents_in_index": stats.get("numberOfDocuments"),
            "vectors_in_index": stats.get("numberOfVectors"),
            "own_text_top_hit": res["hits"][0]["_id"]}


def e5_props() -> dict:
    """The serve phase's random-init model at e5-base-v2's width: the same
    name gives the same weights in every process (the generator is seeded
    from the name)."""
    return {"name": "smoke-e5-base-v2", "type": "hf", "random_init": True,
            "pooling_method": "mean", "tokens": 128,
            "dimensions": E5_BASE["hidden_size"], "architecture": E5_BASE}


def phase_serve(server, torch):
    from marqo_tpu_torch.inference.loaders import TorchHFTextModel
    props = e5_props()
    run = serve_text_index(server, torch, "smoke", props, 256,
                           E5_BASE["hidden_size"])
    launches = run["launches"]
    devices = _model_devices(TorchHFTextModel)
    check(devices == {DEVICE}, f"model parameters on {devices}")
    check(launches["masked_attention_padding"] > 0 and
          launches["masked_attention_segment"] > 0,
          f"serve phase did not run both kernel modes: {launches}")
    emit("serve", ok=True, docs=run["docs"],
         documents_in_index=run["documents_in_index"],
         vectors_in_index=run["vectors_in_index"],
         searches=len(run["latencies"]), launches=launches,
         launches_during_add=run["add_launches"],
         graph_captures=run["graph_captures"],
         model_devices=sorted(devices))
    return run


def phase_int8_serve(server, torch):
    """The serve phase's e5-base-width index with ``quantize: true``: every
    linear layer of the encoder runs B3, in the adds and in the searches."""
    from marqo_tpu_torch.inference.loaders import TorchHFTextModel
    props = {**e5_props(), "name": "smoke-e5-base-v2-int8", "quantize": True}
    with LaunchShapes() as shapes:
        run = serve_text_index(server, torch, "smoke-int8", props, 256,
                               E5_BASE["hidden_size"])
    # B3's launches by linear layer (K, N), over every M the path gave it
    by_layer = {}
    for (counter, shape), n in shapes.shapes.items():
        if counter == "w8a8_matmul":
            M, K, N = shape
            layer = by_layer.setdefault(f"{K}x{N}", {"launches": 0, "M": {}})
            layer["launches"] += n
            layer["M"][str(M)] = layer["M"].get(str(M), 0) + n
    check(sum(layer["launches"] for layer in by_layer.values()) ==
          run["launches"]["w8a8_matmul"],
          f"int8 serve: B3 launches by layer {by_layer} against "
          f"{run['launches']['w8a8_matmul']}")
    run["w8a8_by_layer"] = by_layer
    models = [m for m in _loaded_models(TorchHFTextModel)
              if m.model_name == props["name"]]
    check(len(models) == 1 and models[0].config.quantize,
          "int8 serve: the index's model is not the quantized encoder")
    devices = {str(t.device.type) for t in models[0].encoder.buffers()}
    check(devices == {DEVICE}, f"int8 buffers on {devices}")
    for window, counts in (("adds", run["add_launches"]),
                           ("searches", run["search_launches"])):
        check(counts["w8a8_matmul"] > 0,
              f"B3 did not run during the int8 {window}: {counts}")
    check(run["launches"]["masked_attention_padding"] > 0,
          f"int8 serve did not run B1: {run['launches']}")
    emit("int8_serve", ok=True, docs=run["docs"],
         documents_in_index=run["documents_in_index"],
         vectors_in_index=run["vectors_in_index"],
         searches=len(run["latencies"]), launches=run["launches"],
         launches_during_add=run["add_launches"],
         launches_during_search=run["search_launches"],
         graph_captures=run["graph_captures"],
         w8a8_launches_by_layer=by_layer, buffer_devices=sorted(devices),
         memory_bytes=models[0].memory_bytes())
    return run


def phase_rerank(server, torch):
    """tensor_search.search on the serve phase's index with a cross-encoder
    reranker at ms-marco-MiniLM-L-6 width (random init): the hits come back
    re-sorted by the cross-encoder's scores, which B1's padding mode
    computed."""
    from marqo_tpu_torch.inference import rerank
    from marqo_tpu_torch.inference.types import Device
    from marqo_tpu_torch.tensor_search import tensor_search
    name = "smoke-ms-marco-MiniLM-L-6-v2"
    properties = {"random_init": True, "architecture": MINILM_L6}
    queries = ["alpha bravo charlie", "delta echo", "kilo lima mike oscar"]
    reset_counts()
    results = [tensor_search.search(
        server.config, "smoke", text=q, searchable_attributes=["title",
                                                               "body"],
        reranker=name, reranker_properties=properties, limit=10)
        for q in queries]
    launches = read_counts()
    # the reranker the searches loaded, on the device they served on
    model = rerank._get_reranker(name, Device.normalize(None), properties)
    check(str(model.model.encoder.embeddings.word.weight.device.type) ==
          DEVICE, "reranker is not on the card")
    for query, result in zip(queries, results):
        hits = result["hits"]
        scores = [h["_score"] for h in hits]
        check(len(hits) == 10 and scores == sorted(scores, reverse=True),
              f"rerank: hits not sorted by the new score: {scores}")
        texts = [f"{h['title']} {h['body']}" for h in hits]
        direct = model.score(query, texts)
        gap = float(abs(direct - torch.tensor(scores).numpy()).max())
        check(gap < 1e-3, f"rerank: scores differ from the cross-encoder's "
              f"by {gap}")
    check(launches["masked_attention_padding"] > 0,
          f"rerank did not run B1 padding mode: {launches}")
    GRAPHED_FAMILIES["cross_encoder"] = model
    emit("rerank", ok=True, queries=len(queries), hits=10,
         top_scores=[r["hits"][0]["_score"] for r in results],
         launches=launches, model_device=DEVICE,
         graphs=graph_state(torch, model.graphs))
    return launches


def phase_stella_serve(server, torch):
    """An hf_stella random-init index at stella_en_400M_v5 width: RoPE,
    gated MLP, the 1024-d projection head; attention in B1's padding
    mode."""
    from marqo_tpu_torch.inference.loaders import TorchStellaModel
    props = {"name": "smoke-stella-en-400m-v5", "type": "hf_stella",
             "random_init": True, "dimensions": STELLA_DIMS, "tokens": 512,
             "architecture": STELLA_400M}
    run = serve_text_index(server, torch, "stella", props, STELLA_DOCS,
                           STELLA_DIMS)
    devices = _model_devices(TorchStellaModel)
    check(devices == {DEVICE}, f"Stella parameters on {devices}")
    check(run["launches"]["masked_attention_padding"] > 0,
          f"stella serve did not run B1: {run['launches']}")
    model = GRAPHED_FAMILIES["stella"] = _loaded_model(TorchStellaModel,
                                                       props["name"])
    emit("stella_serve", ok=True, docs=run["docs"],
         documents_in_index=run["documents_in_index"],
         vectors_in_index=run["vectors_in_index"],
         searches=len(run["latencies"]), launches=run["launches"],
         launches_during_add=run["add_launches"],
         model_devices=sorted(devices),
         graph_captures=run["graph_captures"],
         graphs=graph_state(torch, model.graphs))
    return run


def phase_hf_clip_serve(server, torch):
    """An xlm-roberta-base-ViT-B-32 random-init index with
    treatUrlsAndPointersAsImages: the XLM-R text tower (B1 padding mode)
    and the ViT-B/32 tower (B2 no-mask mode); search by text and by
    image."""
    from marqo_tpu_torch.models.hf_clip import TorchHFCLIPModel
    req = server.req
    name = "smoke-xlm-roberta-base-ViT-B-32"
    props = {"name": name, "type": "open_clip", "random_init": True,
             "dimensions": XLMR_VIT_B32_DIMS, "image_size": 224,
             "architecture": XLMR_VIT_B32}
    req("POST", "/indexes/hfclip", {"model": name, "modelProperties": props,
                                    "treatUrlsAndPointersAsImages": True})
    colours = ["rouge", "vert", "bleu", "jaune", "violet", "orange", "gris",
               "blanc"]
    fields = {"tensorFields": ["image", "caption"]}
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_images(tmp, HF_CLIP_DOCS + 1, seed=11)
        docs = [{"_id": f"img{i}", "image": paths[i],
                 "caption": f"une photo {colours[i % 8]}, numéro {i}"}
                for i in range(HF_CLIP_DOCS)]
        reset_counts()
        # the first add loads the model onto the card
        res = req("POST", "/indexes/hfclip/documents", {
            "documents": [{"_id": "warm", "image": paths[-1],
                           "caption": "une photo"}], **fields})
        check(res["errors"] is False, f"hfclip add_documents errors: {res}")
        start = time.perf_counter()
        for b in range(0, HF_CLIP_DOCS, 16):
            res = req("POST", "/indexes/hfclip/documents",
                      {"documents": docs[b:b + 16], **fields})
            check(res["errors"] is False,
                  f"hfclip add_documents errors: {res}")
        add_seconds = time.perf_counter() - start
        add_launches = read_counts()
        res = req("POST", "/indexes/hfclip/search",
                  {"q": "une photo rouge", "searchMethod": "TENSOR",
                   "limit": 5})
        check(len(res["hits"]) > 0, "hfclip text search: no hits")
        probe = HF_CLIP_DOCS // 3
        res = req("POST", "/indexes/hfclip/search",
                  {"q": paths[probe], "searchMethod": "TENSOR", "limit": 3})
        check(res["hits"][0]["_id"] == f"img{probe}",
              f"hfclip image query: top hit {res['hits'][0]['_id']}, "
              f"expected img{probe}")
    launches = read_counts()
    GRAPHED_FAMILIES["xlmr_clip"] = _loaded_model(TorchHFCLIPModel, name)
    stats = req("GET", "/indexes/hfclip/stats")
    check(stats.get("numberOfDocuments") == HF_CLIP_DOCS + 1,
          f"hfclip index documents: {stats}")
    devices = _model_devices(TorchHFCLIPModel)
    check(devices == {DEVICE}, f"HF-CLIP parameters on {devices}")
    check(launches["masked_attention_padding"] > 0 and
          launches["fused_attention_nomask"] > 0,
          f"hfclip serve did not run B1 padding and B2 no-mask: {launches}")
    emit("hf_clip_serve", ok=True, docs=HF_CLIP_DOCS + 1,
         documents_in_index=stats.get("numberOfDocuments"),
         vectors_in_index=stats.get("numberOfVectors"),
         image_query_top_hit=res["hits"][0]["_id"], launches=launches,
         launches_during_add=add_launches, model_devices=sorted(devices),
         graphs=graph_state(torch, GRAPHED_FAMILIES["xlmr_clip"].graphs))
    return add_seconds


def vit_l14_props() -> dict:
    """The random-init open_clip ViT-L/14 index model of the CLIP serve
    phase (the patch and rerank phases' indexes load the same model)."""
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
    return {"name": "smoke-open-clip-vit-l-14", "type": "open_clip",
            "random_init": True, "dimensions": VIT_L14_VISION["projection_dim"],
            "image_size": VIT_L14_VISION["image_size"], "architecture": arch}


def phase_clip_serve(server, torch):
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    req = server.req
    props = vit_l14_props()
    dims = props["dimensions"]
    req("POST", "/indexes/clip", {"model": props["name"],
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


def _device():
    """The package's Device for DEVICE."""
    from marqo_tpu_torch.inference.types import Device
    return Device.CUDA if DEVICE == "cuda" else Device.CPU


def _loaded_model(model_type, name):
    models = [m for m in _loaded_models(model_type) if m.model_name == name]
    check(len(models) == 1, f"{name} is not loaded once: {len(models)}")
    return models[0]


# the models of the families phase_family_graphs holds to their CUDA
# graphs, registered by the phases that loaded them: a wrapper, or the
# DINO patcher or OWL reranker (each holds its own ``graphs``)
GRAPHED_FAMILIES = {}


def graph_state(torch, *caches) -> dict:
    """The keys captured in ``caches`` (EncoderGraphs) and the card's
    memory once the allocator's unused cached blocks are released, printed
    after each graphed family's phase: whether a served mix grows the
    graphs' pools."""
    mib = 2 ** 20
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"graph_keys": sum(len(cache.graphs) for cache in caches),
            "memory_allocated_mib": torch.cuda.memory_allocated() / mib,
            "memory_reserved_mib": torch.cuda.memory_reserved() / mib}


def _count_tower_calls(towers: dict, model_graphs=None):
    """Count each tower's batches on the card: an eager forward, seen by a
    forward hook outside a CUDA graph's capture (a key's warm run among
    them), or a replay of that tower's graph in ``model_graphs`` (the
    model's EncoderGraphs, inference/graphs.py; None for a model that
    runs eagerly). Returns the counts and handles whose ``remove()``
    takes the hooks and the wrapper off."""
    import torch

    from marqo_tpu_torch.inference import graphs
    calls = dict.fromkeys(towers, 0)
    replay = graphs.Graph.replay

    def hook(name):
        def count(*_):
            if not (torch.cuda.is_available() and
                    torch.cuda.is_current_stream_capturing()):
                calls[name] += 1
        return count

    def counted_replay(self):
        if model_graphs is not None and self.key[0] in calls and \
                model_graphs.graphs.get(self.key) is self:
            calls[self.key[0]] += 1
        return replay(self)

    class Restore:
        @staticmethod
        def remove():
            graphs.Graph.replay = replay

    graphs.Graph.replay = counted_replay
    return calls, [Restore] + [tower.register_forward_hook(hook(name))
                               for name, tower in towers.items()]


def _kernel_against_plain(model, torch, texts, images, media=None) -> dict:
    """Normalized vectors of the model's wrapper on the kernels and on
    the plain twins (``set_attention_impl``), same card, same weights:
    the least cosine between them, for text, for images and for each
    ``media`` kind ({kind: (modality, contents)})."""
    from marqo_tpu_torch.inference.types import Modality
    inputs = {"text": (Modality.TEXT, texts),
              "image": (Modality.IMAGE, images), **(media or {})}
    runs = {}
    for impl in ("plain", "kernel"):
        model.set_attention_impl(impl)
        runs[impl] = {kind: model.encode(contents, modality=modality)
                      for kind, (modality, contents) in inputs.items()}
    return {kind: float((runs["kernel"][kind] * runs["plain"][kind])
                        .sum(-1).min()) for kind in inputs}


def phase_siglip_serve(server, torch):
    """ViT-B-16-SigLIP (the shape of Marqo/marqo-fashionSigLIP) at full
    width behind the HTTP server: an image index (captions and images),
    searches by text and by image. Both towers run B2's no-mask mode: 12
    launches per tower call (the latent pool launches none); the served
    vectors match the plain twins' on the same card."""
    from marqo_tpu_torch.models.siglip import TorchSigLIPModel
    req = server.req
    name = "smoke-ViT-B-16-SigLIP"
    props = {"name": name, "type": "open_clip", "random_init": True,
             "dimensions": SIGLIP_DIMS, "image_size": 224,
             "architecture": SIGLIP_B16}
    req("POST", "/indexes/siglip", {"model": name, "modelProperties": props,
                                    "treatUrlsAndPointersAsImages": True})
    colours = ["red", "green", "blue", "yellow", "purple", "orange", "grey",
               "white"]
    fields = {"tensorFields": ["image", "caption"]}
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_images(tmp, SIGLIP_DOCS + 1, seed=12)
        docs = [{"_id": f"img{i}", "image": paths[i],
                 "caption": f"a {colours[i % 8]} dress, number {i}"}
                for i in range(SIGLIP_DOCS)]
        # the first add loads the model onto the card
        res = req("POST", "/indexes/siglip/documents", {
            "documents": [{"_id": "warm", "image": paths[-1],
                           "caption": "a warm-up photo"}], **fields})
        check(res["errors"] is False, f"siglip add_documents errors: {res}")
        model = _loaded_model(TorchSigLIPModel, name)
        calls, hooks = _count_tower_calls({"text": model.encoder.text,
                                           "vision": model.encoder.vision},
                                          model.graphs)
        reset_counts()
        try:
            start = time.perf_counter()
            for b in range(0, SIGLIP_DOCS, 16):
                res = req("POST", "/indexes/siglip/documents",
                          {"documents": docs[b:b + 16], **fields})
                check(res["errors"] is False,
                      f"siglip add_documents errors: {res}")
            add_seconds = time.perf_counter() - start
            text_hits = req("POST", "/indexes/siglip/search",
                            {"q": "a red dress", "searchMethod": "TENSOR",
                             "limit": 5})["hits"]
            probe = SIGLIP_DOCS // 3
            image_hits = req("POST", "/indexes/siglip/search",
                             {"q": paths[probe], "searchMethod": "TENSOR",
                              "limit": 3})["hits"]
            launches = read_counts()
        finally:
            for handle in hooks:
                handle.remove()
        check(len(text_hits) > 0, "siglip text search: no hits")
        check(image_hits and image_hits[0]["_id"] == f"img{probe}",
              f"siglip image query: top hit {image_hits[:1]}, expected "
              f"img{probe}")
        cos = _kernel_against_plain(
            model, torch, ["a red dress", "two shoes on a shelf",
                           "a long green coat with buttons"], paths[:8])
    GRAPHED_FAMILIES["siglip"] = model
    stats = req("GET", "/indexes/siglip/stats")
    check(stats.get("numberOfDocuments") == SIGLIP_DOCS + 1,
          f"siglip index documents: {stats}")
    devices = _model_devices(TorchSigLIPModel)
    check(devices == {DEVICE}, f"SigLIP parameters on {devices}")
    tower_calls = calls["text"] + calls["vision"]
    layers = SIGLIP_B16["text_layers"]
    check(calls["text"] > 0 and calls["vision"] > 0 and
          launches["fused_attention_nomask"] == layers * tower_calls and
          sum(launches.values()) == launches["fused_attention_nomask"],
          f"siglip: expected {layers} B2 no-mask launches per tower call "
          f"({calls}) and no other kernel: {launches}")
    for kind, value in cos.items():
        check(value >= 1 - 1e-3, f"siglip {kind} vectors, kernel against "
              f"the plain twins: cosine {value}")
    emit("siglip_serve", ok=True, docs=SIGLIP_DOCS + 1,
         documents_in_index=stats.get("numberOfDocuments"),
         vectors_in_index=stats.get("numberOfVectors"),
         image_query_top_hit=image_hits[0]["_id"], tower_calls=calls,
         launches=launches, min_cosine_kernel_vs_plain=cos,
         model_devices=sorted(devices),
         graphs=graph_state(torch, model.graphs))
    return launches, add_seconds


def _text_lengths(n: int, seed: int) -> list:
    """Texts of 1 to 40 words, so a batch pads most of its rows."""
    import numpy as np
    rng = np.random.default_rng(seed)
    words = ["bonjour", "le", "monde", "une", "photo", "rouge", "de", "la",
             "mer", "sous", "un", "ciel", "gris", "et", "bleu"]
    return [" ".join(rng.choice(words, int(rng.integers(1, 41))))
            for _ in range(n)]


def phase_nllb_siglip_encode(torch):
    """NLLB-SigLIP base at full width through its wrapper on the card:
    texts of mixed lengths (real padding) through the M2M-100 tower on
    B1's padding mode, images (384 px) through the SigLIP tower on B2's
    no-mask mode; held against the plain twins on the same card."""
    from marqo_tpu_torch.inference.loaders import load_model
    from marqo_tpu_torch.inference.types import Modality
    props = {"name": "smoke-nllb-clip-base-siglip", "type": "open_clip",
             "random_init": True, "dimensions": NLLB_SIGLIP_DIMS,
             "image_size": 384, "architecture": NLLB_SIGLIP_BASE}
    model = load_model(props["name"], props, _device())
    texts = _text_lengths(24, seed=13)
    tokens = model._tokenize(texts)
    padding = float((tokens == model.text_config.pad_token_id).mean())
    check(padding > 0.2, f"nllb texts barely pad ({padding})")
    with tempfile.TemporaryDirectory() as tmp:
        images = write_images(tmp, 8, seed=14)
        calls, hooks = _count_tower_calls({"text": model.encoder.text,
                                           "vision": model.encoder.vision},
                                          model.graphs)
        reset_counts()
        try:
            text = model.encode(texts)
            image = model.encode(images, modality=Modality.IMAGE)
            launches = read_counts()
        finally:
            for handle in hooks:
                handle.remove()
        cos = _kernel_against_plain(model, torch, texts, images)
    devices = {t.device.type for t in (*model.encoder.parameters(),
                                       *model.encoder.buffers())}
    check(devices == {DEVICE}, f"NLLB-SigLIP parameters on {devices}")
    check(text.shape == (24, NLLB_SIGLIP_DIMS) and
          image.shape == (8, NLLB_SIGLIP_DIMS) and
          bool(np_finite(text)) and bool(np_finite(image)),
          f"nllb outputs {text.shape} {image.shape}")
    layers = NLLB_SIGLIP_BASE["text_layers"]
    check(launches["masked_attention_padding"] == layers * calls["text"] > 0
          and launches["fused_attention_nomask"] ==
          NLLB_SIGLIP_BASE["vision_layers"] * calls["vision"] > 0,
          f"nllb: expected B1 padding {layers} per text call and B2 "
          f"no-mask 12 per image call ({calls}): {launches}")
    for kind, value in cos.items():
        check(value >= 1 - 1e-3, f"nllb {kind} vectors, kernel against "
              f"the plain twins: cosine {value}")
    emit("nllb_siglip_encode", ok=True, texts=len(texts),
         tokens=list(tokens.shape), pad_share=padding, images=len(images),
         tower_calls=calls, launches=launches,
         min_cosine_kernel_vs_plain=cos, model_devices=sorted(devices),
         graphs=graph_state(torch, model.graphs))
    GRAPHED_FAMILIES["nllb_siglip"] = model
    return model, launches


def phase_conv_clip_encode(torch):
    """RN50 and convnext_base (224 px) at full width through their
    wrappers on the card, text and images; no kernel of this package runs
    in these towers, so each bf16 tower is held against the same module in
    fp32 on the card (cosine >= 1 - CONV_COS_TOL). Returns the models for
    the timing phase."""
    import copy

    import numpy as np

    from marqo_tpu_torch.inference.loaders import load_model
    from marqo_tpu_torch.inference.types import Modality
    results, models = {}, {}
    texts = _text_lengths(16, seed=15)
    with tempfile.TemporaryDirectory() as tmp:
        images = write_images(tmp, 16, seed=16)
        for key, name, arch, dims in (
                ("rn50", "smoke-open_clip/RN50/openai", RN50, RN50_DIMS),
                ("convnext_base", "smoke-open_clip/convnext_base/laion400m",
                 CONVNEXT_BASE, CONVNEXT_BASE_DIMS)):
            props = {"name": name, "type": "open_clip", "random_init": True,
                     "dimensions": dims, "image_size": 224,
                     "architecture": arch}
            model = load_model(name, props, _device())
            reset_counts()
            text = model.encode(texts)
            image = model.encode(images, modality=Modality.IMAGE)
            launches = read_counts()
            fp32 = copy.deepcopy(model.encoder).float()
            pixels = torch.from_numpy(np.stack(
                [model._preprocess_host(p) for p in images])).to(DEVICE)
            ids = torch.from_numpy(model._tokenize(texts)).to(DEVICE)
            with torch.inference_mode():
                ref_image = fp32.vision(pixels).cpu().numpy()
                ref_text = fp32.text(ids).cpu().numpy()
            del fp32
            cos = {}
            for kind, out, ref in (("text", text, ref_text),
                                   ("image", image, ref_image)):
                ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
                cos[kind] = float((out * ref).sum(-1).min())
                check(out.shape == (len(ref), dims) and np_finite(out),
                      f"{key} {kind} output {out.shape}")
                check(cos[kind] >= 1 - CONV_COS_TOL,
                      f"{key} {kind}: bf16 against fp32 on the card, "
                      f"cosine {cos[kind]}")
            devices = {p.device.type for p in model.encoder.parameters()}
            check(devices == {DEVICE}, f"{key} parameters on {devices}")
            check(not any(launches.values()),
                  f"{key}: a kernel of this package ran: {launches}")
            results[key] = {"min_cosine_bf16_vs_fp32": cos,
                            "launches": launches,
                            "model_devices": sorted(devices),
                            "graphs": graph_state(torch, model.graphs)}
            models[key] = GRAPHED_FAMILIES[key] = model
    emit("conv_clip_encode", ok=True, tolerance=1 - CONV_COS_TOL,
         texts=len(texts), images=len(images), **results)
    return models


def _b2_per_tower_call(label, launches, calls, layers) -> None:
    """Exactly ``layers[tower]`` B2 no-mask launches per call of each
    tower, and no launch of another kernel."""
    expected = sum(layers[tower] * calls[tower] for tower in calls)
    check(all(calls[tower] > 0 for tower in layers) and
          launches["fused_attention_nomask"] == expected and
          sum(launches.values()) == expected,
          f"{label}: expected {layers} B2 no-mask launches per tower call "
          f"({calls}) and no other kernel: {launches}")


def phase_coca_serve(server, torch):
    """open_clip coca_ViT-L-14 at full width behind the HTTP server: an
    image index (captions and images), searches by text and by image. The
    vision tower's 24 blocks run B2's no-mask mode (24 launches per image
    tower call); the text tower, the attentional pooler and the decoder are
    plain torch (no launch). The served vectors, teacher-forced caption
    logits on 4 pairs and an 8-token greedy caption are held against the
    plain twins on the same card."""
    import numpy as np

    from marqo_tpu_torch.models.coca import TorchCoCaModel
    req = server.req
    name = "smoke-coca_ViT-L-14"
    props = {"name": "open_clip/coca_ViT-L-14/laion2b_s13b_b90k",
             "type": "open_clip", "random_init": True,
             "dimensions": COCA_DIMS, "image_size": 224,
             "architecture": COCA_L14}
    req("POST", "/indexes/coca", {"model": name, "modelProperties": props,
                                  "treatUrlsAndPointersAsImages": True})
    colours = ["red", "green", "blue", "yellow", "purple", "orange", "grey",
               "white"]
    fields = {"tensorFields": ["image", "caption"]}
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_images(tmp, COCA_DOCS + 1, seed=17)
        docs = [{"_id": f"img{i}", "image": paths[i],
                 "caption": f"a {colours[i % 8]} scene, number {i}"}
                for i in range(COCA_DOCS)]
        # the first add loads the model onto the card
        res = req("POST", "/indexes/coca/documents", {
            "documents": [{"_id": "warm", "image": paths[-1],
                           "caption": "a warm-up photo"}], **fields})
        check(res["errors"] is False, f"coca add_documents errors: {res}")
        model = _loaded_model(TorchCoCaModel, name)
        calls, hooks = _count_tower_calls({"text": model.encoder.text,
                                           "vision": model.encoder.vision},
                                          model.graphs)
        reset_counts()
        try:
            start = time.perf_counter()
            for b in range(0, COCA_DOCS, 16):
                res = req("POST", "/indexes/coca/documents",
                          {"documents": docs[b:b + 16], **fields})
                check(res["errors"] is False,
                      f"coca add_documents errors: {res}")
            add_seconds = time.perf_counter() - start
            text_hits = req("POST", "/indexes/coca/search",
                            {"q": "a red scene", "searchMethod": "TENSOR",
                             "limit": 5})["hits"]
            probe = COCA_DOCS // 3
            image_hits = req("POST", "/indexes/coca/search",
                             {"q": paths[probe], "searchMethod": "TENSOR",
                              "limit": 3})["hits"]
            launches = read_counts()
        finally:
            for handle in hooks:
                handle.remove()
        check(len(text_hits) > 0, "coca text search: no hits")
        check(image_hits and image_hits[0]["_id"] == f"img{probe}",
              f"coca image query: top hit {image_hits[:1]}, expected "
              f"img{probe}")
        _b2_per_tower_call("coca", launches, calls,
                           {"text": 0, "vision": COCA_L14["vision_layers"]})
        cos = _kernel_against_plain(
            model, torch, ["a red scene", "two shoes on a shelf"], paths[:8])
        # the decoder on the card: teacher-forced logits for 4 (caption,
        # image) pairs, each row held against the plain twins', and a
        # greedy 8-token caption of 2 images on each
        captions = [docs[i]["caption"] for i in range(4)]
        runs = {}
        for impl in ("plain", "kernel"):
            model.set_attention_impl(impl)
            reset_counts()
            logits = model.caption_logits(captions, paths[:4])
            runs[impl] = (logits, model.generate_caption_ids(
                paths[:2], max_len=8), read_counts())
    kernel_logits, plain_logits = runs["kernel"][0], runs["plain"][0]
    rows = (kernel_logits * plain_logits).sum(-1) / (
        np.linalg.norm(kernel_logits, axis=-1) *
        np.linalg.norm(plain_logits, axis=-1))
    vocab = COCA_L14["vocab_size"]
    check(kernel_logits.shape == (4, COCA_L14["context_length"], vocab) and
          np_finite(kernel_logits), f"coca caption logits "
          f"{kernel_logits.shape}")
    cos["caption_logit_rows"] = float(rows.min())
    captions_ids = runs["kernel"][1]
    check(len(captions_ids) == 2 and all(
        c[0] == 1 and len(c) == 8 and all(0 <= t < vocab for t in c)
        for c in captions_ids), f"coca greedy captions {captions_ids}")
    # one image tower call for the logits and one for the captions
    check(runs["kernel"][2]["fused_attention_nomask"] ==
          2 * COCA_L14["vision_layers"] and
          runs["plain"][2]["fused_attention_nomask"] == 0,
          f"coca decoder runs: {runs['kernel'][2]} {runs['plain'][2]}")
    for kind, value in cos.items():
        check(value >= 1 - 1e-3, f"coca {kind}, kernel against the plain "
              f"twins: cosine {value}")
    GRAPHED_FAMILIES["coca"] = model
    stats = req("GET", "/indexes/coca/stats")
    check(stats.get("numberOfDocuments") == COCA_DOCS + 1,
          f"coca index documents: {stats}")
    devices = _model_devices(TorchCoCaModel)
    check(devices == {DEVICE}, f"CoCa parameters on {devices}")
    emit("coca_serve", ok=True, docs=COCA_DOCS + 1,
         documents_in_index=stats.get("numberOfDocuments"),
         vectors_in_index=stats.get("numberOfVectors"),
         image_query_top_hit=image_hits[0]["_id"], tower_calls=calls,
         launches=launches, min_cosine_kernel_vs_plain=cos,
         greedy_caption_ids=captions_ids,
         greedy_captions_equal_plain=captions_ids == runs["plain"][1],
         model_devices=sorted(devices),
         graphs=graph_state(torch, model.graphs))
    return launches, add_seconds


def phase_eva02_encode(torch):
    """EVA02-L-14-336 at full width through load_model and the wrapper:
    16 images (577 tokens, RoPE on q and k) through B2's no-mask mode, 24
    launches per image tower call, and 16 texts (causal, plain torch);
    held against the plain twins on the same card."""
    from marqo_tpu_torch.inference.loaders import load_model
    from marqo_tpu_torch.inference.types import Modality
    from marqo_tpu_torch.models.eva02 import TorchEVA02Model
    props = {"name": "open_clip/EVA02-L-14-336/merged2b_s6b_b61k",
             "type": "open_clip", "random_init": True,
             "dimensions": EVA02_DIMS, "image_size": EVA02_IMAGE_SIZE,
             "architecture": EVA02_L14_336}
    model = load_model("smoke-EVA02-L-14-336", props, _device())
    check(isinstance(model, TorchEVA02Model), f"eva02 loaded {type(model)}")
    vision = model.vision_config
    tokens = vision.grid ** 2 + 1
    texts = _text_lengths(EVA02_BATCH, seed=18)
    with tempfile.TemporaryDirectory() as tmp:
        images = write_images(tmp, EVA02_BATCH, seed=19)
        calls, hooks = _count_tower_calls({"text": model.encoder.text,
                                           "vision": model.encoder.vision},
                                          model.graphs)
        reset_counts()
        try:
            text = model.encode(texts)
            image = model.encode(images, modality=Modality.IMAGE)
            launches = read_counts()
        finally:
            for handle in hooks:
                handle.remove()
        cos = _kernel_against_plain(model, torch, texts[:4], images)
    check(text.shape == (EVA02_BATCH, EVA02_DIMS) and
          image.shape == (EVA02_BATCH, EVA02_DIMS) and np_finite(text) and
          np_finite(image), f"eva02 outputs {text.shape} {image.shape}")
    _b2_per_tower_call("eva02", launches, calls,
                       {"text": 0, "vision": vision.num_layers})
    for kind, value in cos.items():
        check(value >= 1 - 1e-3, f"eva02 {kind} vectors, kernel against "
              f"the plain twins: cosine {value}")
    devices = {t.device.type for t in (*model.encoder.parameters(),
                                       *model.encoder.buffers())}
    check(devices == {DEVICE}, f"EVA02 parameters on {devices}")
    emit("eva02_encode", ok=True, texts=len(texts), images=len(images),
         tokens=tokens, swiglu_hidden=vision.swiglu_hidden,
         tower_calls=calls, launches=launches,
         min_cosine_kernel_vs_plain=cos, model_devices=sorted(devices),
         graphs=graph_state(torch, model.graphs))
    GRAPHED_FAMILIES["eva02"] = model
    return model


def write_wavs(directory: str, n: int, seconds: float, seed: int) -> list:
    """16 kHz mono 16-bit WAV files from a numpy seed: a tone (a different
    pitch each) under noise."""
    import wave

    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    paths = []
    for i in range(n):
        tone = 0.4 * np.sin(2 * np.pi * 220 * 2 ** i * t)
        pcm = ((tone + 0.05 * rng.standard_normal(len(t))) * 32767).astype(
            np.int16)
        paths.append(os.path.join(directory, f"clip{i}.wav"))
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
    return paths


def phase_languagebind_serve(server, torch):
    """LanguageBind at ViT-L/14 width behind the HTTP server: audio
    documents (WAV files, split into 10 s chunks, log-mel on the card) and
    image documents, searches by audio and by text. The audio (497 tokens)
    and image (257) towers run B2's no-mask mode, 24 launches per tower
    call; the text tower is plain torch. Returns the loaded model."""
    import numpy as np

    from marqo_tpu_torch.inference.types import Modality
    from marqo_tpu_torch.models.languagebind import TorchLanguageBindModel
    from marqo_tpu_torch.ops.audio_ops import chunk_waveform
    req = server.req
    name = "smoke-languagebind-l14"
    props = {"type": "languagebind", "random_init": True,
             "dimensions": LANGUAGEBIND_DIMS,
             "image_size": LANGUAGEBIND_IMAGE_SIZE,
             "architecture": LANGUAGEBIND_L14,
             "supported_modalities": ["language", "image", "audio",
                                      "video"]}
    req("POST", "/indexes/lb", {"model": name, "modelProperties": props,
                                "treatUrlsAndPointersAsImages": True,
                                "treatUrlsAndPointersAsMedia": True})
    fields = {"tensorFields": ["sound", "image", "caption"]}
    layers = LANGUAGEBIND_L14["num_layers"]
    with tempfile.TemporaryDirectory() as tmp:
        wavs = write_wavs(tmp, LANGUAGEBIND_CLIPS, LANGUAGEBIND_CLIP_SECONDS,
                          seed=20)
        images = write_images(tmp, LANGUAGEBIND_IMAGES + 1, seed=21)
        # the first add loads the model onto the card
        res = req("POST", "/indexes/lb/documents", {
            "documents": [{"_id": "warm", "image": images[-1],
                           "caption": "a warm-up photo"}], **fields})
        check(res["errors"] is False, f"languagebind add errors: {res}")
        model = _loaded_model(TorchLanguageBindModel, name)
        towers = {"text": model.encoder.text, "image": model.encoder.vision,
                  "audio": model.encoder.audio}
        # the tower names are the graphs' own: a replay counts as a call
        calls, hooks = _count_tower_calls(towers, model.graphs)
        reset_counts()
        try:
            start = time.perf_counter()
            res = req("POST", "/indexes/lb/documents", {"documents": [
                {"_id": f"clip{i}", "sound": path}
                for i, path in enumerate(wavs)], **fields})
            check(res["errors"] is False, f"languagebind audio adds: {res}")
            res = req("POST", "/indexes/lb/documents", {"documents": [
                {"_id": f"img{i}", "image": images[i],
                 "caption": f"a photo, number {i}"}
                for i in range(LANGUAGEBIND_IMAGES)], **fields})
            check(res["errors"] is False, f"languagebind image adds: {res}")
            add_seconds = time.perf_counter() - start
            probe = LANGUAGEBIND_CLIPS - 1
            audio_hits = req("POST", "/indexes/lb/search",
                             {"q": wavs[probe], "searchMethod": "TENSOR",
                              "limit": 3})["hits"]
            text_hits = req("POST", "/indexes/lb/search",
                            {"q": "a low hum", "searchMethod": "TENSOR",
                             "limit": 3})["hits"]
            launches = read_counts()
        finally:
            for handle in hooks:
                handle.remove()
        check(audio_hits and audio_hits[0]["_id"] == f"clip{probe}",
              f"languagebind audio query: top hit {audio_hits[:1]}, "
              f"expected clip{probe}")
        check(len(text_hits) > 0, "languagebind text search: no hits")
        _b2_per_tower_call("languagebind", launches, calls,
                           {"text": 0, "image": layers, "audio": layers})
        cos = _kernel_against_plain(
            model, torch, ["a low hum"], images[:4],
            {"audio": (Modality.AUDIO, wavs)})
    for kind, value in cos.items():
        check(value >= 1 - 1e-3, f"languagebind {kind} vectors, kernel "
              f"against the plain twins: cosine {value}")
    stats = req("GET", "/indexes/lb/stats")
    # the default audioPreprocessing: 10 s chunks overlapping by 3 s; an
    # image document holds an image and a caption vector
    chunks = len(chunk_waveform(np.zeros(int(
        16000 * LANGUAGEBIND_CLIP_SECONDS), np.float32)))
    check(stats.get("numberOfDocuments") ==
          LANGUAGEBIND_CLIPS + LANGUAGEBIND_IMAGES + 1 and
          stats.get("numberOfVectors") ==
          LANGUAGEBIND_CLIPS * chunks + 2 * (LANGUAGEBIND_IMAGES + 1),
          f"languagebind index documents and vectors: {stats}")
    devices = _model_devices(TorchLanguageBindModel)
    check(devices == {DEVICE}, f"LanguageBind parameters on {devices}")
    GRAPHED_FAMILIES["languagebind"] = model
    emit("languagebind_serve", ok=True,
         audio_docs=LANGUAGEBIND_CLIPS, image_docs=LANGUAGEBIND_IMAGES + 1,
         audio_tokens=model.audio_config.n_tokens + 1,
         chunks_per_clip=chunks,
         documents_in_index=stats.get("numberOfDocuments"),
         vectors_in_index=stats.get("numberOfVectors"),
         audio_query_top_hit=audio_hits[0]["_id"], tower_calls=calls,
         launches=launches, min_cosine_kernel_vs_plain=cos,
         model_devices=sorted(devices),
         graphs=graph_state(torch, model.graphs))
    return model, launches, add_seconds


def phase_languagebind_video(model, torch):
    """LanguageBind's video tower at VideoTowerConfig's defaults (ViT-L/14,
    8 frames, temporal attention in every layer), random weights, on the
    served LanguageBind model: the wrapper encodes one video per call, each
    layer's temporal attention (257 tokens x 8 frames) and spatial
    attention (8 frames x 257 tokens) on B2's no-mask mode, 48 launches per
    video; held against the plain twins on the same card. The tower is
    assigned to the serving model, so its first video captures the video
    key (the warm run and the replay: twice 48 launches) before the
    counted window."""
    import numpy as np

    from marqo_tpu_torch.inference.types import Modality
    from marqo_tpu_torch.models.languagebind import (VideoTowerConfig,
                                                     init_video_tower)
    config = VideoTowerConfig(projection_dim=LANGUAGEBIND_DIMS, **VIDEO_TOWER)
    model.video_config = config
    model.encoder.video = init_video_tower(
        config, torch.Generator(device=DEVICE).manual_seed(22),
        dtype=model.compute_dtype, device=DEVICE)
    rng = np.random.default_rng(23)
    videos = [[rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
               for _ in range(config.num_frames)] for _ in range(VIDEO_COUNT)]
    per_video = 2 * config.num_layers if config.add_time_attn else \
        config.num_layers
    reset_counts()
    start = time.perf_counter()
    model.encode(videos[:1], modality=Modality.VIDEO)
    first = {"seconds": time.perf_counter() - start,
             "launches": {k: v for k, v in read_counts().items() if v},
             "keys": [graph_label(key) for key in model.graphs.graphs
                      if key[0] == "video"]}
    check(first["launches"] == {"fused_attention_nomask": 2 * per_video} and
          len(first["keys"]) == 1, f"video: the first video launched "
          f"{first['launches']} and captured {first['keys']}, expected "
          f"2 x {per_video} B2 no-mask and one key")
    reset_counts()
    out = model.encode(videos, modality=Modality.VIDEO)
    launches = read_counts()
    cos = _kernel_against_plain(model, torch, ["a video"], videos[0][:1],
                                {"video": (Modality.VIDEO, videos)})
    check(out.shape == (VIDEO_COUNT, LANGUAGEBIND_DIMS) and np_finite(out),
          f"video output {out.shape}")
    check(launches["fused_attention_nomask"] == per_video * VIDEO_COUNT and
          sum(launches.values()) == launches["fused_attention_nomask"],
          f"video: expected {per_video} B2 no-mask launches per video: "
          f"{launches}")
    check(cos["video"] >= 1 - 1e-3, f"video vectors, kernel against the "
          f"plain twins: cosine {cos['video']}")
    emit("languagebind_video", ok=True, videos=VIDEO_COUNT,
         frames=config.num_frames, tokens=(config.image_size //
                                           config.patch_size) ** 2 + 1,
         launches=launches, launches_per_video=per_video,
         first_video_before_the_count=first, min_cosine_kernel_vs_plain=cos,
         graphs=graph_state(torch, model.graphs))
    return launches


def _count_chunk_image_calls(image_patching):
    """Wrap ``image_patching.chunk_image`` (the add path imports it at each
    call): per method, its calls and the kernel launches made inside them.
    Returns the stats and a function that restores the original."""
    stats = {}
    original = image_patching.chunk_image

    def counted(image, method):
        before = read_counts()
        out = original(image, method)
        delta = count_delta(before, read_counts())
        entry = stats.setdefault(method, {"calls": 0, "launches":
                                          dict.fromkeys(delta, 0)})
        entry["calls"] += 1
        for name, count in delta.items():
            entry["launches"][name] += count
        return out

    image_patching.chunk_image = counted
    return stats, lambda: setattr(image_patching, "chunk_image", original)


def _count_vision_tower_calls():
    """Count every CLIPVisionTower batch that runs on the card (the index
    model's image embeddings; DINO and OWL-ViT call no tower forward):
    an eager forward, seen by a global forward hook outside a CUDA graph's
    capture, or a replay of a "vision" graph (inference/graphs.py).
    Returns the count (a one-item list) and a handle whose ``remove()``
    takes the hook and the wrapper off."""
    import torch
    from torch.nn.modules.module import register_module_forward_hook

    from marqo_tpu_torch.inference import graphs
    from marqo_tpu_torch.models.clip import CLIPVisionTower
    calls = [0]
    replay = graphs.Graph.replay

    def hook(module, *_):
        if isinstance(module, CLIPVisionTower) and not (
                torch.cuda.is_available() and
                torch.cuda.is_current_stream_capturing()):
            calls[0] += 1

    def counted_replay(self):
        if self.key[0] == "vision":
            calls[0] += 1
        return replay(self)

    graphs.Graph.replay = counted_replay
    handle = register_module_forward_hook(hook)

    class Handle:
        @staticmethod
        def remove():
            handle.remove()
            graphs.Graph.replay = replay

    return calls, Handle()


def _relative_error(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1e-30))


def detector_error(card, ref) -> float:
    """A detector's outputs on the card against its fp32 CPU run,
    relative to each output group's largest magnitude, the largest:
    YOLOX's (B, N, 85) by xy, wh, objectness and classes, Faster R-CNN's
    levels by each level's objectness and deltas."""
    import torch
    if isinstance(card, torch.Tensor):
        return max(_relative_error(card[..., s].cpu(), ref[..., s])
                   for s in (slice(0, 2), slice(2, 4), slice(4, 5),
                             slice(5, None)))
    return max(_relative_error(c.cpu(), r)
               for c_level, r_level in zip(card, ref)
               for c, r in zip(c_level, r_level))


# the detectors' inputs patch_serve held against the fp32 CPU run (by
# family_graphs' name), which last_family_graphs replays
DETECTOR_INPUTS = {}


def detector_served_errors(model, inputs, torch) -> dict:
    """A detector's card outputs with cuDNN's TF32 on, as a served process
    has it (PyTorch's default), against the same module's fp32 CPU run, on
    each input: relative to each output group's largest magnitude (YOLOX:
    xy, wh, objectness, classes; Faster R-CNN: each level's objectness and
    deltas). ``served``: the module's forward, which turns TF32 off for
    itself; ``control``: its body under the process's TF32, which must
    miss the tolerance. Returns the largest error of each."""
    import copy
    host = copy.deepcopy(model).cpu()
    errors = {"served": 0.0, "control": 0.0}
    setting = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            for x in inputs:
                ref = host(x)
                for key, fn in (("served", model),
                                ("control", model._forward)):
                    errors[key] = max(errors[key], detector_error(
                        fn(x.to(DEVICE)), ref))
    finally:
        torch.backends.cudnn.allow_tf32 = setting
    check(errors["served"] <= DETECTOR_REL_TOL < errors["control"],
          f"{type(model).__name__} with TF32 on as served, card vs fp32 "
          f"CPU: relative error {errors['served']} (tolerance "
          f"{DETECTOR_REL_TOL}; the control, TF32 on in the convolutions, "
          f"{errors['control']})")
    return errors


def _first_patch_image(image_patching, method: str, path: str) -> dict:
    """The method's patcher on one image before its index's add, outside
    chunk_image: on CUDA its first image captures the patcher's one graph,
    the key's warm run and first replay launching twice what an image
    does (DINO 2 x 11 B2 no-mask, YOLOX and Faster R-CNN no kernel of
    ours), so that each image of the add replays it."""
    import numpy as np
    from PIL import Image
    patcher = image_patching._get_patcher(method)
    image = np.asarray(Image.open(path).convert("RGB"))
    reset_counts()
    start = time.perf_counter()
    patcher.boxes(image)
    seconds = time.perf_counter() - start
    launches = {k: v for k, v in read_counts().items() if v}
    expected = {}
    if method.startswith("dino"):
        expected = {"fused_attention_nomask":
                    2 * (patcher.model.config.num_layers - 1)}
    keys = [graph_label(key) for key in patcher.graphs.graphs]
    check(launches == expected and len(keys) == 1,
          f"{method}: the first image launched {launches} and captured "
          f"{keys}, expected {expected} and one key")
    return {"seconds": seconds, "launches": launches, "keys": keys}


def phase_patch_serve(server, torch):
    """The detector patch methods behind the HTTP server
    (MARQO_PATCH_MODELS_RANDOM_INIT, full-width ResNet-50): one index per
    method on the random-init open_clip ViT-L/14, PATCH_IMAGES 640x480
    images each. Every add is a 200, every stored chunk a box inside its
    image, the full image first; inside chunk_image B2's no-mask mode runs
    exactly 11 times per DINO image and no kernel of ours for YOLOX or
    Faster R-CNN, and the patches' ViT-L/14 embeddings launch 24 a tower
    call; an image query finds its document. Then DINO's maps on B2
    against the twin's, and YOLOX's and Faster R-CNN's card outputs (cuDNN
    TF32 on, as served) against the same module's fp32 CPU run."""
    from dataclasses import replace

    import cv2
    import numpy as np
    from PIL import Image

    from marqo_tpu_torch.inference import image_patching
    from marqo_tpu_torch.models.frcnn import IMAGENET_MEAN, IMAGENET_STD
    os.environ["MARQO_PATCH_MODELS_RANDOM_INIT"] = "TRUE"
    os.environ.pop("MARQO_FRCNN_WIDTH", None)
    image_patching.clear_patchers()
    req = server.req
    props = vit_l14_props()
    W, H = PATCH_IMAGE_SIZE
    per_method = {}
    stats, restore = _count_chunk_image_calls(image_patching)
    tower_calls, hook = _count_vision_tower_calls()
    tmp = tempfile.TemporaryDirectory()
    try:
        paths = write_images(tmp.name, PATCH_IMAGES, seed=11,
                             size=PATCH_IMAGE_SIZE)
        docs = [{"_id": f"p{i}", "image": p} for i, p in enumerate(paths)]
        for method in PATCH_METHODS:
            index = f"patch-{method}"
            req("POST", f"/indexes/{index}", {
                "model": props["name"], "modelProperties": props,
                "treatUrlsAndPointersAsImages": True,
                "imagePreprocessing": {"patchMethod": method}})
            first_image = _first_patch_image(image_patching, method,
                                             paths[0])
            reset_counts()
            towers_before = tower_calls[0]
            start = time.perf_counter()
            res = req("POST", f"/indexes/{index}/documents",
                      {"documents": docs, "tensorFields": ["image"]})
            seconds = time.perf_counter() - start
            check(res["errors"] is False and
                  [item["status"] for item in res["items"]] ==
                  [200] * PATCH_IMAGES, f"{index} add: {res}")
            add = read_counts()
            towers = tower_calls[0] - towers_before
            patch = stats.pop(method)
            chunks = 0
            for doc in docs:
                got = req("GET", f"/indexes/{index}/documents/{doc['_id']}"
                          "?expose_facets=true")
                boxes = [json.loads(f["image"])
                         for f in got["_tensor_facets"]]
                check(boxes and boxes[0] == [0, 0, W, H],
                      f"{index} {doc['_id']}: first chunk {boxes[:1]}")
                for x1, y1, x2, y2 in boxes:
                    check(0 <= x1 < x2 <= W and 0 <= y1 < y2 <= H,
                          f"{index} {doc['_id']}: box {[x1, y1, x2, y2]} "
                          f"outside {W}x{H}")
                chunks += len(boxes)
            check(patch["calls"] == PATCH_IMAGES,
                  f"{index}: chunk_image ran {patch['calls']} times")
            expected = ({"fused_attention_nomask": 11 * PATCH_IMAGES}
                        if method.startswith("dino") else {})
            inside = {k: v for k, v in patch["launches"].items() if v}
            check(inside == expected, f"{index}: launches inside the "
                  f"patcher {inside}, expected {expected}")
            embed = count_delta(patch["launches"], add)
            layers = VIT_L14_VISION["num_layers"]
            check(towers > 0 and embed["fused_attention_nomask"] ==
                  layers * towers, f"{index}: {embed} outside the patcher "
                  f"for {towers} tower calls")
            probe = PATCH_IMAGES // 2
            hits = req("POST", f"/indexes/{index}/search",
                       {"q": paths[probe], "searchMethod": "TENSOR",
                        "limit": 3})["hits"]
            check(hits and hits[0]["_id"] == f"p{probe}",
                  f"{index} image query: hits {[h['_id'] for h in hits]}")
            per_method[method] = {
                "add_seconds": seconds, "chunks": chunks,
                "patcher_calls": patch["calls"],
                "launches_in_patcher": patch["launches"],
                "launches_outside_patcher": embed,
                "vision_tower_calls": towers,
                "image_query_top_hit": hits[0]["_id"],
                "first_image_outside_add": first_image}
        # kernel against twin and card against CPU, on the served models
        images = [np.asarray(Image.open(p).convert("RGB")) for p in paths]
    finally:
        hook.remove()
        restore()
        tmp.cleanup()
    dino = image_patching._get_patcher("dino-v1")
    for method, name in (("dino-v1", "dino-v1"), ("dino-v2", "dino-v2"),
                         ("marqo-yolo", "yolox"), ("frcnn", "frcnn")):
        GRAPHED_FAMILIES[name] = image_patching._get_patcher(method)
    check(next(dino.model.parameters()).device.type == DEVICE,
          "DINO is not on the card")
    pixels = torch.from_numpy(np.stack([
        cv2.resize(img, (224, 224), interpolation=cv2.INTER_LINEAR)
        for img in images[:4]])).to(DEVICE)
    config = dino.model.config
    maps = {}
    for impl in ("plain", "kernel"):
        dino.model.config = replace(config, attention_impl=impl)
        with torch.inference_mode():
            maps[impl] = dino.model.last_selfattention(pixels).flatten(2)
    dino.model.config = config
    dino_cos = min_cos(maps["kernel"].flatten(0, 1),
                       maps["plain"].flatten(0, 1))
    check(dino_cos >= 1 - DETECTOR_COS_TOL,
          f"DINO maps, kernel vs twin: cosine {dino_cos}")
    yolox = image_patching._get_patcher("marqo-yolo")
    frcnn = image_patching._get_patcher("frcnn")
    # YOLOX's input / 255: with random weights the raw 0-255 pixels drive
    # the head logits to 1e4, where the sigmoids saturate and a 1e-6
    # relative difference in a logit moves a probability by 1e-3
    size = yolox.config.input_size
    yolo_in = [torch.from_numpy((cv2.resize(img, (size, size))[..., ::-1] /
                                 255.0)[None].astype(np.float32))
               for img in images[:DETECTOR_IMAGES]]
    size = frcnn.config.input_size
    frcnn_in = [torch.from_numpy(((cv2.resize(img, (size, size)) / 255.0 -
                                   np.asarray(IMAGENET_MEAN)) /
                                  np.asarray(IMAGENET_STD))[None].astype(
                                      np.float32))
                for img in images[:DETECTOR_IMAGES]]
    yolox_err = detector_served_errors(yolox.model, yolo_in, torch)
    frcnn_err = detector_served_errors(frcnn.model, frcnn_in, torch)
    DETECTOR_INPUTS.update(yolox=yolo_in, frcnn=frcnn_in)
    emit("patch_serve", ok=True, images=PATCH_IMAGES,
         image_size=list(PATCH_IMAGE_SIZE), methods=per_method,
         frcnn_width=frcnn.config.width,
         dino_min_cosine_kernel_vs_plain=dino_cos,
         yolox_card_vs_cpu_rel_err=yolox_err["served"],
         frcnn_card_vs_cpu_rel_err=frcnn_err["served"],
         yolox_control_tf32_rel_err=yolox_err["control"],
         frcnn_control_tf32_rel_err=frcnn_err["control"],
         model_devices=sorted({str(next(p.model.parameters()).device.type)
                               for p in (dino, yolox, frcnn)}),
         graphs=graph_state(torch, *(GRAPHED_FAMILIES[m].graphs
                                     for m in ("dino-v1", "dino-v2",
                                               "yolox", "frcnn"))))
    return per_method["dino-v1"]["launches_in_patcher"][
        "fused_attention_nomask"]


def phase_owl_rerank(server, torch):
    """OWL-ViT B/32 (google/owlvit-base-patch32's widths, random weights
    from a seeded torch.Generator) as the rerank cache's "owl/ViT-B/32",
    behind an HTTP search over OWL_HITS image documents with reRanker and
    searchableAttributes ["image"]: B2's no-mask mode runs 12 times per
    scoring call at (OWL_HITS, 12, 577, 64); every hit scores in [0, 1]
    with a highlight box inside its image; the logits and boxes on B2
    against the twin's."""
    from dataclasses import replace

    import numpy as np
    from PIL import Image

    from marqo_tpu_torch.inference import rerank
    from marqo_tpu_torch.models.owl_vit import (OwlViTConfig, detect,
                                                init_owl_params)
    from marqo_tpu_torch.models.tokenizer import TextTokenizer
    name = "owl/ViT-B/32"
    config = OwlViTConfig.base_patch32()
    config = OwlViTConfig(
        text=replace(config.text, **OWL_VIT.get("text", {})),
        vision=replace(config.vision, **OWL_VIT.get("vision", {})))
    # the reranker load() would build from google/owlvit-base-patch32's
    # checkpoint, which this run has not got: the same object, random
    reranker = rerank.TorchOwlReranker(name, _device())
    reranker.config = config
    reranker.model = init_owl_params(
        config, torch.Generator(device=DEVICE).manual_seed(8),
        dtype=torch.bfloat16, device=DEVICE)
    reranker.tokenizer = TextTokenizer.build_test_wordpiece(
        max_length=config.text.max_positions)
    reranker._tokenize = reranker._tokenize_wordpiece
    rerank._rerankers[f"{name}||{_device().value}"] = reranker
    calls = []
    score_images = reranker.score_images

    def counted(query, pointers):
        before = read_counts()
        out = score_images(query, pointers)
        calls.append({"images": len(pointers),
                      "launches": count_delta(before, read_counts())})
        return out

    reranker.score_images = counted
    req = server.req
    props = vit_l14_props()
    query = "a red photo"
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_images(tmp, OWL_HITS, seed=12)
        sizes = {f"o{i}": Image.open(p).size for i, p in enumerate(paths)}
        req("POST", "/indexes/owl-images", {
            "model": props["name"], "modelProperties": props,
            "treatUrlsAndPointersAsImages": True})
        res = req("POST", "/indexes/owl-images/documents", {
            "documents": [{"_id": f"o{i}", "image": p}
                          for i, p in enumerate(paths)],
            "tensorFields": ["image"]})
        check(res["errors"] is False, f"owl-images add: {res}")
        # the search's hit count scored once before it: on CUDA that
        # captures its graph, the key's warm run and first replay
        # launching B2 twice over; the search's scoring call replays it
        reset_counts()
        start = time.perf_counter()
        score_images(query, paths)
        first_call = {"seconds": time.perf_counter() - start,
                      "launches": {k: v for k, v in read_counts().items()
                                   if v},
                      "keys": [graph_label(k)
                               for k in reranker.graphs.graphs]}
        check(first_call["launches"] == {
            "fused_attention_nomask": 2 * config.vision.num_layers} and
            len(first_call["keys"]) == 1, f"owl first scoring call "
            f"{first_call}, expected 2 x {config.vision.num_layers} B2 "
            f"no-mask and one key")
        reset_counts()
        start = time.perf_counter()
        hits = req("POST", "/indexes/owl-images/search", {
            "q": query, "searchMethod": "TENSOR", "limit": OWL_HITS,
            "reRanker": name, "searchableAttributes": ["image"]})["hits"]
        search_ms = (time.perf_counter() - start) * 1000
        launches = read_counts()
        pixels = torch.from_numpy(np.stack(
            [reranker._load_image(p)[0] for p in paths])).to(DEVICE)
    del reranker.score_images
    layers = config.vision.num_layers
    check(len(calls) == 1 and calls[0]["images"] == OWL_HITS,
          f"owl scoring calls: {calls}")
    check(launches == {**dict.fromkeys(launches, 0),
                       "fused_attention_nomask": layers * len(calls)},
          f"owl search launches {launches}, expected {layers} B2 no-mask "
          f"per scoring call")
    scores = [h["_score"] for h in hits]
    check(len(hits) == OWL_HITS and scores == sorted(scores, reverse=True),
          f"owl rerank: hits {len(hits)}, scores {scores}")
    for hit in hits:
        w, h = sizes[hit["_id"]]
        x1, y1, x2, y2 = hit["_highlights"][0]["image"]
        check(0.0 <= hit["_score"] <= 1.0 and 0 <= x1 <= x2 <= w and
              0 <= y1 <= y2 <= h, f"owl hit {hit['_id']}: score "
              f"{hit['_score']}, box {[x1, y1, x2, y2]} in {w}x{h}")
    ids = torch.from_numpy(reranker._tokenize([query])).to(DEVICE)
    out = {}
    for impl in ("plain", "kernel"):
        reranker.model.vision.config = replace(config.vision,
                                               attention_impl=impl)
        with torch.inference_mode():
            out[impl] = detect(reranker.model, pixels, ids)
    reranker.model.vision.config = config.vision
    logits_cos = min_cos(out["kernel"][0].flatten(1),
                         out["plain"][0].flatten(1))
    box_err = float((out["kernel"][1] - out["plain"][1]).abs().max())
    check(logits_cos >= 1 - DETECTOR_COS_TOL and box_err <= OWL_BOX_TOL,
          f"owl kernel vs twin: logits cosine {logits_cos}, boxes "
          f"{box_err}")
    emit("owl_rerank", ok=True, hits=len(hits), top_scores=scores[:3],
         scoring_calls=calls, launches=launches, search_ms=search_ms,
         tokens=(config.vision.image_size // config.vision.patch_size) ** 2
         + 1, logits_min_cosine_kernel_vs_plain=logits_cos,
         boxes_max_abs_err_kernel_vs_plain=box_err,
         first_call_outside_search=first_call,
         graphs=graph_state(torch, reranker.graphs),
         model_device=str(next(reranker.model.parameters()).device.type))
    GRAPHED_FAMILIES["owl"] = reranker
    rerank.clear_rerankers()
    return launches["fused_attention_nomask"]


def phase_detector_timing(fused, torch, patch_launches, owl_launches):
    """B2's no-mask mode at the DINO and OWL-ViT shapes: queued, with its
    back-to-back time, bound, twin and SDPA times and the launches of its
    phase. (The detectors' device ms per image come from
    scripts/profile_torch_encoder.py: a whole model's forward queues more
    launches than the device's queue holds, so queued_ms cannot time
    it.)"""
    rows = []
    for shape, launches in ((DINO_B2_SHAPE, patch_launches),
                            (OWL_B2_SHAPE, owl_launches)):
        B, N, S, D = shape
        q, k, v, _, _ = attention_inputs(B, N, S, D, torch.bfloat16, seed=S)
        q, k, v = projection_views(q, k, v, "projection")
        rows.append({"kernel": "fused_attention", "mode": "nomask",
                     "shape": list(shape), "layout": "projection",
                     "dtype": "bfloat16", "launches": launches,
                     **attention_bound(B, N, S, D, "fused_nomask"),
                     **paired_queued_ms(
                         lambda: fused.fused_attention(q, k, v),
                         lambda: fused.fused_attention_reference(q, k, v),
                         _sdpa(torch, q, k, v, None), 20),
                     **loop_times(lambda loop: fused._launch(
                         q, k, v, None, loop=loop), S, D, queued_ms, 20)})
    return with_sdpa_ratio(rows)


def loop_times(launch, S, D, timer, iters) -> dict:
    """The bf16 tile loop ``tile_loop`` serves a timed attention row with,
    and the other bf16 loop's ms on the same inputs (``launch(loop)``;
    ``timer``: cuda_ms or queued_ms, the mean of two runs)."""
    import torch

    from marqo_tpu_torch.ops.flash_attention import tile_loop
    loop = tile_loop(S, D, torch.bfloat16)
    other = OTHER_LOOP[loop]
    runs = [timer(lambda: launch(other), iters) for _ in range(2)]
    return {"loop": loop, "other_loop": other,
            "other_loop_ms": sum(runs) / 2, "other_loop_ms_runs": runs}


def with_sdpa_ratio(rows) -> list:
    """Each attention row with ``sdpa_ratio``: its ms over the SDPA call's
    (``library_ms``), both timed in this run."""
    for row in rows:
        if row["kernel"] in ATTENTION_COUNTERS:
            row["sdpa_ratio"] = row["ms"] / row["library_ms"]
    return rows


def _sdpa(torch, q, k, v, allowed):
    """The library yardstick of the attention kernels: one
    scaled_dot_product_attention call with an additive -1e9 mask made
    beforehand from the kernel's compact mask (None: no mask)."""
    import torch.nn.functional as F
    if allowed is None:
        return lambda: F.scaled_dot_product_attention(q, k, v)
    bias = torch.zeros(allowed.shape, dtype=q.dtype, device=q.device)
    bias = bias.masked_fill(~allowed, -1e9)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def _int8_yardstick(torch, qm, x, w_q, w_scale, bias):
    """The library yardstick of B3 (never on the path): plain torch row
    quantization, then torch._int_mm (int8 x int8 -> int32), then the
    epilogue."""
    w_t = w_q.t()

    def run():
        x_q, x_scale = qm.quantize_rows(x.float())
        acc = torch._int_mm(x_q, w_t)
        return (acc.float() * x_scale * w_scale + bias).to(x.dtype)
    return run


def phase_timing(fa, fused, qm, torch, clip_model, pixels, int8_encoder,
                 bf16_encoder):
    from dataclasses import replace

    import torch.nn.functional as F

    from marqo_tpu_torch.models.bert import encode_tokens
    from marqo_tpu_torch.models.clip import encode_clip_image
    rows = []
    # each attention row in the contiguous (B, N, S, D) layout that earlier
    # runs timed, and at the main-path shapes also in the encoders' own
    # layout (views of the (B, S, N*D) projection outputs); SDPA takes the
    # same tensors. Queued (queued_ms): back to back, a call's ~45-60 us of
    # host time hides the wgmma loop's device time at (16, 16, 257, 64)
    for B, S in ((256, 128), (1, 32)):
        q, k, v, pad, seg = attention_inputs(B, 12, S, 64, torch.bfloat16,
                                             seed=B)
        for layout, q, k, v in layouts(q, k, v, ("contiguous", "projection")
                                         if B > 1 else ("contiguous",)):
            for mode, mask, kernel, plain, allowed in (
                    ("padding", pad, fa.attention_padding,
                     fa.attention_padding_reference,
                     (pad > 0)[:, None, None, :]),
                    ("segment", seg, fa.attention_segment,
                     fa.attention_segment_reference,
                     ((seg[:, :, None] == seg[:, None, :]) &
                      (seg[:, None, :] > 0))[:, None])):
                rows.append({"kernel": "masked_attention", "mode": mode,
                             "shape": [B, 12, S, 64], "layout": layout,
                             "dtype": "bfloat16",
                             **attention_bound(B, 12, S, 64, mode, mask),
                             **paired_queued_ms(
                                 lambda: kernel(q, k, v, mask),
                                 lambda: plain(q, k, v, mask),
                                 _sdpa(torch, q, k, v, allowed), 20),
                             **loop_times(lambda loop: fa._launch(
                                 q, k, v, mask, mode, loop=loop), S, 64,
                                 queued_ms, 20)})
    for B, N, S in ((16, 16, 257), (1, 16, 257), (256, 12, 128)):
        q, k, v, _, seg = attention_inputs(B, N, S, 64, torch.bfloat16,
                                           seed=B)
        for layout, q, k, v in layouts(q, k, v, ("contiguous", "projection")
                                         if B > 1 else ("contiguous",)):
            for mode, mask, allowed in (
                    ("nomask", {}, None),
                    ("segment", {"segment_ids": seg},
                     (seg[:, :, None] == seg[:, None, :])[:, None])):
                rows.append({"kernel": "fused_attention", "mode": mode,
                             "shape": [B, N, S, 64], "layout": layout,
                             "dtype": "bfloat16",
                             **attention_bound(B, N, S, 64, "fused_" + mode,
                                               mask.get("segment_ids")),
                             **paired_queued_ms(
                                 lambda: fused.fused_attention(q, k, v,
                                                               **mask),
                                 lambda: fused.fused_attention_reference(
                                     q, k, v, **mask),
                                 _sdpa(torch, q, k, v, allowed), 20),
                             **loop_times(lambda loop: fused._launch(
                                 q, k, v, mask.get("segment_ids"),
                                 loop=loop), S, 64, queued_ms, 20)})
    # B3 at the padded ingest batch's four linear shapes and at a batch-1
    # query's packed q, k, v and FFN; beside it the bf16 F.linear that the
    # int8 path replaces, the library yardstick and torch._int_mm alone,
    # and its two kernels apart (torch.profiler)
    for M, K, N in ((32768, 768, 768), (32768, 768, 2304),
                    (32768, 768, 3072), (32768, 3072, 768), (32, 768, 2304),
                    (32, 768, 3072)):
        x, w_q, w_scale, bias = w8a8_inputs(M, K, N, torch.bfloat16, seed=M)
        weight = (0.05 * torch.randn(N, K, device=DEVICE)).to(torch.bfloat16)
        bias16 = bias.to(torch.bfloat16)
        x_q = qm.quantize_rows(x.float())[0]
        iters = 20 if M > 32 else 200
        split = kernel_times_ms(
            lambda: qm.w8a8_matmul(x, w_q, w_scale, bias), iters,
            W8A8_KERNELS)
        rows.append({"kernel": "w8a8_matmul", "mode": "w8a8",
                     "shape": [M, K, N], "dtype": "bfloat16",
                     **w8a8_bound(M, K, N),
                     "quantize_ms": split["w8a8_quantize_rows"],
                     "gemm_ms": split["w8a8_gemm"],
                     **paired_ms(
                         lambda: qm.w8a8_matmul(x, w_q, w_scale, bias),
                         lambda: qm.w8a8_matmul_reference(x, w_q, w_scale,
                                                          bias), iters),
                     "library_ms": cuda_ms(_int8_yardstick(
                         torch, qm, x, w_q, w_scale, bias), iters),
                     "int_mm_ms": cuda_ms(lambda: torch._int_mm(x_q, w_q.t()),
                                          iters),
                     "bf16_linear_ms": cuda_ms(
                         lambda: F.linear(x, weight, bias16), iters)})
        if M > 32 and N == 768:
            # the quantizer alone at K = 768 and 3072, against its bound
            rows.append({"kernel": "w8a8_quantize_rows", "mode": "w8a8",
                         "shape": [M, K], "dtype": "bfloat16",
                         "ms": split["w8a8_quantize_rows"],
                         **quantize_bound(M, K)})
    # ROADMAP C1's head dims on B1, both modes, and B2's no-mask mode at
    # the SigLIP towers' shapes and at the CoCa, EVA02 and LanguageBind
    # towers' (NEW_B2_SHAPES), in the projections' layout; B3 at K = 5120
    # (queued: at these shapes one call holds the host longer than the
    # device)
    def attention_row(name, mode, shape, bounds, kernel, plain, allowed,
                      q, k, v, launch):
        return {"kernel": name, "mode": mode, "shape": shape,
                "layout": "projection", "dtype": "bfloat16", **bounds,
                **paired_queued_ms(kernel, plain,
                                   _sdpa(torch, q, k, v, allowed), 20),
                **loop_times(launch, shape[2], shape[3], queued_ms, 20)}

    for B, N, S, D in C1_B1_CASES:
        q, k, v, pad, seg = attention_inputs(B, N, S, D, torch.bfloat16,
                                             seed=D)
        q, k, v = projection_views(q, k, v, "projection")
        for mode, mask, kernel, plain, allowed in (
                ("padding", pad, fa.attention_padding,
                 fa.attention_padding_reference, (pad > 0)[:, None, None, :]),
                ("segment", seg, fa.attention_segment,
                 fa.attention_segment_reference,
                 ((seg[:, :, None] == seg[:, None, :]) &
                  (seg[:, None, :] > 0))[:, None])):
            rows.append(attention_row(
                "masked_attention", mode, [B, N, S, D],
                attention_bound(B, N, S, D, mode, mask),
                lambda: kernel(q, k, v, mask), lambda: plain(q, k, v, mask),
                allowed, q, k, v, lambda loop: fa._launch(
                    q, k, v, mask, mode, loop=loop)))
    for B, N, S, D in SIGLIP_ATTENTION_SHAPES + NEW_B2_SHAPES:
        q, k, v, _, _ = attention_inputs(B, N, S, D, torch.bfloat16, seed=S)
        q, k, v = projection_views(q, k, v, "projection")
        rows.append(attention_row(
            "fused_attention", "nomask", [B, N, S, D],
            attention_bound(B, N, S, D, "fused_nomask"),
            lambda: fused.fused_attention(q, k, v),
            lambda: fused.fused_attention_reference(q, k, v), None, q, k, v,
            lambda loop: fused._launch(q, k, v, None, loop=loop)))
    M, K, N = C1_W8A8_CASES[0]
    x, w_q, w_scale, bias = w8a8_inputs(M, K, N, torch.bfloat16, seed=M)
    weight = (0.05 * torch.randn(N, K, device=DEVICE)).to(torch.bfloat16)
    bias16 = bias.to(torch.bfloat16)
    x_q = qm.quantize_rows(x.float())[0]
    split = kernel_times_ms(lambda: qm.w8a8_matmul(x, w_q, w_scale, bias), 20,
                            W8A8_KERNELS)
    rows.append({"kernel": "w8a8_matmul", "mode": "w8a8", "shape": [M, K, N],
                 "dtype": "bfloat16", **w8a8_bound(M, K, N),
                 "quantize_ms": split["w8a8_quantize_rows"],
                 "gemm_ms": split["w8a8_gemm"],
                 **paired_queued_ms(
                     lambda: qm.w8a8_matmul(x, w_q, w_scale, bias),
                     lambda: qm.w8a8_matmul_reference(x, w_q, w_scale, bias),
                     _int8_yardstick(torch, qm, x, w_q, w_scale, bias), 20),
                 "int_mm_ms": queued_ms(lambda: torch._int_mm(x_q, w_q.t()),
                                        20),
                 "bf16_linear_ms": queued_ms(
                     lambda: F.linear(x, weight, bias16), 20)})
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
    # the int8 encoder against the bf16 encoder on the same weights, one
    # padded e5 ingest batch (256 x 128, all tokens real)
    ids = torch.randint(5, E5_BASE["vocab_size"], (256, 128), device=DEVICE,
                        dtype=torch.int32)
    mask = torch.ones_like(ids)

    def encode(model):
        def run():
            with torch.inference_mode():
                encode_tokens(model, ids, mask)
        return run

    enc = paired_ms(encode(int8_encoder), encode(bf16_encoder), 5)
    # the bf16 encoder on a realistic ingest batch: 256 documents of
    # log-normal lengths around 60 tokens in the 128 bucket
    # (scripts/profile_torch_encoder.py's batch), padded and packed
    import numpy as np

    from marqo_tpu_torch.models.bert import encode_tokens_packed
    from marqo_tpu_torch.ops.packing import pack_sequences
    rng = np.random.default_rng(0)
    lengths = np.clip(rng.lognormal(np.log(60), 0.5, 256), 4, 128).astype(int)
    mixed = rng.integers(5, E5_BASE["vocab_size"], (256, 128)).astype(
        np.int32)
    mixed_mask = (np.arange(128)[None] < lengths[:, None]).astype(np.int32)
    mixed *= mixed_mask
    packed = pack_sequences([mixed[i, :lengths[i]] for i in range(256)],
                            seq_len=128, pad_id=0)
    on = {name: torch.from_numpy(getattr(packed, name)).to(DEVICE)
          for name in ("input_ids", "segment_ids", "positions", "seq_index")}
    mixed, mixed_mask = (torch.from_numpy(a).to(DEVICE)
                         for a in (mixed, mixed_mask))

    def padded_mixed():
        with torch.inference_mode():
            encode_tokens(bf16_encoder, mixed, mixed_mask)

    def packed_mixed():
        with torch.inference_mode():
            encode_tokens_packed(bf16_encoder, on["input_ids"],
                                 on["segment_ids"], on["positions"],
                                 on["seq_index"], packed.n_sequences)

    mix = paired_ms(packed_mixed, padded_mixed, 5)
    encoder_row = {"batch": [256, 128], "int8_ms": enc["ms"],
                   "bf16_ms": enc["plain_ms"], "int8_ms_runs": enc["ms_runs"],
                   "bf16_ms_runs": enc["plain_ms_runs"],
                   "bf16_lognormal_padded_ms": mix["plain_ms"],
                   "bf16_lognormal_packed_ms": mix["ms"],
                   "bf16_lognormal_padded_ms_runs": mix["plain_ms_runs"],
                   "bf16_lognormal_packed_ms_runs": mix["ms_runs"],
                   "packed_rows": int(packed.input_ids.shape[0])}
    return with_sdpa_ratio(rows), vit_row, encoder_row


# --- encoder_graphs: one CUDA graph per bucket (inference/graphs.py) ---------

GRAPH_QUERY_SEQS = (16, 32, 64)  # the e5 query at batch 1 (warmup's buckets)
GRAPH_INGEST = (256, 128)        # the padded ingest step
GRAPH_DOCS = 256                 # the packed step's documents
GRAPH_IMAGES = 16                # ViT-L/14's image batch (bench --images)
GRAPH_STEPS = 20                 # steps a timing
# packed pooling sums with index_add_, whose atomics add in no fixed order
# (models/bert.py packed_segment_sums): replay and eager differ in the
# last bits; tests/test_packing.py's tolerance
GRAPH_PACKED_ATOL = 2e-5


def ragged_tokens(n: int, S: int, vocab: int, seed: int):
    """n rows of S token ids with log-normal lengths around 60 tokens
    (clipped to 4..S), zero past each length, and their 0/1 mask."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(60), 0.5, n), 4, S).astype(int)
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(5, vocab, (n, S)).astype(np.int32) * mask
    return ids, mask


def packed_rows(ids, mask, S: int):
    """The packed path's host rows for ``ids`` (ops/packing.py at the
    row ladder), and n_bucket."""
    from marqo_tpu_torch.inference.batching import (pick_batch_bucket,
                                                    row_buckets)
    from marqo_tpu_torch.ops.packing import pack_sequences
    packed = pack_sequences([row[:m.sum()] for row, m in zip(ids, mask)],
                            seq_len=S, pad_id=0, row_buckets=row_buckets())
    return ((packed.input_ids, packed.segment_ids, packed.positions,
             packed.seq_index), packed.n_sequences,
            pick_batch_bucket(packed.n_sequences))


def graph_label(key) -> str:
    """An EncoderGraphs key as "tower shape [n_bucket]"."""
    tower, _, static, inputs = key
    shape = "x".join(map(str, inputs[0][0]))
    extra = [v for v in static if isinstance(v, int)]
    return " ".join([tower, shape] + [f"n{v}" for v in extra])


def tower_step(model, tower: str, array):
    """One batch of a CLIP tower through the model's graph of its bucket,
    as ``TorchCLIPModel._run`` calls it, left on the card."""
    module = getattr(model.encoder, tower)
    return model.graphs.run(tower, model.compute_dtype,
                            lambda x: getattr(model.encoder, tower)(x),
                            array, static=(module.config,))


def device_busy_ms(torch, step, steps: int) -> tuple:
    """Device ms a step: the CUDA-side events of torch.profiler over
    ``steps`` calls (kernels inside a graph's replay among them); where it
    shows none, the steps queued behind a device sleep (``queued_ms``).
    Returns (ms, source, the profiled window's wall ms a step)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1000 / steps
    total_us = 0.0
    for event in prof.key_averages():
        if event.device_type.name != "CUDA":
            continue
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = event.cuda_time_total
        total_us += device_us
    if total_us > 0:
        return total_us / 1000 / steps, "torch.profiler", wall
    return queued_ms(step, steps), "queued CUDA events", wall


def host_device_split(torch, step, steps: int = GRAPH_STEPS) -> dict:
    """A step's host ms (the call alone, the card idle before it; median),
    its wall ms back to back (host clock, ending in a synchronize), its
    device ms (``device_busy_ms``) and the device's busy share of the
    wall time; ``profiled_busy_share`` is the device ms over the profiled
    window's own wall ms, as scripts/profile_torch_encoder.py reads it
    (the profiler's host overhead in it), and device ms over an
    unprofiled wall may pass 1 by the kernels' own slowdown under the
    profiler."""
    step()
    host = []
    for _ in range(steps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step()
        host.append((time.perf_counter() - start) * 1000)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - start) * 1000 / steps
    device, source, profiled_wall = device_busy_ms(torch, step, steps)
    return {"host_ms": statistics.median(host), "wall_ms": wall,
            "device_ms": device, "busy_share": device / wall,
            "profiled_busy_share": device / profiled_wall,
            "device_ms_from": source}


def phase_encoder_graphs(torch, smi):
    """The encoders as served on CUDA, one graph per bucket: e5-base-v2
    width (bf16 and int8, the serve phases' models) and ViT-L/14's towers,
    loaded fresh and warmed as a worker warms them (each warmup bucket
    captured; the packed key at its first use). Every key's replay
    against the eager forward on the same inputs: padded and CLIP equal
    bit for bit, packed within GRAPH_PACKED_ATOL; the kernels' launches a
    replay equal to the eager forward's (12 B1 an e5 batch, 48 B3 an int8
    batch, 24 B2 a ViT-L/14 image batch). The control: inputs put in a
    fresh tensor, not the static buffer, leave the replay on the old
    inputs. Then host ms, device ms and the busy share, eager against
    graph, at the query, ingest, packed, int8 and image batches; capture
    seconds by bucket and the graphs' pool."""
    import numpy as np

    from marqo_tpu_torch.inference.batching import batched_device_encode
    from marqo_tpu_torch.inference.loaders import TorchHFTextModel
    from marqo_tpu_torch.models.bert import encode_tokens
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    from marqo_tpu_torch.parallel.serving import run_data_parallel
    mib = 2 ** 20
    layers = E5_BASE["num_layers"]
    vocab = E5_BASE["vocab_size"]
    B, S = GRAPH_INGEST

    def reserved():
        """The card memory the process's allocator holds once its unused
        cached blocks are released: what is left of the graphs' pools
        counts, their static inputs and outputs beside them."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    def loaded(cls, props):
        model = cls(props["name"], props, _device())
        model.load()
        before = reserved()
        start = time.perf_counter()
        buckets = model.warmup() if cls is TorchHFTextModel else \
            model.warmup(GRAPH_IMAGES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        return model, {"buckets": buckets, "seconds": seconds,
                       "graphs_mib": (reserved() - before) / mib}

    models, warmups = {}, {}
    for name, cls, props in (
            ("e5_bf16", TorchHFTextModel, e5_props()),
            ("e5_int8", TorchHFTextModel,
             {**e5_props(), "name": "smoke-e5-base-v2-int8",
              "quantize": True}),
            ("vit_l14", TorchCLIPModel, vit_l14_props())):
        models[name], warmups[name] = loaded(cls, props)
    bf16, int8, clip = (models[n] for n in ("e5_bf16", "e5_int8", "vit_l14"))
    check(int8.config.quantize and not bf16.config.quantize,
          "encoder_graphs: the int8 model is not quantized")

    def compared(label, eager_fn, graph_fn, exact, expected):
        """eager_fn() and graph_fn() on the same inputs, each with the
        launch counts set to 0 before it and read after."""
        reset_counts()
        eager = eager_fn()
        torch.cuda.synchronize()
        eager_counts = read_counts()
        reset_counts()
        out = graph_fn()
        torch.cuda.synchronize()
        graph_counts = read_counts()
        eager, out = (torch.as_tensor(t) for t in (eager, out))
        err = float((out.float() - eager.float()).abs().max())
        ok = torch.equal(out, eager) if exact else err <= GRAPH_PACKED_ATOL
        check(ok and tuple(out.shape) == tuple(eager.shape) and
              bool(torch.isfinite(out).all()),
              f"encoder_graphs {label}: replay against eager, max |diff| "
              f"{err} ({'bit for bit' if exact else GRAPH_PACKED_ATOL})")
        check(graph_counts == eager_counts,
              f"encoder_graphs {label}: launches a replay {graph_counts}, "
              f"eager {eager_counts}")
        for counter, n in expected.items():
            check(graph_counts[counter] == n,
                  f"encoder_graphs {label}: {counter} {graph_counts[counter]}"
                  f" a replay, expected {n}")
        return {"label": label, "max_abs_diff": err,
                "tolerance": "bit for bit" if exact else GRAPH_PACKED_ATOL,
                "launches_a_replay": {k: v for k, v in graph_counts.items()
                                      if v}}

    comparisons = []
    for name, model in (("e5_bf16", bf16), ("e5_int8", int8)):
        b3 = {"w8a8_matmul": 4 * layers} if model is int8 else {}
        keys = sorted(model.graphs.graphs, key=graph_label)
        check(len(keys) == warmups[name]["buckets"] and
              all(key[0] == "padded" for key in keys),
              f"encoder_graphs {name}: warmup captured {keys}")
        for i, key in enumerate(keys):
            rows, seq = key[3][0][0]
            ids, mask = ragged_tokens(rows, seq, vocab, seed=10 + i)
            comparisons.append(compared(
                f"{name} {graph_label(key)}",
                lambda: run_data_parallel(model, encode_tokens, ids, mask),
                lambda: model._forward(ids, mask), True,
                {"masked_attention_padding": layers, **b3}))
        ids, mask = ragged_tokens(GRAPH_DOCS, S, vocab, seed=20)
        rows, n, n_bucket = packed_rows(ids, mask, S)
        model._packed(rows, n_bucket)  # captures the packed key
        comparisons.append(compared(
            f"{name} packed {rows[0].shape[0]}x{S} n{n_bucket}",
            lambda: model._packed_eager(rows, n_bucket)[:n],
            lambda: model._packed(rows, n_bucket)[:n], False,
            {"masked_attention_segment": layers, **b3}))
    rng = np.random.default_rng(30)
    size = clip.vision_config.image_size
    positions = clip.text_config.max_positions
    for key in sorted(clip.graphs.graphs, key=graph_label):
        tower, rows = key[0], key[3][0][0][0]
        if tower == "vision":
            array = rng.integers(0, 256, (rows, size, size, 3),
                                 dtype=np.uint8)
            expected = {"fused_attention_nomask":
                        VIT_L14_VISION["num_layers"]}
        else:
            array = rng.integers(1, clip.text_config.vocab_size - 1,
                                 (rows, positions)).astype(np.int32)
            array[np.arange(rows), rng.integers(2, positions, rows)] = \
                clip.text_config.eos_token_id
            expected = {}
        comparisons.append(compared(
            f"vit_l14 {graph_label(key)}",
            lambda: batched_device_encode(
                clip, array, lambda encoder, x: getattr(encoder, tower)(x)),
            lambda: clip._run(array, tower), True, expected))
    check(len(clip.graphs.graphs) == warmups["vit_l14"]["buckets"],
          f"encoder_graphs: ViT-L/14 keys {list(clip.graphs.graphs)}")

    # the control: the next batch in a fresh tensor, not the static buffer
    key = next(k for k in bf16.graphs.graphs
               if k[0] == "padded" and k[3][0][0] == (B, S))
    graph = bf16.graphs.graphs[key]
    ids_a, mask_a = ragged_tokens(B, S, vocab, seed=40)
    ids_b, mask_b = ragged_tokens(B, S, vocab, seed=41)
    out_a = bf16._forward(ids_a, mask_a)
    fresh = [torch.from_numpy(a).to(DEVICE) for a in (ids_b, mask_b)]
    with torch.inference_mode():
        stale = graph.replay()
        expected_b = encode_tokens(bf16.encoder, *fresh)
    torch.cuda.synchronize()
    control = {"stale_equals_b": bool(torch.equal(stale, expected_b)),
               "stale_equals_a": bool(torch.equal(stale, out_a)),
               "max_abs_diff_to_b": float(
                   (stale - expected_b).abs().max())}
    check(not control["stale_equals_b"] and control["stale_equals_a"],
          f"encoder_graphs control: a replay read inputs that were not "
          f"put in its static buffer: {control}")

    # host and device time, eager against graph
    query = {s: ragged_tokens(1, s, vocab, seed=50 + s)
             for s in GRAPH_QUERY_SEQS}
    ingest = ragged_tokens(B, S, vocab, seed=60)
    rows, n, n_bucket = packed_rows(*ragged_tokens(GRAPH_DOCS, S, vocab,
                                                   seed=20), S)
    pixels = rng.integers(0, 256, (GRAPH_IMAGES, size, size, 3),
                          dtype=np.uint8)

    def padded(model, ids, mask):
        return (lambda: run_data_parallel(model, encode_tokens, ids, mask),
                lambda: model._forward(ids, mask))

    batches = [(f"e5 query 1x{s}", *padded(bf16, *query[s]))
               for s in GRAPH_QUERY_SEQS]
    batches += [
        (f"e5 padded bf16 {B}x{S}", *padded(bf16, *ingest)),
        (f"e5 packed bf16 {rows[0].shape[0]}x{S} ({n} docs)",
         lambda: bf16._packed_eager(rows, n_bucket),
         lambda: bf16._packed(rows, n_bucket)),
        (f"e5 padded int8 {B}x{S}", *padded(int8, *ingest)),
        (f"ViT-L/14 {GRAPH_IMAGES} images",
         lambda: run_data_parallel(clip, lambda e, x: e.vision(x), pixels),
         lambda: tower_step(clip, "vision", pixels))]
    keys_before = {name: len(m.graphs.graphs) for name, m in models.items()}
    timing = []
    with torch.inference_mode():
        for label, eager, graphed in batches:
            row = {"batch": label}
            for mode, step in (("eager", eager), ("graph", graphed),
                               ("graph_again", graphed),
                               ("eager_again", eager)):
                row[mode] = host_device_split(torch, step)
            timing.append(row)
    check({name: len(m.graphs.graphs) for name, m in models.items()} ==
          keys_before, "encoder_graphs: the timing captured new keys")
    emit("encoder_graphs", ok=True, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, warmups=warmups, captures={
             name: {graph_label(k): g.seconds
                    for k, g in sorted(m.graphs.graphs.items(),
                                       key=lambda kv: graph_label(kv[0]))}
             for name, m in models.items()},
         comparisons=comparisons, control=control, timing=timing,
         memory_allocated_mib=torch.cuda.memory_allocated() / mib,
         memory_reserved_mib=torch.cuda.memory_reserved() / mib)
    return timing


# --- family_graphs: the other CLIP families, DINO and OWL-ViT ----------------

FAMILY_STEPS = 10  # steps a timing


def family_label(key) -> str:
    """``graph_label``, and "plain" where the key's config runs the
    kernels' twins."""
    plain = any(getattr(v, "attention_impl", None) == "plain"
                for v in key[2])
    return graph_label(key) + (" plain" if plain else "")


def _family_spec(name: str, obj) -> dict:
    """What phase_family_graphs needs of one family's loaded object (a
    CLIP-family wrapper, a DINO patcher, the OWL reranker): its graphs,
    its eager forward of a key (``forward(key, *tensors)``, the key's
    tower under the key's config), its host text rows of a shape
    (``text(shape, rng)``) and its kernels' launches a call of a key on
    the kernels (the twins' keys launch none)."""
    import numpy as np

    from marqo_tpu_torch.inference.rerank import owl_detections
    from marqo_tpu_torch.models.hf_clip import encode_hf_clip_text
    if name.startswith("dino"):
        model = obj.model
        return {"graphs": obj.graphs,
                "forward": lambda key, x: model.last_selfattention(x),
                "text": None,
                "launches": {"dino": {"fused_attention_nomask":
                                      model.config.num_layers - 1}}}
    if name == "owl":
        model = obj.model
        ids = obj._tokenize(["a red photo"])
        return {"graphs": obj.graphs,
                "forward": lambda key, pixels, ids: owl_detections(
                    model, pixels, ids),
                "text": lambda shape, rng: ids,
                "launches": {"detect": {"fused_attention_nomask":
                                        model.config.vision.num_layers}}}
    if name in LAST_FAMILIES:
        return _last_family_spec(name, obj)
    text_config, vision_config = obj.text_config, obj.vision_config
    vocab = text_config.vocab_size

    def forward(key, *tensors):
        module = getattr(obj.encoder, key[0])
        if name == "xlmr_clip" and key[0] == "text":
            x, = tensors
            return encode_hf_clip_text(obj.encoder, x[:, 0],
                                       x[:, 1].contiguous())
        config = module.config
        module.config = key[2][0]
        try:
            return module(*tensors)
        finally:
            module.config = config

    def text(shape, rng):
        if name in ("nllb_siglip", "xlmr_clip"):
            rows, S = shape[0], shape[-1]
            lengths = rng.integers(1, S + 1, rows)
            mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
            low = 2 if name == "nllb_siglip" else 5
            ids = rng.integers(low, vocab, (rows, S)).astype(np.int32)
            if name == "xlmr_clip":
                return np.stack([ids * mask, mask], axis=1)
            return np.where(mask > 0, ids, 1).astype(np.int32)
        if name in ("siglip", "coca"):
            return rng.integers(1, vocab, shape).astype(np.int32)
        # CLIP text towers pool at the EOS token
        ids = rng.integers(1, vocab - 1, shape).astype(np.int32)
        ids[np.arange(shape[0]), rng.integers(2, shape[1], shape[0])] = \
            text_config.eos_token_id
        return ids

    b1 = {"masked_attention_padding": text_config.num_layers}
    b2 = {"fused_attention_nomask": text_config.num_layers}
    # the ResNet and ConvNeXt towers run no kernel of this package
    vision_b2 = {} if name in ("rn50", "convnext_base") else \
        {"fused_attention_nomask": vision_config.num_layers}
    return {"graphs": obj.graphs, "forward": forward, "text": text,
            "launches": {
                "text": {"siglip": b2, "nllb_siglip": b1,
                         "xlmr_clip": b1}.get(name, {}),
                "vision": vision_b2}}


def graph_family_checks(torch, name: str, spec: dict, rng) -> dict:
    """One object's CUDA graphs (``spec``, as ``_family_spec`` gives it):
    every key it captured, replayed on new inputs of its shapes, against
    the eager forward of its tower and config on the same inputs: equal
    bit for bit, or for the cuDNN vision towers of RN50 and convnext_base,
    where no kernel of ours runs, bit for bit or within the bf16-vs-fp32
    bound of conv_clip_encode (cosine >= 1 - CONV_COS_TOL, the difference
    recorded); B1 and B2 launches a replay equal to the eager forward's
    and to the family's count. The control: the next batch in a fresh
    tensor, not the static buffer, leaves the replay on the old inputs.
    Then host, wall and device ms and the busy share, eager against graph,
    at ``spec["timed"]``'s keys (else each tower's largest batch); the
    keys, their capture seconds and the card's memory after."""
    import numpy as np
    start = time.perf_counter()
    mib = 2 ** 20
    dtypes = {str(d): d for d in (torch.bfloat16, torch.float16,
                                  torch.float32)}
    conv_vision = ("rn50", "convnext_base")
    cache = spec["graphs"]
    check(cache.device.type == DEVICE and len(cache.graphs) > 0,
          f"family_graphs {name}: no graphs on {DEVICE}: "
          f"{list(cache.graphs)}")

    def inputs(key):
        if "inputs" in spec:
            return spec["inputs"](key, rng)
        return [rng.integers(0, 256, shape, dtype=np.uint8)
                if dtype == "|u1" else spec["text"](shape, rng)
                for shape, dtype in key[3]]

    def eager(key, arrays):
        with torch.inference_mode():
            return spec["forward"](key, *[torch.from_numpy(a).to(DEVICE)
                                          for a in arrays])

    def replay(key, arrays):
        return cache.run(key[0], dtypes[key[1]], spec["forward"],
                         *arrays, static=key[2])

    keys = sorted(cache.graphs, key=family_label)
    comparisons = []
    for key in keys:
        arrays = inputs(key)
        reset_counts()
        ref = eager(key, arrays)
        torch.cuda.synchronize()
        eager_counts = read_counts()
        reset_counts()
        out = replay(key, arrays)
        torch.cuda.synchronize()
        graph_counts = read_counts()
        label = family_label(key)
        err = float((out.float() - ref.float()).abs().max())
        equal = bool(torch.equal(out, ref))
        # rows of a batch, or one row where the output is one vector
        rows = len(out) if out.dim() > 1 else 1
        cos = min_cos(out.reshape(rows, -1).float(),
                      ref.reshape(rows, -1).float())
        tolerance = "bit for bit"
        if name in conv_vision and key[0] == "vision":
            tolerance = f"bit for bit or cosine >= {1 - CONV_COS_TOL}"
        check((equal or (tolerance != "bit for bit" and
                         cos >= 1 - CONV_COS_TOL)) and
              tuple(out.shape) == tuple(ref.shape) and
              bool(torch.isfinite(out).all()),
              f"family_graphs {name} {label}: replay against eager, "
              f"max |diff| {err}, cosine {cos} ({tolerance})")
        expected = {} if label.endswith(" plain") else \
            spec["launches"][key[0]]
        check(graph_counts == eager_counts and
              {k: v for k, v in graph_counts.items() if v} ==
              {k: v for k, v in expected.items() if v},
              f"family_graphs {name} {label}: launches a replay "
              f"{graph_counts}, eager {eager_counts}, expected "
              f"{expected}")
        comparisons.append({
            "key": label, "bit_for_bit": equal, "max_abs_diff": err,
            "min_cosine": cos, "tolerance": tolerance,
            "launches_a_replay": {k: v for k, v in graph_counts.items()
                                  if v}})
    check(sorted(cache.graphs, key=family_label) == keys,
          f"family_graphs {name}: the comparisons captured new keys")

    # each tower's key of the largest batch, on the kernels
    largest = {}
    for key in keys:
        if not family_label(key).endswith(" plain") and (
                key[0] not in largest or
                key[3][0][0][0] > largest[key[0]][3][0][0][0]):
            largest[key[0]] = key
    timed = spec["timed"](keys) if "timed" in spec else \
        [largest[tower] for tower in sorted(largest)]
    # the control: the next batch in a fresh tensor, not the static
    # buffer
    key = largest.get("vision", largest.get("image", timed[0]))
    graph = cache.graphs[key]
    batch_a, batch_b = inputs(key), inputs(key)
    out_a = replay(key, batch_a)
    with torch.inference_mode():
        stale = graph.replay()
    expected_b = eager(key, batch_b)
    torch.cuda.synchronize()
    control = {"key": family_label(key),
               "stale_equals_b": bool(torch.equal(stale, expected_b)),
               "stale_equals_a": bool(torch.equal(stale, out_a))}
    check(not control["stale_equals_b"] and control["stale_equals_a"],
          f"family_graphs {name} control: a replay read inputs that "
          f"were not put in its static buffer: {control}")

    timing = []
    with torch.inference_mode():
        for key in timed:
            arrays = inputs(key)
            steps = {
                "eager": lambda key=key, arrays=arrays: spec["forward"](
                    key, *[torch.from_numpy(a).to(DEVICE)
                           for a in arrays]),
                "graph": lambda key=key, arrays=arrays: replay(key,
                                                               arrays)}
            row = {"key": family_label(key)}
            for mode in ("eager", "graph", "graph_again", "eager_again"):
                row[mode] = host_device_split(
                    torch, steps[mode.split("_")[0]], FAMILY_STEPS)
            timing.append(row)
    check(sorted(cache.graphs, key=family_label) == keys,
          f"family_graphs {name}: the timing captured new keys")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"keys": len(keys), "seconds": time.perf_counter() - start,
            "capture_seconds": {family_label(k): cache.graphs[k].seconds
                                for k in keys},
            "comparisons": comparisons, "control": control,
            "timing": timing,
            "memory_allocated_mib": torch.cuda.memory_allocated() / mib,
            "memory_reserved_mib": torch.cuda.memory_reserved() / mib}


def padded_token_rows(shape, vocab: int, rng, types: bool = False):
    """(B, S) int32 token ids of random lengths (at least one token), their
    0/1 mask and, with ``types``, token types that switch to 1 at a random
    point inside each length (a query-document pair)."""
    import numpy as np
    rows, S = shape
    lengths = rng.integers(1, S + 1, rows)
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(5, vocab, shape) * mask).astype(np.int32)
    if not types:
        return [ids, mask]
    split = rng.integers(0, lengths)
    pair = ((np.arange(S)[None] > split[:, None]) & (mask > 0))
    return [ids, mask, pair.astype(np.int32)]


def _last_family_spec(name: str, obj) -> dict:
    """``_family_spec`` for LAST_FAMILIES: Stella's padded forward, the
    cross-encoder's scores, the YOLOX and Faster R-CNN patchers' models
    (inside ``fp32_convolutions``; Faster R-CNN's levels as the patcher's
    one tensor) and LanguageBind's towers, each under its key's config."""
    import numpy as np

    from marqo_tpu_torch.models.cross_encoder import cross_encoder_scores
    from marqo_tpu_torch.models.frcnn import flatten_levels
    from marqo_tpu_torch.models.languagebind import TOWERS
    if name == "stella":
        config = obj.encoder.config

        def timed(keys):
            largest = max(keys, key=lambda k: k[3][0][0][0])
            return [k for k in keys if k[3][0][0] in STELLA_TIMED] + \
                ([largest] if largest[3][0][0] not in STELLA_TIMED else [])

        return {"graphs": obj.graphs,
                "forward": lambda key, ids, mask: obj.encode_tokens(
                    obj.encoder, ids, mask),
                "inputs": lambda key, rng: padded_token_rows(
                    key[3][0][0], config.vocab_size, rng),
                "timed": timed,
                "launches": {"padded": {"masked_attention_padding":
                                        config.num_layers}}}
    if name == "cross_encoder":
        model = obj.model
        return {"graphs": obj.graphs,
                "forward": lambda key, *arrays: cross_encoder_scores(
                    model, *arrays),
                "inputs": lambda key, rng: padded_token_rows(
                    key[3][0][0], model.config.vocab_size, rng, types=True),
                "launches": {"scores": {"masked_attention_padding":
                                        model.config.num_layers}}}
    if name in ("yolox", "frcnn"):
        model = obj.model

        def pixels(key, rng):
            shape = key[3][0][0]
            if name == "yolox":  # YOLOX's pixels / 255, as patch_serve
                return [rng.uniform(0, 1, shape).astype(np.float32)]
            return [rng.standard_normal(shape).astype(np.float32)]

        forward = model if name == "yolox" else \
            (lambda x: flatten_levels(model(x)))
        return {"graphs": obj.graphs, "forward": lambda key, x: forward(x),
                "inputs": pixels, "launches": {name: {}}}
    encoder = obj.encoder
    eos = obj.text_config.eos_token_id

    def forward(key, x):
        tower = getattr(encoder, TOWERS[key[0]])
        config = tower.config
        tower.config = key[2][0]
        try:
            return tower(x)
        finally:
            tower.config = config

    def inputs(key, rng):
        (shape, dtype), = key[3]
        if dtype == "|u1":
            return [rng.integers(0, 256, shape, dtype=np.uint8)]
        if key[0] == "audio":  # log-mel values
            return [rng.standard_normal(shape).astype(np.float32)]
        # CLIP text towers pool at the EOS token
        ids = rng.integers(1, eos, shape).astype(np.int32)
        ids[np.arange(shape[0]), rng.integers(2, shape[1], shape[0])] = eos
        return [ids]

    b2 = {"fused_attention_nomask": obj.vision_config.num_layers}
    video = obj.video_config
    return {"graphs": obj.graphs, "forward": forward, "inputs": inputs,
            "launches": {
                "text": {}, "image": b2,
                "audio": {"fused_attention_nomask":
                          obj.audio_config.num_layers},
                "video": {"fused_attention_nomask": video.num_layers * (
                    2 if video.add_time_attn else 1)} if video else {}}}


def phase_family_graphs(torch, smi):
    """The families whose towers this port graphs beside e5 and ViT-L/14,
    on the objects their phases loaded and served (GRAPHED_FAMILIES):
    SigLIP B-16, NLLB-SigLIP base, CoCa and EVA02 ViT-L/14, XLM-R/ViT-B-32,
    RN50, convnext_base, the dino-v1 and dino-v2 patchers and the OWL-ViT
    B/32 reranker, each through ``graph_family_checks``."""
    import numpy as np
    rng = np.random.default_rng(70)
    results = {}
    for name in ("siglip", "nllb_siglip", "coca", "eva02", "xlmr_clip",
                 "rn50", "convnext_base", "dino-v1", "dino-v2", "owl"):
        check(name in GRAPHED_FAMILIES,
              f"family_graphs: no {name} model was registered")
        results[name] = graph_family_checks(
            torch, name, _family_spec(name, GRAPHED_FAMILIES[name]), rng)
    emit("family_graphs", ok=True, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, steps=FAMILY_STEPS, families=results)
    return results


def detector_graph_errors(torch, name: str, patcher) -> dict:
    """The YOLOX or Faster R-CNN patcher's graph replayed on the inputs
    patch_serve held eagerly (DETECTOR_INPUTS), with cuDNN's TF32 on in
    the process as a served process has it, against the same module's
    fp32 CPU run (``detector_error``): its capture ran inside the forward's
    ``fp32_convolutions``. The control: a graph captured from the forward's
    body, outside that block, keeps TF32 plans and must miss by more than
    DETECTOR_REL_TOL."""
    import copy

    from marqo_tpu_torch.inference.graphs import EncoderGraphs
    from marqo_tpu_torch.models.frcnn import flatten_levels, split_levels
    model = patcher.model
    host = copy.deepcopy(model).cpu()
    (key,) = patcher.graphs.graphs

    def body(x):
        out = model._forward(x)
        return out if name == "yolox" else flatten_levels(out)

    def split(out):
        return out if name == "yolox" else split_levels(out, patcher.config)

    control_graphs = EncoderGraphs(DEVICE)
    errors = {"replay": 0.0, "control": 0.0}
    setting = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for x in DETECTOR_INPUTS[name]:
            with torch.inference_mode():
                ref = host(x)
            array = x.numpy()
            replay = patcher.graphs.run(key[0], torch.float32, None, array,
                                        static=key[2])
            control = control_graphs.run("control", torch.float32, body,
                                         array)
            errors["replay"] = max(errors["replay"],
                                   detector_error(split(replay), ref))
            errors["control"] = max(errors["control"],
                                    detector_error(split(control), ref))
    finally:
        torch.backends.cudnn.allow_tf32 = setting
    del control_graphs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(errors["replay"] <= DETECTOR_REL_TOL < errors["control"],
          f"{name} graph with TF32 on in the process, card vs fp32 CPU: "
          f"relative error {errors['replay']} (tolerance "
          f"{DETECTOR_REL_TOL}; the control, a graph of the forward's "
          f"body with TF32 on, {errors['control']})")
    return {"images": len(DETECTOR_INPUTS[name]), **errors}


LAST_FAMILIES = ("stella", "cross_encoder", "yolox", "frcnn", "languagebind")
# Stella's query and a 16-document batch, captured by its own warmup
STELLA_TIMED = ((1, 16), (16, 128))


def phase_last_family_graphs(torch, smi):
    """The encoders graphed last, on the objects their phases loaded and
    served (GRAPHED_FAMILIES): Stella 400M, the MiniLM-L-6 cross-encoder,
    the YOLOX-S and Faster R-CNN patchers and LanguageBind's four towers
    at ViT-L/14, each through ``graph_family_checks`` (Stella's warmup
    first captures STELLA_TIMED, which are timed beside its largest served
    key); then the detectors' replays against the fp32 CPU run and the
    TF32 control (``detector_graph_errors``)."""
    import numpy as np
    start = time.perf_counter()
    for name in LAST_FAMILIES:
        check(name in GRAPHED_FAMILIES,
              f"last_family_graphs: no {name} object was registered")
    stella = GRAPHED_FAMILIES["stella"]
    stella.warmup([list(shape) for shape in STELLA_TIMED])
    rng = np.random.default_rng(71)
    results = {}
    for name in LAST_FAMILIES:
        results[name] = graph_family_checks(
            torch, name, _family_spec(name, GRAPHED_FAMILIES[name]), rng)
    for name in ("yolox", "frcnn"):
        results[name]["graph_vs_fp32_cpu"] = detector_graph_errors(
            torch, name, GRAPHED_FAMILIES[name])
    emit("last_family_graphs", ok=True,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         steps=FAMILY_STEPS, seconds=time.perf_counter() - start,
         families=results)
    return results


# DeepSeek-V2-Lite's latent attention (16 heads, q/k 192 = 128 + 64 RoPE, v
# 128, YaRN's softmax scale) in a two-layer model narrow elsewhere, for
# the causal instances of B1 at the shapes the model's own path gives them
DSV2_SMALL = {"hidden_size": 512, "num_attention_heads": 16,
              "num_key_value_heads": 16, "qk_nope_head_dim": 128,
              "qk_rope_head_dim": 64, "v_head_dim": 128, "kv_lora_rank": 128,
              "intermediate_size": 1024, "moe_intermediate_size": 128,
              "vocab_size": 300, "num_hidden_layers": 2}
DSV2_SCALE = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
# one dsv2_lite.bulk_ingest request's chunks at the checkpoint's one token
# a byte: 64 titles of 4-12 words (5-14 tokens with BOS) and 128 body
# chunks of 6 sentences of 6-30 words (40-190 tokens)
DSV2_TITLES, DSV2_CHUNKS = 64, 128


def dsv2_texts(seed: int) -> list:
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(4, 14, DSV2_TITLES)) + \
        list(rng.integers(39, 190, DSV2_CHUNKS))
    return ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, n))
            for n in lengths]


def dsv2_causal_checks(fa, torch, shape, mode) -> list:
    """B1's causal ``mode`` at (B, 16, S, 192/128) against its twin, fp32
    and bf16, each bf16 case with the scale control."""
    B, N, S, _ = shape
    kernel, plain = {
        "padding": (fa.attention_padding, fa.attention_padding_reference),
        "segment": (fa.attention_segment, fa.attention_segment_reference)
    }[mode]
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, k, v, pad, seg = mla_inputs(B, N, S, dtype, seed=B * S)
        mask = pad if mode == "padding" else seg
        out = kernel(q, k, v, mask, causal=True, scale=DSV2_SCALE)
        torch.cuda.synchronize()
        check(out.dtype == dtype and tuple(out.shape) == (B, N, S, 128) and
              is_projection_layout(out),
              f"causal output {out.dtype} {tuple(out.shape)} strides "
              f"{out.stride()}")
        label = f"causal kernel vs twin ({mode}, {dname}, {list(shape)})"
        check(bool(torch.isfinite(out).all()), f"non-finite output: {label}")
        ref = plain(q, k, v, mask, causal=True, scale=DSV2_SCALE)
        control = plain(q * SCALE_CONTROL, k, v, mask, causal=True,
                        scale=DSV2_SCALE)
        results.append({"mode": mode, "dtype": dname, "shape": list(shape),
                        **check_attention(out, ref, control, label)})
    return results


def dsv2_causal_timing(fa, torch, shape, mode) -> dict:
    """B1's causal ``mode`` at ``shape`` in bf16, queued, beside its twin
    and SDPA with the same mask as an additive bias; the bound of its own
    mask at q/k 192 and v 128."""
    B, N, S, _ = shape
    q, k, v, pad, seg = mla_inputs(B, N, S, torch.bfloat16, seed=B * S)
    mask = pad if mode == "padding" else seg
    kernel, plain = {
        "padding": (fa.attention_padding, fa.attention_padding_reference),
        "segment": (fa.attention_segment, fa.attention_segment_reference)
    }[mode]
    if mode == "padding":
        allowed = (mask > 0)[:, None, :].expand(B, S, S)
    else:
        allowed = (mask[:, :, None] == mask[:, None, :]) & \
            (mask[:, None, :] > 0)
    allowed = (allowed & torch.ones(S, S, dtype=torch.bool,
                                    device=mask.device).tril())[:, None]
    import torch.nn.functional as F
    bias = torch.zeros(allowed.shape, dtype=q.dtype, device=q.device
                       ).masked_fill(~allowed, -1e9)
    times = paired_queued_ms(
        lambda: kernel(q, k, v, mask, causal=True, scale=DSV2_SCALE),
        lambda: plain(q, k, v, mask, causal=True, scale=DSV2_SCALE),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                               scale=DSV2_SCALE), 20)
    return {"mode": mode, "shape": list(shape), "loop": "mma_sync",
            **times, **attention_bound(B, N, S, 192, mode, mask, dv=128,
                                       causal=True)}


def phase_dsv2_attention(fa, torch, smi) -> dict:
    """B1's causal instances on DeepSeek-V2's path: a two-layer model at the
    latent attention's widths (DSV2_SMALL) loaded as the hf type loads a
    deepseek_v2 checkpoint, one request's chunks of the bulk-ingest cell
    encoded through the packed, graphed path and one query through the
    padded one, every launch counter set to 0 just before each and read
    just after, with the shapes launched. Each launched shape, and the
    padding mode at the packed shapes, held against the twin
    (``dsv2_causal_checks``); the packed path's most launched shape and
    the query's timed (``dsv2_causal_timing``). Returns the kernels
    line's two rows."""
    from tests.deepseek_v2_checkpoint import TINY, write_checkpoint

    from marqo_tpu_torch.inference import loaders
    from marqo_tpu_torch.inference.types import Device
    config = dict(TINY, **DSV2_SMALL)
    with tempfile.TemporaryDirectory() as tmp:
        directory = write_checkpoint(os.path.join(tmp, "dsv2"), c=config)
        model = loaders.load_model("dsv2-smoke", {
            "type": "hf", "name": "dsv2-smoke", "localpath": directory,
            "dimensions": DSV2_SMALL["hidden_size"], "tokens": 512,
            "pooling_method": "mean"}, Device.CUDA)
    texts = dsv2_texts(91)
    model.encode(texts)  # captures the keys
    paths = {}
    for path, batch in (("packed", texts), ("query", texts[-1:])):
        reset_counts()
        with LaunchShapes() as shapes:
            vectors = model.encode(batch)
            torch.cuda.synchronize()
        check(np_finite(vectors), f"dsv2_attention: non-finite {path} "
              f"vectors")
        counts = read_counts()
        launched = [row for row in shapes.listed()
                    if row["counter"].endswith("_causal")]
        paths[path] = {"launches": {name: n for name, n in counts.items()
                                    if n}, "shapes": launched}
    packed = paths["packed"]["launches"]
    check(packed.get("masked_attention_segment_causal", 0) > 0 and
          not packed.get("masked_attention_padding_causal"),
          f"dsv2_attention: the packed path launched {packed}")
    query = paths["query"]["launches"]
    check(query.get("masked_attention_padding_causal", 0) > 0,
          f"dsv2_attention: the query path launched {query}")
    results = []
    for path in ("packed", "query"):
        for row in paths[path]["shapes"]:
            modes = ("segment", "padding") if path == "packed" else \
                ("padding",)
            for mode in modes:
                results += dsv2_causal_checks(fa, torch, row["shape"], mode)
    errors = {mode: max(r["max_abs_err"] for r in results
                        if r["mode"] == mode)
              for mode in ("padding", "segment")}
    kernels = []
    for mode, path in (("segment", "packed"), ("padding", "query")):
        top = max(paths[path]["shapes"], key=lambda row: row["launches"])
        row = dsv2_causal_timing(fa, torch, top["shape"], mode)
        name = f"masked_attention_{mode}_causal"
        kernels.append({
            "name": name, "route": "cuda", "source": B1_SOURCE,
            "replaces": B1_REPLACES, "launches": paths[path]["launches"][name],
            "max_abs_err": errors[mode], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "loop": row["loop"], "shape": row["shape"]})
    emit("dsv2_attention", ok=True, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, scale=DSV2_SCALE, atol=ATOL, rtol=RTOL,
         paths=paths, checks=len(results), results=results, kernels=kernels)
    return {"kernels": kernels}


# --- the multi-device mesh (parallel/) on the one card -----------------------

class LaunchShapes:
    """Counts, by (counter name, shape), the launches the kernel wrappers
    put on the card while the block runs, eagerly or replayed in a CUDA
    graph: ops/launches.py ``add``, which adds every such launch to the
    counts, is wrapped for the block's duration. Attention records
    (B, N, S, D), B3 (M, K, N)."""

    def __enter__(self):
        from collections import Counter

        from marqo_tpu_torch.ops import launches
        self.shapes = Counter()
        self._add = add = launches.add

        def counted(added):
            added = tuple(added)
            add(added)
            for launch in added:
                self.shapes[(launch.name, launch.shape)] += 1

        launches.add = counted
        return self

    def __exit__(self, *_):
        from marqo_tpu_torch.ops import launches
        launches.add = self._add

    def listed(self) -> list:
        return [{"counter": name, "shape": list(shape), "launches": n}
                for (name, shape), n in sorted(self.shapes.items())]


MESH_ENV = ("MARQO_TPU_SERVING_MESH", "MARQO_TPU_MESH_SHAPE")


class ForcedMesh:
    """The serving mesh forced on at ``shape`` for the block: one card
    repeated dp x tp times, a virtual mesh (parallel/serving.py). Models
    loaded inside join it; the process serves on one device again after
    it."""

    def __init__(self, shape):
        self.shape = shape

    def __enter__(self):
        from marqo_tpu_torch.parallel.serving import (reset_serving_mesh,
                                                      serving_mesh)
        self._saved = {name: os.environ.get(name) for name in MESH_ENV}
        os.environ["MARQO_TPU_SERVING_MESH"] = "TRUE"
        os.environ["MARQO_TPU_MESH_SHAPE"] = ",".join(map(str, self.shape))
        reset_serving_mesh()
        mesh = serving_mesh()
        card = _card()
        check(mesh is not None and mesh.shape == {"dp": self.shape[0],
                                                  "tp": self.shape[1]} and
              set(mesh.devices.flat) == {card},
              f"forced mesh {self.shape}: {mesh}")
        return mesh

    def __exit__(self, *_):
        from marqo_tpu_torch.parallel.serving import reset_serving_mesh
        for name, value in self._saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        reset_serving_mesh()


def _card():
    import torch
    return torch.device(DEVICE, 0) if DEVICE == "cuda" else \
        torch.device(DEVICE)


def _words(n_words: int, seed: int) -> str:
    import numpy as np
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
             "golf", "hotel", "india", "juliet", "kilo", "lima", "mike"]
    rng = np.random.default_rng(seed)
    return " ".join(words[i] for i in rng.integers(0, len(words), n_words))


def _row_cosines(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


def _mesh_text_batches(model):
    """MESH_BATCH texts that fill the 128-token bucket (the padded path)
    and MESH_BATCH ragged ones, one of 128 tokens and the rest of 1 to 12
    words, which fill a quarter of it (the packed path)."""
    padded = [_words(200, seed=100 + i) for i in range(MESH_BATCH)]
    lengths = model.tokenizer.encode_batch(padded)["lengths"]
    check(min(lengths) == 128, f"mesh padded texts: lengths {lengths}")
    ragged = [_words(200, seed=200)] + [_words(1 + i % 12, seed=200 + i)
                                        for i in range(1, MESH_BATCH)]
    return padded, ragged


def phase_mesh_off(torch):
    """Without MARQO_TPU_SERVING_MESH, one card gives no serving mesh (the
    JAX package's rule: fewer than 2 devices), so every phase above served
    on one device."""
    from marqo_tpu_torch.parallel.serving import (reset_serving_mesh,
                                                  serving_mesh)
    check(all(os.environ.get(name) is None for name in MESH_ENV),
          "a mesh variable is set")
    reset_serving_mesh()
    mesh = serving_mesh()
    check(mesh is None, f"one card, no variable, yet a mesh: {mesh}")
    emit("mesh_off", ok=True, device_count=torch.cuda.device_count(),
         serving_mesh=None)


def phase_mesh_serve(server, fa, torch, smi):
    """The e5-base-width index served over a (2, 2) virtual mesh: the
    encoder's heads and FFN split over tp 2 (6 heads a shard), batches over
    dp 2. HTTP adds (padded and packed) and searches; then one padded and
    one packed batch through the loaded model: exactly 12 x 2 x 2 B1
    launches a batch, each at (B/2, 6, S, 64), and every vector against
    the same model (same name, same weights) on one device; B1 against its
    twin at the shard shape; the time per batch against the unsharded
    model, for information."""
    from marqo_tpu_torch.inference.loaders import (TorchHFTextModel,
                                                   load_model)
    from marqo_tpu_torch.parallel.encode import ShardedTextEncoder
    from marqo_tpu_torch.parallel.serving import model_mesh
    H, N = E5_BASE["hidden_size"], E5_BASE["num_heads"]
    dp, tp = MESH_SHAPE
    name = "smoke-e5-base-v2-mesh"
    props = {"name": name, "type": "hf", "random_init": True,
             "pooling_method": "mean", "tokens": 128, "dimensions": H,
             "architecture": E5_BASE}
    single = load_model(name, props, _device())
    check(model_mesh(single) is None, "the reference model is on a mesh")
    padded, ragged = _mesh_text_batches(single)
    reference = {"padded": single.encode(padded),
                 "packed": single.encode(ragged)}
    with ForcedMesh(MESH_SHAPE) as mesh:
        run = serve_text_index(server, torch, "smoke-mesh", props, MESH_DOCS,
                               H)
        check(run["launches"]["masked_attention_padding"] > 0 and
              run["launches"]["masked_attention_segment"] > 0,
              f"mesh serve did not run both B1 modes: {run['launches']}")
        model = _loaded_model(TorchHFTextModel, name)
        check(model_mesh(model) is mesh and
              isinstance(model.encoder, ShardedTextEncoder) and
              len(model.encoder.shards) == tp and
              [r is model.encoder for r in model._replicas] == [True] * dp,
              "the served model is not split over the mesh")
        batches = {}
        for kind, texts in (("padded", padded), ("packed", ragged)):
            reset_counts()
            with LaunchShapes() as shapes:
                out = model.encode(texts)
            batches[kind] = {"launches": read_counts(),
                             "shapes": shapes.listed(),
                             "min_cosine": float(_row_cosines(
                                 out, reference[kind]).min())}
            counter = ("masked_attention_padding" if kind == "padded" else
                       "masked_attention_segment")
            launched = shapes.listed()
            check(len(launched) == 1 and launched[0]["counter"] == counter
                  and launched[0]["launches"] ==
                  E5_BASE["num_layers"] * dp * tp and
                  launched[0]["shape"][1] == N // tp and
                  launched[0]["shape"][3] == H // N,
                  f"mesh {kind} batch launches: {launched}")
            check(batches[kind]["min_cosine"] >= 0.999,
                  f"mesh {kind} vectors against one device: "
                  f"{batches[kind]['min_cosine']}")
        check(batches["padded"]["shapes"][0]["shape"] == list(MESH_B1_SHAPE),
              f"mesh padded shard shape {batches['padded']['shapes']}")

        def per_batch_ms(target):
            target.encode(padded)
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(5):
                target.encode(padded)
            return (time.perf_counter() - start) * 200

        times = {"single_ms": [], "mesh_ms": []}
        for target, key in ((single, "single_ms"), (model, "mesh_ms"),
                            (model, "mesh_ms"), (single, "single_ms")):
            times[key].append(per_batch_ms(target))
    results, errors = b1_checks(fa, torch, sorted(
        {tuple(batches[kind]["shapes"][0]["shape"]) for kind in batches}))
    emit("mesh_serve", ok=True, mesh=MESH_SHAPE, docs=run["docs"],
         documents_in_index=run["documents_in_index"],
         searches=len(run["latencies"]), launches=run["launches"],
         launches_during_add=run["add_launches"], batches=batches,
         b1_shard_checks=len(results), b1_shard_max_abs_err=errors,
         padded_batch=[MESH_BATCH, 128], per_batch_ms=times,
         nvidia_smi=smi, note="times: information only")
    return {"launches": run["launches"], "batches": batches}


def phase_mesh_replicated(fa, fused, qm, torch):
    """ViT-L/14 images and the int8 e5 encoder over a (2, 1) virtual mesh:
    both replicate whole (by type), each batch splits over dp 2. B2 runs
    24 times per group per 16-image call at (8, 16, 257, 64); B3 runs 4
    times a block per group at M = (B/2) S. Each against the same model on
    one device; then each kernel against its twin at every shape the mesh
    gave it (B2 and the int8 encoder's B1 within the attention bound, B3
    bit for bit), in fp32 and bf16."""
    from marqo_tpu_torch.inference.loaders import load_model
    from marqo_tpu_torch.inference.types import Modality
    from marqo_tpu_torch.parallel.serving import model_mesh
    dp = MESH_REPLICATED[0]
    layers = VIT_L14_VISION["num_layers"]
    clip_props = vit_l14_props()
    int8_props = {"name": "smoke-e5-base-v2-int8", "type": "hf",
                  "random_init": True, "pooling_method": "mean",
                  "tokens": 128, "dimensions": E5_BASE["hidden_size"],
                  "architecture": E5_BASE, "quantize": True}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        images = write_images(tmp, MESH_IMAGES, seed=31)
        singles = {"clip": load_model(clip_props["name"], clip_props,
                                      _device()),
                   "int8": load_model(int8_props["name"], int8_props,
                                      _device())}
        padded, _ = _mesh_text_batches(singles["int8"])
        inputs = {"clip": (images, Modality.IMAGE),
                  "int8": (padded, Modality.TEXT)}
        reference = {kind: singles[kind].encode(contents, modality=modality)
                     for kind, (contents, modality) in inputs.items()}
        with ForcedMesh(MESH_REPLICATED) as mesh:
            for kind, props in (("clip", clip_props), ("int8", int8_props)):
                model = load_model(props["name"], props, _device())
                check(model_mesh(model) is mesh and
                      [r is model.encoder for r in model._replicas] ==
                      [True] * dp, f"mesh {kind}: not replicated over dp")
                contents, modality = inputs[kind]
                reset_counts()
                with LaunchShapes() as shapes:
                    vectors = model.encode(contents, modality=modality)
                out[kind] = {"launches": read_counts(),
                             "shapes": shapes.listed(),
                             "min_cosine": float(_row_cosines(
                                 vectors, reference[kind]).min())}
                check(out[kind]["min_cosine"] >= 0.999,
                      f"mesh {kind} vectors against one device: "
                      f"{out[kind]['min_cosine']}")
                del model
    clip = {(s["counter"], tuple(s["shape"])): s["launches"]
            for s in out["clip"]["shapes"]}
    check(clip == {("fused_attention_nomask", MESH_B2_SHAPE): layers * dp},
          f"mesh ViT-L/14: B2 launches {out['clip']['shapes']}")
    M = MESH_BATCH // dp * 128
    H, I = E5_BASE["hidden_size"], E5_BASE["intermediate_size"]
    int8 = {(s["counter"], tuple(s["shape"])): s["launches"]
            for s in out["int8"]["shapes"]}
    per_shape = E5_BASE["num_layers"] * dp
    check(int8 == {("w8a8_matmul", (M, H, 3 * H)): per_shape,
                   ("w8a8_matmul", (M, H, H)): per_shape,
                   ("w8a8_matmul", (M, H, I)): per_shape,
                   ("w8a8_matmul", (M, I, H)): per_shape,
                   ("masked_attention_padding",
                    (MESH_BATCH // dp, E5_BASE["num_heads"], 128,
                     H // E5_BASE["num_heads"])): per_shape},
          f"mesh int8: launches {out['int8']['shapes']}")
    shard_checks = {}
    _, shard_checks["b1_max_abs_err"] = b1_checks(fa, torch, [
        shape for counter, shape in int8
        if counter == "masked_attention_padding"])
    _, shard_checks["b2_max_abs_err"] = b2_checks(
        fused, torch, [(*MESH_B2_SHAPE, ("nomask",))])
    w8a8 = [w8a8_check(qm, torch, *shape, dtype)
            for dtype in (torch.float32, torch.bfloat16)
            for counter, shape in int8 if counter == "w8a8_matmul"]
    shard_checks["b3_checks"] = len(w8a8)
    shard_checks["b3_max_abs_err"] = max(r["max_abs_err"] for r in w8a8)
    emit("mesh_replicated", ok=True, mesh=MESH_REPLICATED,
         images=MESH_IMAGES, texts=MESH_BATCH, atol=ATOL, rtol=RTOL,
         b3_tolerance="exact (torch.equal)", shard_checks=shard_checks, **out)
    return out


def phase_train_step(torch):
    """The contrastive train step (parallel/train_step.py) at e5-base width
    over the (2, 2) virtual mesh: bf16 compute, TRAIN_STEPS steps on one
    fixed batch of TRAIN_PAIRS query/passage pairs at TRAIN_TOKENS tokens;
    the loss finite and falling. In fp32, step 1's loss on the (2, 2) mesh
    within 1e-4 relative of a (1, 1) mesh's. Time per step and peak
    memory (the process's, and its rise over what was held before the
    step), for information."""
    import numpy as np

    from marqo_tpu_torch.models.bert import TextEncoderConfig, init_encoder
    from marqo_tpu_torch.parallel.mesh import create_mesh
    from marqo_tpu_torch.parallel.train_step import (make_train_state,
                                                     make_train_step)
    config = TextEncoderConfig(**E5_BASE)
    encoder = init_encoder(config, torch.Generator(device=DEVICE)
                           .manual_seed(5), device=DEVICE)
    rng = np.random.default_rng(7)
    B, S = TRAIN_PAIRS, TRAIN_TOKENS
    batch = {}
    for side in ("query", "passage"):
        lengths = rng.integers(S // 4, S + 1, B)
        mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
        batch[f"{side}_ids"] = (rng.integers(5, config.vocab_size, (B, S))
                                * mask).astype(np.int32)
        batch[f"{side}_mask"] = mask
    card = _card()

    def mesh(shape):
        return create_mesh([card] * (shape[0] * shape[1]), shape)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what the models of earlier phases hold; the step's own peak is the
    # rise above it
    held = torch.cuda.memory_allocated()
    master, optimizer = make_train_state(encoder, mesh(MESH_SHAPE),
                                         TRAIN_LR)
    step = make_train_step(config, mesh(MESH_SHAPE), optimizer,
                           compute_dtype=torch.bfloat16)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        start = time.perf_counter()
        losses.append(float(step(master, batch)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1000)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train step losses {losses}")
    del master, optimizer, step
    fp32 = {}
    for shape in (MESH_SHAPE, (1, 1)):
        master, optimizer = make_train_state(encoder, mesh(shape), TRAIN_LR)
        fp32[f"{shape[0]}x{shape[1]}"] = float(make_train_step(
            config, mesh(shape), optimizer, compute_dtype=torch.float32)(
            master, batch))
        del master, optimizer
    a, b = fp32["2x2"], fp32["1x1"]
    check(abs(a - b) <= 1e-4 * abs(b),
          f"fp32 step 1: (2, 2) mesh {a}, (1, 1) mesh {b}")
    emit("train_step", ok=True, mesh=MESH_SHAPE, batch=[B, S],
         steps=TRAIN_STEPS, learning_rate=TRAIN_LR, bf16_losses=losses,
         step_ms=step_ms, median_step_ms=statistics.median(step_ms[1:]),
         max_memory_allocated=peak, memory_allocated_before=held,
         train_peak_bytes=peak - held, fp32_step1_loss=fp32,
         note="times and memory: information only")


def phase_mesh_timing(fa, fused, qm, torch, mesh_serve, mesh_replicated):
    """The kernels at the mesh's shard shapes, queued (``queued_ms``), each
    with its bound, its twin and its library call, and its launches on the
    mesh phases: B1 at (16, 6, 128, 64) both modes, B2 no-mask at
    (8, 16, 257, 64), B3 at the int8 encoder's four linear shapes with M
    halved."""
    rows = []

    def launches_of(run, counter, shape):
        return sum(s["launches"] for s in run["shapes"]
                   if s["counter"] == counter and s["shape"] == list(shape))

    # B1 at the shard shape of the mesh phase's padded batch (padding mode)
    # and of its packed batch (segment mode)
    for kind, mode in (("padded", "padding"), ("packed", "segment")):
        shape = mesh_serve["batches"][kind]["shapes"][0]["shape"]
        B, N, S, D = shape
        q, k, v, pad, seg = attention_inputs(B, N, S, D, torch.bfloat16,
                                             seed=B)
        q, k, v = projection_views(q, k, v, "projection")
        if mode == "padding":
            mask, kernel, plain = (pad, fa.attention_padding,
                                   fa.attention_padding_reference)
            allowed = (pad > 0)[:, None, None, :]
        else:
            mask, kernel, plain = (seg, fa.attention_segment,
                                   fa.attention_segment_reference)
            allowed = ((seg[:, :, None] == seg[:, None, :]) &
                       (seg[:, None, :] > 0))[:, None]
        rows.append({
            "kernel": "masked_attention", "mode": mode, "shape": shape,
            "layout": "projection",
            **attention_bound(B, N, S, D, mode, mask),
            **paired_queued_ms(lambda: kernel(q, k, v, mask),
                               lambda: plain(q, k, v, mask),
                               _sdpa(torch, q, k, v, allowed), 20),
            **loop_times(lambda loop: fa._launch(q, k, v, mask, mode,
                                                 loop=loop), S, D,
                         queued_ms, 20),
            "launches": {"mesh_serve " + kind: launches_of(
                mesh_serve["batches"][kind], f"masked_attention_{mode}",
                shape)}})
    B, N, S, D = MESH_B2_SHAPE
    q, k, v, _, _ = attention_inputs(B, N, S, D, torch.bfloat16, seed=S)
    q, k, v = projection_views(q, k, v, "projection")
    rows.append({
        "kernel": "fused_attention", "mode": "nomask",
        "shape": list(MESH_B2_SHAPE), "layout": "projection",
        **attention_bound(B, N, S, D, "fused_nomask"),
        **paired_queued_ms(lambda: fused.fused_attention(q, k, v),
                           lambda: fused.fused_attention_reference(q, k, v),
                           _sdpa(torch, q, k, v, None), 20),
        **loop_times(lambda loop: fused._launch(q, k, v, None, loop=loop),
                     S, D, queued_ms, 20),
        "launches": {"mesh_replicated": launches_of(
            mesh_replicated["clip"], "fused_attention_nomask",
            MESH_B2_SHAPE)}})
    for s in mesh_replicated["int8"]["shapes"]:
        if s["counter"] != "w8a8_matmul":
            continue
        M, K, N = s["shape"]
        x, w_q, w_scale, bias = w8a8_inputs(M, K, N, torch.bfloat16, seed=N)
        rows.append({
            "kernel": "w8a8_matmul", "mode": "w8a8", "shape": [M, K, N],
            **w8a8_bound(M, K, N),
            **paired_queued_ms(
                lambda: qm.w8a8_matmul(x, w_q, w_scale, bias),
                lambda: qm.w8a8_matmul_reference(x, w_q, w_scale, bias),
                _int8_yardstick(torch, qm, x, w_q, w_scale, bias), 20),
            "launches": {"mesh_replicated": s["launches"]}})
    return with_sdpa_ratio(rows)


def phase_w8a8_path(qm, torch, by_layer, smi) -> dict:
    """B3 at every (M, K, N) the int8 serve path launched it (``by_layer``,
    int8_serve's counts), on bf16 inputs as the path gives it: first held
    against its twin, equal bit for bit, with the control (the twin at
    0.9 x w_scale) required to differ; then queued, its ms and the twin's
    (plain, kernel, kernel, plain) beside its bound, the library yardstick
    and the bf16 F.linear it replaces, and each column's sum weighted by
    the path's launches. Returns the largest absolute error and the row of
    the path's largest launch-weighted bound (the kernels line's B3 row)."""
    import torch.nn.functional as F
    rows = []
    for layer, entry in by_layer.items():
        K, N = map(int, layer.split("x"))
        for M, n in sorted((int(m), n) for m, n in entry["M"].items()):
            x, w_q, w_scale, bias = w8a8_inputs(M, K, N, torch.bfloat16,
                                                seed=M)
            out = qm.w8a8_matmul(x, w_q, w_scale, bias)
            torch.cuda.synchronize()
            ref = qm.w8a8_matmul_reference(x, w_q, w_scale, bias)
            control = qm.w8a8_matmul_reference(x, w_q, 0.9 * w_scale, bias)
            abs_err = float((out.float() - ref.float()).abs().max())
            check(out.dtype == torch.bfloat16 and
                  tuple(out.shape) == (M, N) and
                  bool(torch.isfinite(out).all()),
                  f"w8a8 path output {out.dtype} {tuple(out.shape)}")
            check(torch.equal(out, ref),
                  f"w8a8 kernel vs twin on the path ({M}, {K}, {N}): "
                  f"{int((out != ref).sum())} values differ, max |out - ref| "
                  f"{abs_err}")
            check(not torch.equal(out, control),
                  f"w8a8 path ({M}, {K}, {N}): the control equals the kernel")
            weight = (0.05 * torch.randn(N, K, device=DEVICE)).to(
                torch.bfloat16)
            bias16 = bias.to(torch.bfloat16)
            rows.append({"shape": [M, K, N], "launches": n,
                         "max_abs_err": abs_err, **w8a8_bound(M, K, N),
                         **paired_queued_ms(
                             lambda: qm.w8a8_matmul(x, w_q, w_scale, bias),
                             lambda: qm.w8a8_matmul_reference(
                                 x, w_q, w_scale, bias),
                             _int8_yardstick(torch, qm, x, w_q, w_scale,
                                             bias), 20),
                         "bf16_linear_ms": queued_ms(
                             lambda: F.linear(x, weight, bias16), 20)})
    emit("w8a8_path", ok=True, tolerance="exact (torch.equal)",
         checks=len(rows), device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, rows=rows, launch_weighted_ms={
             key: sum(row["launches"] * row[key] for row in rows)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                         "bf16_linear_ms")})
    return {"max_abs_err": max(row["max_abs_err"] for row in rows),
            "row": max(rows, key=lambda row: row["launches"] *
                       row["bound_ms"])}


# --- the launch path: scripts/run_marqo_tpu_torch.sh in fresh processes -----

LAUNCH_SCRIPT = os.path.join("scripts", "run_marqo_tpu_torch.sh")
LAUNCH_DOCS = 256          # run A: four adds of 64, the serve phase's docs
LAUNCH_WORKER_DOCS = 64    # run B: one add
LAUNCH_TEXTS = 16          # embedded one a request, then in one request
LAUNCH_SEARCHES = 8        # of each of TENSOR and HYBRID, limit 5
LAUNCH_WORKERS = 2
LAUNCH_STARTUP_S = 600.0   # to the first healthy answer, warmup included
LAUNCH_STOP_S = 30.0       # from SIGTERM to every process gone, ports free
LAUNCH_MEMORY_SLACK = 256 * 2 ** 20  # device bytes a stopped run may leave


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_is_free(port: int) -> bool:
    """Nothing listens on ``port``: a socket without SO_REUSEPORT binds it
    (SO_REUSEADDR lets it past connections left in TIME_WAIT)."""
    import socket
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def http_json(port: int, method: str, path: str, body=None,
              timeout: float = 600.0, connection=None):
    """One request to 127.0.0.1:``port``, on ``connection`` (kept alive)
    when given, else on a connection of its own. Returns (status, body)."""
    import http.client
    conn = connection or http.client.HTTPConnection("127.0.0.1", port,
                                                    timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        response = conn.getresponse()
        return response.status, json.loads(response.read() or b"null")
    finally:
        if connection is None:
            conn.close()


def group_pids(pgid: int) -> list:
    """The live processes (zombies left out) of process group ``pgid``."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        state, _, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        if int(pgrp) == pgid and state != "Z":
            pids.append(int(entry))
    return sorted(pids)


def socket_owner(server_port: int, client_port: int, pids):
    """The process of ``pids`` that holds the server's end of the TCP
    connection from ``client_port`` to ``server_port``: the socket's inode
    in /proc/net/tcp, found in the process's file table. None if no
    process of ``pids`` holds it."""
    inode = None
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            fields = row.split()
            if (int(fields[1].rsplit(":", 1)[1], 16) == server_port and
                    int(fields[2].rsplit(":", 1)[1], 16) == client_port):
                inode = fields[9]
    if inode in (None, "0"):
        return None
    target = f"socket:[{inode}]"
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                if os.readlink(f"/proc/{pid}/fd/{fd}") == target:
                    return pid
            except OSError:
                continue
    return None


def served_by(port: int, pids):
    """A new kept-alive connection to ``port`` and the process of ``pids``
    that accepted it (known once it has answered a request)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    status, _ = http_json(port, "GET", "/health", connection=conn)
    check(status == 200, f"/health on :{port} answered {status}")
    return conn, socket_owner(port, conn.sock.getsockname()[1], pids)


def launch_env(workdir: str, **variables) -> dict:
    """The environment a user's shell gives the launch script: this
    process's without any MARQO_ variable (the smoke sets its own), the
    checkout on PYTHONPATH (as Dockerfile:37 sets it), and ``python`` on
    PATH as this interpreter (the script calls ``python``; a host may have
    only ``python3``), then ``variables``."""
    bindir = os.path.join(workdir, "bin")
    python = os.path.join(bindir, "python")
    if not os.path.exists(python):
        os.makedirs(bindir, exist_ok=True)
        with open(python, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(python, 0o755)
    env = {name: value for name, value in os.environ.items()
           if not name.startswith("MARQO_")}
    env["PATH"] = bindir + os.pathsep + env.get("PATH", "")
    env["PYTHONPATH"] = ROOT
    env.update({name: str(value) for name, value in variables.items()})
    return env


class Launched:
    """One start of a launch script (scripts/run_marqo_tpu_torch.sh unless
    ``script`` names another) as a user's shell starts it: in a session of
    its own (its process group is its pid; the script execs python, so
    that is the server's pid too), from ``workdir``, its output in
    ``workdir``/``name``.log."""

    def __init__(self, name: str, args, env: dict, workdir: str,
                 script: str = LAUNCH_SCRIPT):
        self.name = name
        self.log_path = os.path.join(workdir, f"{name}.log")
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(
                [os.path.join(ROOT, script), *args], env=env,
                cwd=workdir, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
        self.started = time.perf_counter()

    def log(self) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def wait_ready(self, port: int, path: str,
                   deadline_s: float = LAUNCH_STARTUP_S) -> float:
        """Seconds from the start to the first 200 from ``path``."""
        while True:
            if self.proc.poll() is not None:
                raise SmokeFailure(
                    f"{self.name} exited ({self.proc.returncode}) before "
                    f"{path} answered: {self.log()[-3000:]}")
            try:
                if http_json(port, "GET", path, timeout=5)[0] == 200:
                    return time.perf_counter() - self.started
            except OSError:
                pass
            if time.perf_counter() - self.started > deadline_s:
                raise SmokeFailure(f"{self.name}: {path} did not answer "
                                   f"within {deadline_s} s")
            time.sleep(0.2)

    def pids(self) -> list:
        return group_pids(self.proc.pid)

    def stop(self, ports, timeout_s: float = LAUNCH_STOP_S) -> dict:
        """SIGTERM to the process group: every process of it must be gone,
        and every one of ``ports`` free, within ``timeout_s``."""
        import signal
        pids = self.pids()
        start = time.perf_counter()
        try:
            os.killpg(self.proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        while time.perf_counter() - start < timeout_s:
            self.proc.poll()
            if not self.pids() and all(map(port_is_free, ports)):
                break
            time.sleep(0.1)
        seconds = time.perf_counter() - start
        left, bound_ports = self.pids(), [p for p in ports
                                          if not port_is_free(p)]
        self.kill()
        check(not left and not bound_ports,
              f"{self.name}: {timeout_s} s after SIGTERM, processes {left} "
              f"alive and ports {bound_ports} bound")
        return {"pids": pids, "stop_seconds": seconds,
                "returncode": self.proc.returncode}

    def kill(self) -> None:
        """SIGKILL to whatever is left of the group, then reap the script."""
        import signal
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def gpu_compute_apps() -> list:
    """[pid, used memory] rows of the card's compute processes, as
    ``nvidia-smi --query-compute-apps=pid,used_memory --format=csv`` lists
    them (pids as the card's driver sees them: inside a container they
    need not be this host's)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[1:]
    return [[int(pid), used.strip()] for pid, used in
            (row.split(",") for row in out)]


def loads_torch(pid: int) -> bool:
    """Whether process ``pid`` has PyTorch's libraries mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def device_used_bytes() -> int:
    """Bytes in use on the card, by every process (the driver's count)."""
    import torch
    free, total = torch.cuda.mem_get_info(0)
    return total - free


def gib(field: str) -> float:
    """``"<x> GiB"`` (/device/cuda's memory fields) as a number."""
    return float(field.split()[0])


def _embeddings(port: int, index: str, texts) -> tuple:
    """``texts`` embedded one a request, then all in one request."""
    import numpy as np
    one = []
    for t in texts:
        status, body = http_json(port, "POST", f"/indexes/{index}/embed",
                                 {"content": [t]})
        check(status == 200, f"embed on :{port}: {status} {body}")
        one.append(body["embeddings"][0])
    status, body = http_json(port, "POST", f"/indexes/{index}/embed",
                             {"content": list(texts)})
    check(status == 200, f"embed on :{port}: {status} {body}")
    return (np.asarray(one, dtype=np.float32),
            np.asarray(body["embeddings"], dtype=np.float32))


def warmup_buckets(log: str, model: str) -> list:
    """The warmed bucket counts the server logged for ``model``, one per
    process that warmed it; fails unless each also logged Pre-warmed."""
    import re
    warmed = [int(n) for n in re.findall(
        rf"Warmed (\d+) compile buckets for {re.escape(model)}\b", log)]
    prewarmed = len(re.findall(rf"Pre-warmed model {re.escape(model)}\b",
                               log))
    check(warmed and prewarmed == len(warmed),
          f"{model} was not warmed at startup: {log[-3000:]}")
    return warmed


def launch_no_cuda(workdir: str) -> dict:
    """The script with CUDA hidden and MARQO_BEST_AVAILABLE_DEVICE unset:
    startup must fail, and the port must never answer."""
    port = free_port()
    env = launch_env(workdir, MARQO_HOST="127.0.0.1", MARQO_PORT=port,
                     MARQO_MODELS_TO_PRELOAD="[]", CUDA_VISIBLE_DEVICES="")
    run = Launched("no-cuda", [], env, workdir)
    try:
        answered = False
        while run.proc.poll() is None and \
                time.perf_counter() - run.started < LAUNCH_STARTUP_S:
            try:
                answered |= http_json(port, "GET", "/health",
                                      timeout=5)[0] == 200
            except OSError:
                pass
            time.sleep(0.2)
        log = run.log()
        check(run.proc.returncode not in (None, 0) and not answered and
              "MARQO_BEST_AVAILABLE_DEVICE=cpu" in log,
              f"no-CUDA start: exit {run.proc.returncode}, answered "
              f"{answered}: {log[-3000:]}")
        return {"returncode": run.proc.returncode,
                "seconds": time.perf_counter() - run.started,
                "served": answered}
    finally:
        run.kill()


def cuda_info(port: int, connection=None) -> dict:
    """GET /device/cuda from the server that ``connection`` (or a new
    connection) reaches: one device, this card by name, with memory in use.
    Returns the device's entry."""
    import torch
    status, body = http_json(port, "GET", "/device/cuda",
                             connection=connection)
    devices = body.get("cuda_devices", []) if status == 200 else []
    check(len(devices) == 1 and
          devices[0]["device_name"] == torch.cuda.get_device_name(0) and
          gib(devices[0]["memory_used"]) > 0,
          f"/device/cuda on :{port}: {status} {body}")
    return devices[0]


def phase_launch(server, torch, smi):
    """The port started as users start it: scripts/run_marqo_tpu_torch.sh
    in fresh processes, which keep PyTorch's backend defaults (this process
    turned TF32 off for itself). First with CUDA hidden: startup fails.
    Run A, the Dockerfile's default mode: one API process with the
    in-process engine, the serve phase's model preloaded and warmed, an
    index on it, LAUNCH_DOCS documents, TENSOR and HYBRID searches and
    LAUNCH_TEXTS embedded; the vectors against the in-process server's
    (``server``, whose B1 launches are counted), bit for bit one text a
    request, and against its twin, which must differ. Run B: the script's
    engine role on MARQO_ENGINE_PORT and LAUNCH_WORKERS API workers over
    it, sharing settings through a data dir and the file coordination
    backend; every search right until both workers have answered. Each
    run ends with SIGTERM to its process group: every process gone and
    its port free within LAUNCH_STOP_S, none left on the card."""
    from dataclasses import replace

    import numpy as np

    from marqo_tpu_torch.core.index_management.settings_store import \
        IndexSettingsStore
    from marqo_tpu_torch.inference.loaders import TorchHFTextModel
    props = e5_props()
    name = props["name"]
    preload = json.dumps([{"model": name, "modelProperties": props}])
    fields = {"tensorFields": ["title", "body"]}
    docs, text = text_docs(torch, LAUNCH_DOCS)
    texts = [text(3 + i % 8) for i in range(LAUNCH_TEXTS)]
    # the in-process server's vectors: on B1, then on the twin
    reset_counts()
    kernel_one, kernel_batch = _embeddings(server.port, "smoke", texts)
    kernel_launches = read_counts()
    check(kernel_launches["masked_attention_padding"] +
          kernel_launches["masked_attention_segment"] > 0,
          f"in-process embeds did not run B1: {kernel_launches}")
    model = next(m for m in _loaded_models(TorchHFTextModel)
                 if m.model_name == name)
    config = model.encoder.config
    model.encoder.config = replace(config, attention_impl="plain")
    try:
        reset_counts()
        twin_one, _ = _embeddings(server.port, "smoke", texts)
        twin_launches = read_counts()
    finally:
        model.encoder.config = config
    check(not any(twin_launches.values()),
          f"the twin launched kernels: {twin_launches}")

    used_before, apps_before = device_used_bytes(), gpu_compute_apps()
    runs = []
    tmp = tempfile.TemporaryDirectory()
    try:
        workdir = tmp.name
        no_cuda = launch_no_cuda(workdir)

        # run A: one process, the in-process engine
        port = free_port()
        run_a = Launched("run-a", [], launch_env(
            workdir, MARQO_HOST="127.0.0.1", MARQO_PORT=port,
            MARQO_MODELS_TO_PRELOAD=preload), workdir)
        runs.append(run_a)
        startup_a = run_a.wait_ready(port, "/health")
        buckets_a = warmup_buckets(run_a.log(), name)
        device_a = cuda_info(port)
        status, body = http_json(port, "POST", "/indexes/launch",
                                 {"model": name, "modelProperties": props})
        check(status == 200, f"run A create index: {status} {body}")
        add_seconds = []
        for b in range(0, LAUNCH_DOCS, 64):
            start = time.perf_counter()
            status, res = http_json(port, "POST", "/indexes/launch/documents",
                                    {"documents": docs[b:b + 64], **fields})
            add_seconds.append(time.perf_counter() - start)
            check(status == 200 and res["errors"] is False,
                  f"run A add: {status} {res}")
        latencies = []
        for i in range(LAUNCH_SEARCHES):
            for method in ("TENSOR", "HYBRID"):
                start = time.perf_counter()
                status, res = http_json(port, "POST", "/indexes/launch/search",
                                        {"q": text(3 + i),
                                         "searchMethod": method, "limit": 5})
                latencies.append((time.perf_counter() - start) * 1000)
                check(status == 200 and len(res["hits"]) == 5,
                      f"run A {method} search: {status} {res}")
        launched_one, launched_batch = _embeddings(port, "launch", texts)
        status, stats = http_json(port, "GET", "/indexes/launch/stats")
        check(status == 200 and stats["numberOfDocuments"] == LAUNCH_DOCS,
              f"run A documents: {status} {stats}")
        used_a = device_used_bytes()
        apps_a = gpu_compute_apps()
        check(len(apps_a) == len(apps_before) + 1,
              f"run A: compute processes {apps_a}, {apps_before} before")
        stop_a = run_a.stop([port])

        # the launched encoder computed what the counted one did
        equal = [bool(np.array_equal(x, y))
                 for x, y in zip(launched_one, kernel_one)]
        cosine = float(min(_row_cosines(launched_one, kernel_one).min(),
                           _row_cosines(launched_batch, kernel_batch).min()))
        twin_equal = sum(bool(np.array_equal(x, y))
                         for x, y in zip(launched_one, twin_one))
        embeddings = {
            "texts": LAUNCH_TEXTS,
            "bit_equal_one_a_request": sum(equal),
            "max_abs_diff_one_a_request": float(
                np.abs(launched_one - kernel_one).max()),
            "bit_equal_in_one_request": bool(
                np.array_equal(launched_batch, kernel_batch)),
            "max_abs_diff_in_one_request": float(
                np.abs(launched_batch - kernel_batch).max()),
            "min_cosine": cosine,
            "twin_bit_equal_one_a_request": twin_equal,
            "twin_max_abs_diff": float(np.abs(launched_one - twin_one).max()),
            "in_process_launches": kernel_launches}
        check(all(equal), f"launched vectors differ from the in-process "
              f"server's at batch 1: {embeddings}")
        check(cosine >= 1 - 1e-3, f"launched vectors: {embeddings}")
        check(twin_equal < LAUNCH_TEXTS, f"the twin's vectors equal the "
              f"kernel's, so equality cannot show B1 ran: {embeddings}")

        # run B: the engine role, and API workers over it
        engine_port, api_port = free_port(), free_port()
        engine = Launched("engine", ["engine"], launch_env(
            workdir, MARQO_ENGINE_PORT=engine_port), workdir)
        runs.append(engine)
        engine_seconds = engine.wait_ready(engine_port, "/engine/health")
        run_b = Launched("run-b", [], launch_env(
            workdir, MARQO_HOST="127.0.0.1", MARQO_PORT=api_port,
            MARQO_ENGINE_QUERY_URL=f"http://127.0.0.1:{engine_port}",
            MARQO_API_WORKERS=LAUNCH_WORKERS,
            MARQO_COORDINATION_BACKEND="file",
            MARQO_COORDINATION_DIR=os.path.join(workdir, "coordination"),
            MARQO_ENGINE_DATA_DIR=os.path.join(workdir, "data"),
            MARQO_MODELS_TO_PRELOAD=preload), workdir)
        runs.append(run_b)
        startup_b = run_b.wait_ready(api_port, "/health")
        workers = run_b.pids()
        check(len(workers) == LAUNCH_WORKERS,
              f"run B: {workers} in the process group, expected "
              f"{LAUNCH_WORKERS} API workers")
        status, body = http_json(api_port, "POST", "/indexes/launch-workers",
                                 {"model": name, "modelProperties": props})
        check(status == 200, f"run B create index: {status} {body}")
        # the other worker reads new settings from disk this often
        time.sleep(IndexSettingsStore.RELOAD_INTERVAL_S + 0.5)
        start = time.perf_counter()
        status, res = http_json(
            api_port, "POST", "/indexes/launch-workers/documents",
            {"documents": docs[:LAUNCH_WORKER_DOCS], **fields})
        add_b = time.perf_counter() - start
        check(status == 200 and res["errors"] is False,
              f"run B add: {status} {res}")
        seen, search_ms = {}, []
        start = time.perf_counter()
        while len(seen) < LAUNCH_WORKERS:
            check(time.perf_counter() - start < LAUNCH_STARTUP_S,
                  f"run B: only {sorted(seen)} of {workers} answered in "
                  f"{len(search_ms)} searches")
            conn, pid = served_by(api_port, workers)
            try:
                started = time.perf_counter()
                status, res = http_json(
                    api_port, "POST", "/indexes/launch-workers/search",
                    {"q": text(4), "searchMethod": "TENSOR", "limit": 10},
                    connection=conn)
                search_ms.append((time.perf_counter() - started) * 1000)
                check(status == 200 and len(res["hits"]) == 10,
                      f"run B search on worker {pid}: {status} {res}")
                if pid is not None and pid not in seen:
                    status, stats = http_json(
                        api_port, "GET", "/indexes/launch-workers/stats",
                        connection=conn)
                    check(status == 200 and stats["numberOfDocuments"] ==
                          LAUNCH_WORKER_DOCS,
                          f"run B worker {pid} documents: {status} {stats}")
                    seen[pid] = {"memory_used": cuda_info(
                        api_port, conn)["memory_used"]}
            finally:
                conn.close()
            time.sleep(0.05)
        buckets_b = warmup_buckets(run_b.log(), name)
        check(len(buckets_b) == LAUNCH_WORKERS,
              f"run B: {len(buckets_b)} workers warmed {name}")
        used_b = device_used_bytes()
        apps_b = gpu_compute_apps()
        check(len(apps_b) == len(apps_before) + LAUNCH_WORKERS,
              f"run B: compute processes {apps_b}, {apps_before} before "
              f"(one a worker, none for the engine)")
        # the engine serves a small corpus on the host: it never loads
        # PyTorch (engine/torch_scorer.py checks the rows first)
        check(not loads_torch(engine.proc.pid),
              "run B: the engine process loaded PyTorch")
        stop_b = run_b.stop([api_port])
        stop_engine = engine.stop([engine_port])

        # nothing of the runs is left on the card: nvidia-smi's count of
        # compute processes and the card's memory (in a container it lists
        # every process as pid 1, so its pids cannot name ours)
        apps_after = gpu_compute_apps()
        check(len(apps_after) == len(apps_before),
              f"compute processes on the card: {apps_after} after the "
              f"runs, {apps_before} before")
        start = time.perf_counter()
        while device_used_bytes() > used_before + LAUNCH_MEMORY_SLACK and \
                time.perf_counter() - start < LAUNCH_STOP_S:
            time.sleep(0.2)
        used_after = device_used_bytes()
        check(used_after <= used_before + LAUNCH_MEMORY_SLACK,
              f"the card holds {(used_after - used_before) / 2 ** 20:.0f} "
              f"MiB more than before the runs")
    finally:
        for run in runs:
            run.kill()
        tmp.cleanup()
    mib = 2 ** 20
    emit("launch", ok=True, script=LAUNCH_SCRIPT,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         no_cuda=no_cuda,
         run_a={"startup_seconds": startup_a, "warmup_buckets": buckets_a,
                "device": device_a, "add_seconds": add_seconds,
                "docs": LAUNCH_DOCS,
                "first_query_ms": latencies[0],
                "query_median_ms": statistics.median(latencies),
                "searches": len(latencies), "embeddings": embeddings,
                "compute_apps": apps_a, **stop_a},
         run_b={"engine_startup_seconds": engine_seconds,
                "startup_seconds": startup_b, "warmup_buckets": buckets_b,
                "add_seconds": add_b, "docs": LAUNCH_WORKER_DOCS,
                "searches_until_both_workers": len(search_ms),
                "first_query_ms": search_ms[0],
                "query_median_ms": statistics.median(search_ms),
                "workers": {str(pid): info for pid, info in seen.items()},
                "card_mib_a_worker": (used_b - used_before) / mib /
                LAUNCH_WORKERS,
                "compute_apps": apps_b, **stop_b,
                "engine_stop_seconds": stop_engine["stop_seconds"]},
         compute_apps_before=apps_before, compute_apps_after=apps_after,
         device_used_mib={"before": used_before / mib, "run_a": used_a / mib,
                          "run_b": used_b / mib, "after": used_after / mib})



EXACT_ROWS = 1_000_000      # the engine's exact scan at a million rows
EXACT_SEED = 17
EXACT_LIMIT = 10            # the API's default limit
EXACT_K = 64                # engine/store.py asks max(limit * 4, 64)
EXACT_TOLERANCE = 2.0 ** -7  # of |score|: two bf16 ulps
EXACT_REPEATS = 5           # timed top_k calls a metric
EXACT_CONTROL_ROWS = 65_536  # the control's rows, scaled off unit norm
EXACT_SEARCHES = 16         # after the restart, one a request
EXACT_ADD_DOCS = 64         # then one add over the engine role ...
EXACT_AFTER_ADD = 4         # ... and these exact searches
EXACT_CROSSING_ROWS = 49_984  # 16 under MIN_ROWS_FOR_DEVICE
EXACT_CROSSING_ADD = 32     # one add; its 16th document crosses
EXACT_TIMEOUT_MS = 1000.0   # MARQO_SEARCH_TIMEOUT_MS's default
EXACT_READY_S = 120.0       # the crossing's bring-up, at most
BRING_UP_LINE = (r"(\S+ \S+) INFO \S+: Exact scan up on (\S+): (\d+) x "
                 r"(\d+) (\S+) rows in ([\d.]+) ms \(torch and CUDA init "
                 r"([\d.]+) ms, context ([\d.]+) ms, upload ([\d.]+) ms, "
                 r"first scan ([\d.]+) ms\)")


def unit_rows(torch, n: int, d: int, seed: int):
    """``n`` random unit fp32 rows of ``d``, drawn on the card from
    ``seed`` (in bulk), as a host array."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    rows = torch.randn(n, d, generator=g, device=DEVICE)
    rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    return rows.cpu().numpy()


def near_queries(rows, picks, seed: int):
    """One unit query per picked row, at cosine ~0.9 to it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((len(picks), rows.shape[1])).astype(
        np.float32)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    queries = rows[picks] + 0.5 * noise
    return queries / np.linalg.norm(queries, axis=1, keepdims=True)


def fp32_closeness(metric: str, dot, row_norms, query_norm):
    """The numpy exact path's closeness (engine/store.py ``closeness``) of
    every row, from one fp32 ``matrix @ q`` and the rows' norms."""
    import numpy as np
    if metric == "dotproduct":
        return dot
    if metric == "prenormalized-angular":
        return 1.0 / (1.0 + (1.0 - dot))
    if metric == "angular":
        cos = np.clip(dot / (np.maximum(row_norms, 1e-12) *
                             max(query_norm, 1e-12)), -1.0, 1.0)
        return 1.0 / (1.0 + np.arccos(cos))
    if metric == "euclidean":
        d2 = np.maximum(row_norms ** 2 - 2.0 * dot + query_norm ** 2, 0.0)
        return 1.0 / (1.0 + np.sqrt(d2))
    raise ValueError(metric)


def exact_hits_check(ids, scores, closeness) -> dict:
    """Top hits (row ids, scores, best first) against the fp32 closeness of
    every row (-inf where deleted): each score within EXACT_TOLERANCE of
    |score| of its row's, and every row of the fp32 top len(ids) that beats
    the last hit's score by more than that margin among the ids."""
    import numpy as np
    ids = np.asarray(ids, dtype=np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    k = len(ids)
    ref = closeness[ids].astype(np.float64)
    rel = np.abs(scores - ref) / np.maximum(np.abs(scores), 1e-30)
    top = np.argpartition(-closeness, k)[:k]
    beats = top[closeness[top] - scores[-1] >
                EXACT_TOLERANCE * np.abs(closeness[top])]
    missed = np.setdiff1d(beats, ids)
    return {"k": k, "max_rel_err": float(rel.max()),
            "missed": len(missed),
            "ok": bool(rel.max() <= EXACT_TOLERANCE and not len(missed))}


def exact_scorer_checks(torch, rows) -> dict:
    """(a) engine/torch_scorer.py on the card at ``rows``: each metric's
    top EXACT_K against fp32 numpy, its device, host and upload times and
    its peak memory; the store's per-search host costs; the control."""
    import numpy as np

    from marqo_tpu_torch.engine import torch_scorer as ts
    n = rows.shape[0]
    rng = np.random.default_rng(EXACT_SEED)
    valid = np.ones(n, dtype=bool)
    valid[rng.choice(n, n // 100, replace=False)] = False
    picks = rng.choice(np.flatnonzero(valid), len(ts.METRICS),
                       replace=False)
    queries = near_queries(rows, picks, EXACT_SEED + 1)
    norms = np.linalg.norm(rows, axis=1)
    mib = 2 ** 20
    metrics = {}
    for metric, pick, q in zip(ts.METRICS, picks, queries):
        closeness = np.where(valid, fp32_closeness(
            metric, rows @ q, norms, float(np.linalg.norm(q))), -np.inf)
        scorer = ts.TorchExactScorer(metric)
        upload_ms = []
        for version in (1, 2):
            torch.cuda.synchronize()
            start = time.perf_counter()
            scorer._ensure(rows, version, DEVICE)
            torch.cuda.synchronize()
            upload_ms.append((time.perf_counter() - start) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        start = time.perf_counter()
        ids, scores = scorer.top_k(rows, 2, q, EXACT_K, valid)
        first_ms = (time.perf_counter() - start) * 1e3
        peak = torch.cuda.max_memory_allocated() - allocated
        result = exact_hits_check(ids, scores, closeness)
        check(result["ok"] and result["k"] == EXACT_K and
              int(ids[0]) == int(pick),
              f"exact scan, {metric}: {result}, top row {ids[0]} for a "
              f"query near row {pick}")
        host_ms = []
        for _ in range(EXACT_REPEATS):
            start = time.perf_counter()
            scorer.top_k(rows, 2, q, EXACT_K, valid)
            host_ms.append((time.perf_counter() - start) * 1e3)
        q_card = torch.from_numpy(q).to(DEVICE, torch.bfloat16)
        valid_card = torch.from_numpy(valid).to(DEVICE)

        def scan():
            s = ts.score_matrix(scorer._device_matrix, q_card, metric)
            torch.topk(s.masked_fill(~valid_card, float("-inf")), EXACT_K)
        with torch.inference_mode():
            device_ms = cuda_ms(scan, EXACT_REPEATS)
        metrics[metric] = {
            **result, "device_ms": device_ms,
            "top_k_host_ms": statistics.median(host_ms),
            "top_k_host_ms_all": host_ms, "first_top_k_ms": first_ms,
            "upload_ms": upload_ms,
            "matrix_mib": scorer._device_matrix.numel() * 2 / mib,
            "peak_mib_over_matrix": peak / mib,
            "max_memory_allocated_mib":
                torch.cuda.max_memory_allocated() / mib}
        del scorer, q_card, valid_card
        torch.cuda.empty_cache()

    # the store's host work on every search: the validity list to an
    # array (engine/store.py ``matrix``, twice a search), and its copy
    valid_list = [bool(v) for v in valid]
    list_ms, copy_ms = [], []
    for _ in range(EXACT_REPEATS):
        start = time.perf_counter()
        mask = np.asarray(valid_list, dtype=bool)
        list_ms.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
        start = time.perf_counter()
        torch.from_numpy(mask).to(DEVICE)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - start) * 1e3)

    # the control: dotproduct's top hits held to angular's fp32 closeness
    # on rows off unit norm must fail the same check
    scaled = rows[:EXACT_CONTROL_ROWS] * rng.uniform(
        0.5, 2.0, (EXACT_CONTROL_ROWS, 1)).astype(np.float32)
    q = queries[0]
    ids, scores = ts.TorchExactScorer("dotproduct").top_k(
        scaled, 1, q, EXACT_K, np.ones(EXACT_CONTROL_ROWS, dtype=bool))
    control = exact_hits_check(ids, scores, fp32_closeness(
        "angular", scaled @ q, np.linalg.norm(scaled, axis=1),
        float(np.linalg.norm(q))))
    check(not control["ok"], f"exact scan control passed: {control}")
    torch.cuda.empty_cache()
    return {"rows": n, "dims": rows.shape[1], "k": EXACT_K,
            "deleted": int((~valid).sum()), "metrics": metrics,
            "valid_list_to_array_ms": statistics.median(list_ms),
            "valid_copy_ms": statistics.median(copy_ms),
            "control": control}


def doc_text(i: int) -> str:
    return f"document {i}"


def feed_docs(store, index: str, rows, prefix: str = "d") -> float:
    """Feeds one document a row, in the shape the API writes them; returns
    the seconds."""
    start = time.perf_counter()
    for i, row in enumerate(rows):
        text = doc_text(i)
        store.feed(index, f"{prefix}{i}", {"text": text},
                   {"text": {"chunks": [text], "embeddings": [row]}})
    return time.perf_counter() - start


def build_exact_corpora(exact_dir: str, crossing_dir: str, crossing: dict,
                        rows, crossing_rows) -> dict:
    """The engine's data dirs, fed with the port's own StoreEngine: the
    stopped engine's state (its snapshots and WAL) plus one document a row
    of ``rows`` ("d0" overwrites the API's), snapshotted as the engine's
    daemon does (rotate the WAL, snapshot, drop the rotated log); and the
    ``crossing`` index alone over ``crossing_rows`` in ``crossing_dir``."""
    from marqo_tpu_torch.engine.descriptor import IndexDescriptor
    from marqo_tpu_torch.engine.store import StoreEngine
    from marqo_tpu_torch.engine.wal import WriteAheadLog
    engine_dir = os.path.join(exact_dir, "engine_data")
    store = StoreEngine()
    store.restore(engine_dir)
    wal = WriteAheadLog(os.path.join(engine_dir, "wal.log"))
    try:
        store.replay_wal(wal)
        store.delete_index("crossing")
        feed_s = feed_docs(store, "exact", rows)
        start = time.perf_counter()
        wal.rotate_begin()
        store.snapshot(engine_dir)
        wal.rotate_commit()
        snapshot_s = time.perf_counter() - start
    finally:
        wal.close()
    vectors = store.vector_count("exact")
    del store
    small = StoreEngine()
    small.create_index(IndexDescriptor.from_json(crossing["descriptor"]))
    feed_docs(small, "crossing", crossing_rows)
    small.snapshot(os.path.join(crossing_dir, "engine_data"))
    return {"feed_seconds": feed_s, "feed_docs_per_s": len(rows) / feed_s,
            "snapshot_seconds": snapshot_s, "engine_rows": vectors,
            "snapshot_bytes": sum(
                os.path.getsize(os.path.join(engine_dir, f))
                for f in os.listdir(engine_dir))}


def bring_up_lines(log: str) -> list:
    """The engine's "Exact scan up" lines: when (epoch seconds), rows and
    the bring-up's ms, whole and by part."""
    import datetime
    import re
    out = []
    for m in re.finditer(BRING_UP_LINE, log):
        when = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f")
        out.append({"at": when.timestamp(), "device": m.group(2),
                    "rows": int(m.group(3)), "dims": int(m.group(4)),
                    "metric": m.group(5), "ms": float(m.group(6)),
                    "torch_and_cuda_init_ms": float(m.group(7)),
                    "context_ms": float(m.group(8)),
                    "upload_ms": float(m.group(9)),
                    "first_scan_ms": float(m.group(10))})
    return out


def log_time(log: str, text: str) -> float:
    """Epoch seconds of the first log line holding ``text``."""
    import datetime
    line = next(line for line in log.splitlines() if text in line)
    return datetime.datetime.strptime(
        " ".join(line.split()[:2]), "%Y-%m-%d %H:%M:%S,%f").timestamp()


def exact_search(port: int, index: str, query) -> tuple:
    """One approximate=False TENSOR search by the vector ``query`` (a
    context tensor, as Marqo's API takes one). Returns (status, body, ms)."""
    body = {"context": {"tensor": [{"vector": query.tolist(), "weight": 1}]},
            "searchMethod": "TENSOR", "approximate": False,
            "limit": EXACT_LIMIT}
    start = time.perf_counter()
    status, res = http_json(port, "POST", f"/indexes/{index}/search", body)
    return status, res, (time.perf_counter() - start) * 1e3


def hits_against(res, closeness, added_from: int) -> dict:
    """An HTTP search's hits against the fp32 closeness of every row:
    document "d<i>" is row i, "add<j>" row ``added_from`` + j."""
    hits = res["hits"]
    check(len(hits) == EXACT_LIMIT, f"exact search: {len(hits)} hits")
    rows = [added_from + int(h["_id"][3:]) if h["_id"].startswith("add")
            else int(h["_id"][1:]) for h in hits]
    return exact_hits_check(rows, [h["_score"] for h in hits], closeness)


def added_vectors(port: int, index: str, ids) -> "np.ndarray":
    """The stored vectors of documents ``ids``, through the API."""
    import numpy as np
    status, body = http_json(port, "GET",
                             f"/indexes/{index}/documents?expose_facets=true",
                             list(ids))
    check(status == 200 and all(d["_found"] for d in body["results"]),
          f"get documents: {status} {str(body)[:500]}")
    return np.asarray([d["_tensor_facets"][0]["_embedding"]
                       for d in body["results"]], dtype=np.float32)


def phase_exact_scan(torch, smi):
    """The engine's exact scan (approximate=False) at EXACT_ROWS rows of
    e5-base-v2's width. (a) engine/torch_scorer.py on the card, every
    metric against fp32 numpy, with a control that must fail. (b) The
    launch script's engine role restarted over a data dir of EXACT_ROWS
    documents (the index made through an API worker; the corpus fed and
    snapshotted with the port's StoreEngine): the device comes up before
    /engine/health answers, the first search through a worker's HTTP
    answers within MARQO_SEARCH_TIMEOUT_MS's default; then one add and
    more searches. (c) An engine over EXACT_CROSSING_ROWS rows, without
    torch until an add crosses MIN_ROWS_FOR_DEVICE: the add returns while
    the device comes up. SIGTERM leaves nothing on the card."""
    import gc

    import numpy as np

    from marqo_tpu_torch.engine import torch_scorer as ts
    props = e5_props()
    name, dims = props["name"], props["dimensions"]
    rows = unit_rows(torch, EXACT_ROWS, dims, EXACT_SEED)
    scorer = exact_scorer_checks(torch, rows)

    # what (b) and (c) compare with, before the rows are freed
    rng = np.random.default_rng(EXACT_SEED + 2)
    picks = rng.choice(EXACT_ROWS, EXACT_SEARCHES + EXACT_AFTER_ADD,
                       replace=False)
    queries = near_queries(rows, picks, EXACT_SEED + 3)
    dots = rows @ queries.T
    crossing_rows = rows[:EXACT_CROSSING_ROWS].copy()
    crossing_query = near_queries(crossing_rows, [EXACT_CROSSING_ROWS // 2],
                                  EXACT_SEED + 4)[0]
    preload = json.dumps([{"model": name, "modelProperties": props}])
    _, text = text_docs(torch, 0, seed=EXACT_SEED)

    used_before, apps_before = device_used_bytes(), gpu_compute_apps()
    runs = []
    tmp = tempfile.TemporaryDirectory()
    try:
        workdir = tmp.name
        exact_dir, crossing_dir, api_dir = (
            os.path.join(workdir, d) for d in ("exact", "crossing", "api"))
        engine_port, api_port = free_port(), free_port()

        def start_engine(label, data_dir):
            wall = time.time()
            run = Launched(label, ["engine"], launch_env(
                workdir, MARQO_ENGINE_PORT=engine_port,
                MARQO_ENGINE_DATA_DIR=data_dir), workdir)
            runs.append(run)
            return run, wall, run.wait_ready(engine_port, "/engine/health")

        def start_worker(label):
            run = Launched(label, [], launch_env(
                workdir, MARQO_HOST="127.0.0.1", MARQO_PORT=api_port,
                MARQO_ENGINE_QUERY_URL=f"http://127.0.0.1:{engine_port}",
                MARQO_ENGINE_DATA_DIR=api_dir,
                MARQO_MODELS_TO_PRELOAD=preload), workdir)
            runs.append(run)
            return run, run.wait_ready(api_port, "/health")

        def add(index, docs):
            start = time.perf_counter()
            status, res = http_json(api_port, "POST",
                                    f"/indexes/{index}/documents",
                                    {"documents": docs,
                                     "tensorFields": ["text"]})
            check(status == 200 and res["errors"] is False,
                  f"{index} add: {status} {str(res)[:500]}")
            return time.perf_counter() - start

        # the indexes, made through a worker over the engine role, and one
        # document as the API writes it, read back from the engine
        engine, _, _ = start_engine("exact-create-engine", exact_dir)
        worker, _ = start_worker("exact-create-api")
        for index in ("exact", "crossing"):
            status, body = http_json(api_port, "POST", f"/indexes/{index}",
                                     {"model": name, "modelProperties": props})
            check(status == 200, f"create {index}: {status} {body}")
        add("exact", [{"_id": "d0", "text": doc_text(0)}])
        status, dump = http_json(engine_port, "GET",
                                 "/engine/indexes/exact/dump")
        shape = dump["docs"][0] if status == 200 else {}
        check(shape.get("fields") == {"text": doc_text(0)} and
              [(e["chunk"], len(e["embedding"])) for e in
               shape.get("tensors", {}).get("text", [])] ==
              [(doc_text(0), dims)] and list(shape["tensors"]) == ["text"],
              f"the API's document in the engine: {str(dump)[:1000]}")
        status, crossing = http_json(engine_port, "GET",
                                     "/engine/indexes/crossing/dump")
        check(status == 200, f"crossing dump: {status}")
        worker.stop([api_port])
        engine.stop([engine_port])

        build = build_exact_corpora(exact_dir, crossing_dir, crossing, rows,
                                    crossing_rows)
        del rows
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the engine role restarted over the million rows
        used_idle = device_used_bytes()
        engine, wall, engine_s = start_engine("exact-engine", exact_dir)
        used_engine = device_used_bytes()
        log = engine.log()
        up = bring_up_lines(log)
        # the rows: the corpus and the API's "d0", overwritten, which a
        # WAL replayed over a snapshot that holds it appends once more
        check(len(up) == 1 and up[0]["rows"] > EXACT_ROWS and
              up[0]["device"] == DEVICE and loads_torch(engine.proc.pid),
              f"the engine's bring-up at restore: {up} {log[-3000:]}")
        restored_s = log_time(log, "Restored") - wall
        worker, worker_s = start_worker("exact-api")
        searches = []
        for j in range(EXACT_SEARCHES):
            status, res, ms = exact_search(api_port, "exact", queries[j])
            check(status == 200, f"exact search {j}: {status} "
                  f"{str(res)[:500]} after {ms} ms")
            searches.append({"ms": ms, **hits_against(
                res, 1.0 / (2.0 - dots[:, j]), EXACT_ROWS)})
        check(all(s["ok"] for s in searches),
              f"exact searches against fp32 numpy: {searches}")
        check(searches[0]["ms"] < EXACT_TIMEOUT_MS,
              f"first exact search after the restart: "
              f"{searches[0]['ms']} ms")

        # one add over the engine role: the matrix is uploaded again
        added = [{"_id": f"add{j}", "text": text(4 + j % 24)}
                 for j in range(EXACT_ADD_DOCS)]
        add_s = add("exact", added)
        vectors = added_vectors(api_port, "exact", [d["_id"] for d in added])
        after_add = []
        for j in range(EXACT_SEARCHES, EXACT_SEARCHES + EXACT_AFTER_ADD):
            status, res, ms = exact_search(api_port, "exact", queries[j])
            entry = {"status": status, "ms": ms}
            if status == 200:
                closeness = 1.0 / (2.0 - np.concatenate(
                    [dots[:, j], vectors @ queries[j]]))
                entry.update(hits_against(res, closeness, EXACT_ROWS))
            after_add.append(entry)
        check(after_add[-1]["status"] == 200 and
              all(e.get("ok", True) for e in after_add),
              f"exact searches after the add: {after_add}")
        used_after_add = device_used_bytes()
        stop_worker = worker.stop([api_port])
        stop_engine = engine.stop([engine_port])

        # (c) crossing MIN_ROWS_FOR_DEVICE with a write
        engine, _, crossing_engine_s = start_engine("crossing-engine",
                                                    crossing_dir)
        torch_at_start = loads_torch(engine.proc.pid)
        check(not torch_at_start and not bring_up_lines(engine.log()),
              "the engine under MIN_ROWS_FOR_DEVICE loaded PyTorch")
        worker, _ = start_worker("crossing-api")
        added = [{"_id": f"add{j}", "text": text(4 + j % 24)}
                 for j in range(EXACT_CROSSING_ADD)]
        add_wall = time.time()
        crossing_add_s = add("crossing", added)
        start = time.perf_counter()
        while not bring_up_lines(engine.log()):
            check(time.perf_counter() - start < EXACT_READY_S,
                  f"no bring-up within {EXACT_READY_S} s of the crossing: "
                  f"{engine.log()[-3000:]}")
            time.sleep(0.1)
        crossing_up = bring_up_lines(engine.log())
        check(len(crossing_up) == 1 and
              crossing_up[0]["rows"] == ts.MIN_ROWS_FOR_DEVICE and
              loads_torch(engine.proc.pid) and
              crossing_up[0]["at"] > add_wall + crossing_add_s,
              f"the crossing's bring-up: {crossing_up}, add "
              f"{crossing_add_s} s")
        vectors = added_vectors(api_port, "crossing",
                                [d["_id"] for d in added])
        status, res, crossing_ms = exact_search(api_port, "crossing",
                                                crossing_query)
        check(status == 200, f"crossing search: {status} {str(res)[:500]}")
        crossing_hits = hits_against(
            res, 1.0 / (2.0 - np.concatenate([crossing_rows @ crossing_query,
                                              vectors @ crossing_query])),
            EXACT_CROSSING_ROWS)
        check(crossing_hits["ok"], f"crossing search: {crossing_hits}")
        used_crossing = device_used_bytes()
        stop_crossing_worker = worker.stop([api_port])
        stop_crossing_engine = engine.stop([engine_port])

        apps_after = gpu_compute_apps()
        check(len(apps_after) == len(apps_before),
              f"compute processes on the card: {apps_after} after, "
              f"{apps_before} before")
        start = time.perf_counter()
        while device_used_bytes() > used_before + LAUNCH_MEMORY_SLACK and \
                time.perf_counter() - start < LAUNCH_STOP_S:
            time.sleep(0.2)
        used_after = device_used_bytes()
        check(used_after <= used_before + LAUNCH_MEMORY_SLACK,
              f"the card holds {(used_after - used_before) / 2 ** 20:.0f} "
              f"MiB more than before the exact scan's runs")
    finally:
        for run in runs:
            run.kill()
        tmp.cleanup()
    mib = 2 ** 20
    ms = [s["ms"] for s in searches]
    emit("exact_scan", ok=True, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, scorer=scorer,
         corpus={"rows": EXACT_ROWS, "dims": dims,
                 "metric": "prenormalized-angular", **build},
         restart={"engine_healthy_s": engine_s,
                  "restored_s": restored_s,
                  "bring_up": up[0], "worker_healthy_s": worker_s,
                  "engine_card_mib": (used_engine - used_idle) / mib,
                  "first_search_ms": ms[0],
                  "search_median_ms": statistics.median(ms),
                  "search_ms": ms, "searches": searches,
                  "add_docs": EXACT_ADD_DOCS, "add_s": add_s,
                  "after_add": after_add,
                  "engine_card_mib_after_add":
                      (used_after_add - used_idle) / mib,
                  "worker_stop_s": stop_worker["stop_seconds"],
                  "engine_stop_s": stop_engine["stop_seconds"]},
         crossing={"rows": EXACT_CROSSING_ROWS,
                   "engine_healthy_s": crossing_engine_s,
                   "torch_at_start": torch_at_start,
                   "add_docs": EXACT_CROSSING_ADD,
                   "add_s": crossing_add_s,
                   "device_ready_after_add_start_s":
                       crossing_up[0]["at"] - add_wall,
                   "bring_up": crossing_up[0],
                   "search_ms": crossing_ms, "search": crossing_hits,
                   "engine_card_mib": (used_crossing - used_idle) / mib,
                   "worker_stop_s": stop_crossing_worker["stop_seconds"],
                   "engine_stop_s": stop_crossing_engine["stop_seconds"]},
         device_used_mib={"before": used_before / mib,
                          "after": used_after / mib},
         compute_apps_before=apps_before, compute_apps_after=apps_after)


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
    from marqo_tpu_torch.ops import quant_matmul as qm
    prebuilt = _build.library_path().is_file()
    start = time.perf_counter()
    library = _build.load_library()
    emit("build", ok=True, seconds=time.perf_counter() - start,
         prebuilt=prebuilt, library=os.path.relpath(library._name, ROOT),
         flags=_build.NVCC_FLAGS)

    errors = phase_kernel(fa, torch)
    fused_errors = phase_fused_kernel(fused, torch)
    phase_quant_kernel(qm, torch)
    phase_c1_shapes(fa, fused, qm, torch)
    encoder_launches = phase_encoder(torch)
    int8_encoder, bf16_encoder = phase_int8_encoder(torch)
    clip_model, pixels = phase_clip_encoder(torch)
    server = HttpServer()
    try:
        serve = phase_serve(server, torch)
        clip_launches, clip_add_seconds = phase_clip_serve(server, torch)
        int8 = phase_int8_serve(server, torch)
        phase_rerank(server, torch)
        stella = phase_stella_serve(server, torch)
        hf_clip_add_seconds = phase_hf_clip_serve(server, torch)
        _, siglip_add_seconds = phase_siglip_serve(server, torch)
        _, coca_add_seconds = phase_coca_serve(server, torch)
        languagebind, _, languagebind_add_seconds = \
            phase_languagebind_serve(server, torch)
        phase_languagebind_video(languagebind, torch)
        patch_launches = phase_patch_serve(server, torch)
        owl_launches = phase_owl_rerank(server, torch)
        phase_mesh_off(torch)
        mesh_serve = phase_mesh_serve(server, fa, torch, smi)
        phase_launch(server, torch, smi)
    finally:
        server.close()
    phase_exact_scan(torch, smi)
    phase_nllb_siglip_encode(torch)
    phase_conv_clip_encode(torch)
    phase_eva02_encode(torch)
    mesh_replicated = phase_mesh_replicated(fa, fused, qm, torch)
    phase_train_step(torch)
    # the long-token towers ran B2 on the wgmma loop alone
    for phase in ("clip_serve", "eva02_encode", "languagebind_serve",
                  "owl_rerank"):
        check_loop(phase, "fused_attention", "wgmma")

    phase_encoder_graphs(torch, smi)
    phase_family_graphs(torch, smi)
    phase_last_family_graphs(torch, smi)
    dsv2 = phase_dsv2_attention(fa, torch, smi)
    timing, vit, encoder_times = phase_timing(
        fa, fused, qm, torch, clip_model, pixels, int8_encoder, bf16_encoder)
    emit("detector_timing", device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, kernel_vs_twin=phase_detector_timing(
             fused, torch, patch_launches, owl_launches))
    emit("mesh_timing", device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, kernel_vs_twin=phase_mesh_timing(
             fa, fused, qm, torch, mesh_serve, mesh_replicated))
    w8a8_path = phase_w8a8_path(qm, torch, int8["w8a8_by_layer"], smi)
    latencies = serve["latencies"]
    emit("timing", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         kernel_vs_twin=timing, vit_l14=vit, e5_encoder=encoder_times,
         add_docs_per_s=(serve["docs"] - 1) / serve["add_seconds"],
         add_seconds=serve["add_seconds"],
         int8_add_docs_per_s=(int8["docs"] - 1) / int8["add_seconds"],
         int8_add_seconds=int8["add_seconds"],
         int8_search_median_ms=statistics.median(int8["latencies"]),
         clip_add_docs_per_s=CLIP_DOCS / clip_add_seconds,
         clip_add_seconds=clip_add_seconds,
         stella_add_docs_per_s=(stella["docs"] - 1) / stella["add_seconds"],
         stella_search_median_ms=statistics.median(stella["latencies"]),
         hf_clip_add_docs_per_s=HF_CLIP_DOCS / hf_clip_add_seconds,
         siglip_add_docs_per_s=SIGLIP_DOCS / siglip_add_seconds,
         coca_add_docs_per_s=COCA_DOCS / coca_add_seconds,
         languagebind_add_docs_per_s=(
             LANGUAGEBIND_CLIPS + LANGUAGEBIND_IMAGES) /
         languagebind_add_seconds,
         search_median_ms=statistics.median(latencies), search_ms=latencies,
         note="information only")

    def timed(kernel, mode, shape, layout="projection"):
        """The row of the layout the main path hands the kernel: the
        projections' views for attention (B3 has one layout)."""
        return next(row for row in timing if row["kernel"] == kernel and
                    row["mode"] == mode and row["shape"] == shape and
                    row.get("layout", layout) == layout)

    def entry(name, source, replaces, launches, max_abs_err, row, bounds,
              loops):
        """``loops``: the path's launches per tile loop; ``loop``: the one
        that served the timed row."""
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": bounds["bound_ms"],
                "bound_by": bounds["bound_by"],
                "library_ms": row["library_ms"],
                "loop": row.get("loop", "wgmma"), "loops": loops}

    def path_loops(phase, kernel):
        return {name[len(kernel) + 1:]: n for name, n in
                PHASE_LOOPS[phase].items() if name.startswith(kernel + "_")}

    # the attention rows carry the bound of their own inputs' mask
    B, N, S, D = 256, 12, 128, 64
    kernels = []
    for mode in ("padding", "segment"):
        row = timed("masked_attention", mode, [B, N, S, D])
        kernels.append(entry(f"masked_attention_{mode}", B1_SOURCE,
                             B1_REPLACES,
                             serve["launches"][f"masked_attention_{mode}"],
                             errors[mode], row, row,
                             path_loops("serve", "masked_attention")))
    # B2's no-mask mode at the ViT-L/14 shape, launched by the CLIP serve
    # path; its segment mode at the encoder's ingest shape, launched by the
    # encoder's "flash" path
    for mode, shape, counts, phase in (
            ("nomask", [16, 16, 257, 64], clip_launches, "clip_serve"),
            ("segment", [B, N, S, D], encoder_launches, "encoder")):
        row = timed("fused_attention", mode, shape)
        kernels.append(entry(
            f"fused_attention_{mode}", B2_SOURCE, B2_REPLACES,
            counts[f"fused_attention_{mode}"], fused_errors[mode], row, row,
            path_loops(phase, "fused_attention")))
    # B3 at the int8 serve path's (M, K, N) of the largest launch-weighted
    # bound, its error the largest over every shape the path launched
    row = w8a8_path["row"]
    kernels.append(entry(
        "w8a8_matmul", B3_SOURCE, B3_REPLACES,
        int8["launches"]["w8a8_matmul"], w8a8_path["max_abs_err"], row, row,
        {"wgmma": int8["launches"]["w8a8_matmul"]}))
    kernels[-1]["shape"] = row["shape"]
    kernels[-1]["launches_by_layer"] = int8["w8a8_by_layer"]
    # B1's causal instances at DeepSeek-V2's path's own shapes
    kernels += dsv2["kernels"]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
