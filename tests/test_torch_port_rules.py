"""Rules of the port (marqo_tpu_torch beside marqo_tpu):

(a) marqo_tpu_torch runs without JAX and without the JAX package;
(b) every copied module equals its marqo_tpu original once the package
    name is normalised, apart from a short, named list of deliberate edits,
    and so does every function or constant a ported module copies;
(c) no file under marqo_tpu_torch imports jax.
"""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "marqo_tpu")
PORT = os.path.join(REPO, "marqo_tpu_torch")

# rewritten in torch: compared against the JAX package by the parity tests
PORTED = {
    "ops/common.py", "ops/flash_attention.py", "ops/fused_attention.py",
    "ops/image_ops.py", "ops/_build.py", "ops/quant.py",
    "ops/quant_matmul.py", "models/bert.py", "models/clip.py",
    "models/cross_encoder.py", "models/stella.py", "models/hf_clip.py",
    "models/siglip.py", "models/resnet_clip.py", "models/convnext_clip.py",
    "models/nllb_siglip.py", "models/eva02.py", "models/coca.py",
    "models/languagebind.py", "ops/audio_ops.py", "inference/types.py",
    "inference/batching.py", "inference/loaders.py", "inference/graphs.py",
    "ops/launches.py", "models/deepseek_v2.py", "ops/moe.py",
    "ops/decoder_glue.py",
    "engine/torch_scorer.py", "models/dino_vit.py", "models/yolox.py",
    "models/frcnn.py", "models/owl_vit.py", "parallel/__init__.py",
    "parallel/mesh.py", "parallel/serving.py", "parallel/encode.py",
    "parallel/train_step.py",
}

# numpy functions and constants that ported modules copy as they are
COPIED_DEFINITIONS = {
    "ops/audio_ops.py": ("SAMPLE_RATE", "N_FFT", "WIN_LENGTH", "HOP_LENGTH",
                         "N_MELS", "load_wav", "_hz_to_mel", "_mel_to_hz",
                         "mel_filterbank", "chunk_waveform"),
    "models/eva02.py": ("EVA02_ARCHS", "rope_2d_freqs"),
    "models/dino_vit.py": ("DINO_MEAN", "DINO_STD"),
    "models/yolox.py": ("decode_outputs",),
    "models/frcnn.py": ("IMAGENET_MEAN", "IMAGENET_STD", "decode_proposals"),
}

# copies with deliberate edits, and why
DELIBERATE_EDITS = {
    "__init__.py": "package docstring names the PyTorch/CUDA port",
    "api/telemetry.py": "a span recorder: request ids, per-thread stacks "
                        "of open spans, a bounded span log on time.time_ns's "
                        "clock, stage sites and a collector hook for traced "
                        "requests, and a count log of per-part counters "
                        "(the tokens each expert of a mixture of experts "
                        "took); Timer, TimerError and merge, which the "
                        "port never used, went, and so did the method that "
                        "bound a worker thread to a request's timers",
    "api/http_framework.py": "a request with ?telemetry=true is traced",
    "inference/vectorise.py": "vectorise answers one (n, dim) float32 "
                              "array and has no async form; the cache "
                              "stores a float32 row a text; the rows are "
                              "made inside the span inference.to_lists of "
                              "a traced request",
    "api/configs.py": "no default for the add path's sub-batch pipeline, "
                      "which the port does not have",
    "api/app.py": "startup picks the device first and keeps a "
                  "MARQO_BEST_AVAILABLE_DEVICE already set; without one and "
                  "without CUDA it raises instead of serving on the CPU",
    "core/add_documents.py": "one synchronous add path, plan, vectorise, "
                             "feed, with no sub-batch pipeline; it feeds "
                             "each field a slice of its modality's float32 "
                             "rows, under the span inference.to_lists",
    "core/monitoring.py": "get_accelerator_info reads torch.cuda and fills "
                          "the memory fields",
    "engine/store.py": "the exact-scan hook points at engine/torch_scorer.py; "
                       "a docstring named jax; the write that takes a field "
                       "to MIN_ROWS_FOR_DEVICE rows starts the device "
                       "bring-up (torch_scorer.bring_up_field), so no search "
                       "brings CUDA up",
    "engine/wal.py": "setup_engine_durability brings the exact scan's device "
                     "up after the restore and the WAL's replay, before the "
                     "server binds its port (torch_scorer.bring_up_engine); "
                     "the reference brings it up inside the first search",
    "inference/model_registry.py": "docstrings and notes named the JAX model "
                                   "classes",
    "inference/image_patching.py": "the DINO/YOLOX/Faster R-CNN patchers "
                                   "hold torch modules on the serving "
                                   "device, their random weights drawn from "
                                   "a torch.Generator; one host copy per "
                                   "image; on CUDA each DINO, YOLOX and "
                                   "Faster R-CNN patcher replays a CUDA "
                                   "graph of its own (Faster R-CNN's ten "
                                   "level outputs as one tensor, YOLOX's "
                                   "batch of one with a real stride)",
    "inference/rerank.py": "the cross-encoder is models/cross_encoder.py's "
                           "TorchCrossEncoder and the OWL-ViT reranker "
                           "TorchOwlReranker: a torch module on one device, "
                           "random weights from a torch.Generator, one host "
                           "copy per batch; on CUDA one CUDA graph per hit "
                           "count",
}


def _package_files(root):
    out = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if name.endswith((".pyc", ".so", ".o")):
                continue
            out.add(os.path.relpath(os.path.join(dirpath, name), root))
    return out


PORT_FILES = sorted(_package_files(PORT))
COPIES = sorted(f for f in PORT_FILES
                if f not in PORTED and not f.startswith("csrc/"))


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def test_every_port_file_is_a_port_a_copy_or_a_kernel_source():
    reference = _package_files(REFERENCE)
    for rel in PORT_FILES:
        assert rel in PORTED or rel in reference or rel.startswith("csrc/"), \
            rel
    assert set(DELIBERATE_EDITS) <= set(COPIES)
    assert PORTED <= set(PORT_FILES)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_original(rel):
    copy = _read(os.path.join(PORT, rel))
    normalised = re.sub(r"\bmarqo_tpu_torch\b", "marqo_tpu", copy)
    original = _read(os.path.join(REFERENCE, rel))
    if rel in DELIBERATE_EDITS:
        assert normalised != original, \
            f"{rel} is listed as edited but equals its original"
    else:
        assert normalised == original, \
            f"{rel} differs from marqo_tpu/{rel}; list it in DELIBERATE_EDITS"
    assert "jax" not in copy.lower(), f"{rel} still mentions jax"


def _definition(path, name):
    """The source of the top-level function or assignment ``name``."""
    text = _read(path)
    for node in ast.parse(text).body:
        names = ([node.name] if isinstance(node, ast.FunctionDef) else
                 [t.id for t in getattr(node, "targets", [])
                  if isinstance(t, ast.Name)])
        if name in names:
            return ast.get_source_segment(text, node)
    raise AssertionError(f"{name} not defined in {path}")


@pytest.mark.parametrize("rel, name", [(rel, name) for rel, names in
                                       COPIED_DEFINITIONS.items()
                                       for name in names])
def test_copied_definition_matches_original(rel, name):
    assert rel in PORTED
    copy = _definition(os.path.join(PORT, rel), name)
    normalised = re.sub(r"\bmarqo_tpu_torch\b", "marqo_tpu", copy)
    assert normalised == _definition(os.path.join(REFERENCE, rel), name), \
        f"{rel}: {name} differs from marqo_tpu/{rel}'s"


@pytest.mark.parametrize("rel", [f for f in PORT_FILES
                                 if f.endswith((".py", ".cu"))])
def test_no_jax_and_no_reference_package_imports(rel):
    text = _read(os.path.join(PORT, rel))
    assert not re.search(r"^\s*(import jax|from jax)\b", text, re.M), rel
    assert not re.search(r"^\s*(import|from) marqo_tpu(\.|\s|$)", text,
                         re.M), rel


def test_app_serves_without_jax_or_marqo_tpu(tmp_path):
    """Create an index, add documents and search, in a process where
    importing jax or marqo_tpu fails."""
    script = textwrap.dedent("""
        import json, sys
        sys.modules["jax"] = None
        sys.modules["marqo_tpu"] = None
        from marqo_tpu_torch.api.app import build_app, generate_config, on_start
        config = generate_config()
        on_start(config)
        app = build_app(config)

        def call(method, path, body=None):
            response = app.dispatch(
                method, path, json.dumps(body).encode() if body else b"", {})
            assert response.status == 200, (response.status, response.body)
            return response.body

        call("POST", "/indexes/t1", {"model": "test"})
        res = call("POST", "/indexes/t1/documents", {
            "documents": [{"_id": str(i), "text": "hello world " * (i + 1)}
                          for i in range(6)],
            "tensorFields": ["text"]})
        assert res["errors"] is False, res
        for method in ("TENSOR", "HYBRID"):
            hits = call("POST", "/indexes/t1/search",
                        {"q": "hello", "searchMethod": method})["hits"]
            assert hits, method
        assert not any(m == "jax" or m.startswith(("jax.", "marqo_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    # this host has no CUDA device: serve on the CPU on purpose
    env = dict(os.environ, PYTHONPATH=REPO, MARQO_MODELS_TO_PRELOAD="[]",
               HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               MARQO_BEST_AVAILABLE_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")
