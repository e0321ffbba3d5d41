"""Built-in model registry: name → properties dict.

Parity: reference src/marqo/s2_inference/model_registry.py (~230 entries,
families: openai CLIP, open_clip, SBERT, HF, multilingual CLIP, random/test/
no_model; loader map at model_registry.py:2133-2145). Property keys follow
the reference (``name``, ``dimensions``, ``tokens``, ``type``, ``notes``,
``text_query_prefix``/``text_chunk_prefix``) so user-supplied
``model_properties`` stay drop-in compatible.

Loader ``type`` values map to model classes in
marqo_tpu_torch.inference.loaders (vs. reference's torch/open_clip/onnx classes):
  hf | sbert        → TorchHFTextModel   (BERT/RoBERTa-family, models/bert.py)
  hf_stella         → TorchStellaModel   (models/stella.py)
  clip | open_clip | fp16_clip → by arch in the name:
      coca_*        → TorchCoCaModel        (models/coca.py)
      *SigLIP*      → TorchSigLIPModel      (models/siglip.py)
      nllb-*        → TorchNLLBSigLIPModel  (models/nllb_siglip.py; M2M-100
                      text transformers-verified; open_clip pairing behind
                      MARQO_ALLOW_UNVERIFIED_CONVERSION)
      RN50*/RN101*  → TorchResNetCLIPModel  (models/resnet_clip.py)
      convnext_*    → TorchConvNextCLIPModel (models/convnext_clip.py)
      *roberta*     → TorchHFCLIPModel      (models/hf_clip.py)
      EVA02*        → TorchEVA02Model       (models/eva02.py; real ckpts
                      behind MARQO_ALLOW_UNVERIFIED_CONVERSION)
      otherwise     → TorchCLIPModel        (ViT towers, models/clip.py)
  multilingual_clip → TorchHFCLIPModel (XLM-R + LinearTransformation)
  languagebind      → TorchLanguageBindModel (models/languagebind.py)
  random            → RandomModel (deterministic, tests)
  test              → TestModel (tiny real torch encoder + WordPiece)
  no_model          → NoModel (raises on vectorise)
"""

from typing import Dict, Optional


def _hf(name: str, dims: int, tokens: int = 128, pooling: str = "mean",
        query_prefix: Optional[str] = None, passage_prefix: Optional[str] = None,
        model_type: str = "hf", **extra) -> dict:
    props = {
        "name": name,
        "dimensions": dims,
        "tokens": tokens,
        "type": model_type,
        "pooling_method": pooling,
        "notes": "",
    }
    if query_prefix is not None:
        props["text_query_prefix"] = query_prefix
    if passage_prefix is not None:
        props["text_chunk_prefix"] = passage_prefix
    props.update(extra)
    return props


def _e5(name: str, dims: int, tokens: int = 512) -> dict:
    return _hf(name, dims, tokens, pooling="mean",
               query_prefix="query: ", passage_prefix="passage: ")


def _bge(name: str, dims: int) -> dict:
    return _hf(name, dims, 512, pooling="cls",
               query_prefix="Represent this sentence for searching relevant passages: ",
               passage_prefix="")


def _clip(name: str, dims: int, image_size: int = 224, **extra) -> dict:
    return {"name": name, "dimensions": dims, "type": "clip",
            "image_size": image_size, "notes": "CLIP", **extra}


def _open_clip(name: str, dims: int, pretrained: str, image_size: int = 224,
               **extra) -> dict:
    return {"name": name, "dimensions": dims, "type": "open_clip",
            "pretrained": pretrained, "image_size": image_size,
            "notes": "open_clip model", **extra}


def _hf_models() -> Dict[str, dict]:
    m = {
        # e5 family (reference model_registry HF section)
        "hf/e5-small": _e5("intfloat/e5-small", 384),
        "hf/e5-base": _e5("intfloat/e5-base", 768),
        "hf/e5-large": _e5("intfloat/e5-large", 1024),
        "hf/e5-small-v2": _e5("intfloat/e5-small-v2", 384),
        "hf/e5-base-v2": _e5("intfloat/e5-base-v2", 768),
        "hf/e5-large-v2": _e5("intfloat/e5-large-v2", 1024),
        "hf/e5-small-unsupervised": _e5("intfloat/e5-small-unsupervised", 384),
        "hf/e5-base-unsupervised": _e5("intfloat/e5-base-unsupervised", 768),
        "hf/e5-large-unsupervised": _e5("intfloat/e5-large-unsupervised", 1024),
        "hf/multilingual-e5-small": _e5("intfloat/multilingual-e5-small", 384),
        "hf/multilingual-e5-base": _e5("intfloat/multilingual-e5-base", 768),
        "hf/multilingual-e5-large": _e5("intfloat/multilingual-e5-large", 1024),
        "hf/multilingual-e5-large-instruct": _e5(
            "intfloat/multilingual-e5-large-instruct", 1024),
        # BGE family
        "hf/bge-small-en-v1.5": _bge("BAAI/bge-small-en-v1.5", 384),
        "hf/bge-base-en-v1.5": _bge("BAAI/bge-base-en-v1.5", 768),
        "hf/bge-large-en-v1.5": _bge("BAAI/bge-large-en-v1.5", 1024),
        "hf/bge-small-zh-v1.5": _bge("BAAI/bge-small-zh-v1.5", 512),
        "hf/bge-base-zh-v1.5": _bge("BAAI/bge-base-zh-v1.5", 768),
        "hf/bge-large-zh-v1.5": _bge("BAAI/bge-large-zh-v1.5", 1024),
        # GTE / snowflake / misc HF
        "hf/GIST-large-Embedding-v0": _hf("avsolatorio/GIST-large-Embedding-v0", 1024, 512),
        "hf/gte-base": _hf("thenlper/gte-base", 768, 512),
        "hf/gte-large": _hf("thenlper/gte-large", 1024, 512),
        "hf/snowflake-arctic-embed-m": _hf(
            "Snowflake/snowflake-arctic-embed-m", 768, 512, pooling="cls",
            query_prefix="Represent this sentence for searching relevant passages: "),
        "hf/snowflake-arctic-embed-l": _hf(
            "Snowflake/snowflake-arctic-embed-l", 1024, 512, pooling="cls",
            query_prefix="Represent this sentence for searching relevant passages: "),
        "hf/all_datasets_v3_MiniLM-L6": _hf(
            "flax-sentence-embeddings/all_datasets_v3_MiniLM-L6", 384),
        "hf/all_datasets_v4_MiniLM-L6": _hf(
            "flax-sentence-embeddings/all_datasets_v4_MiniLM-L6", 384),
        "hf/all_datasets_v3_mpnet-base": _hf(
            "flax-sentence-embeddings/all_datasets_v3_mpnet-base", 768),
        "hf/all_datasets_v4_mpnet-base": _hf(
            "flax-sentence-embeddings/all_datasets_v4_mpnet-base", 768),
        "hf/all_datasets_v3_MiniLM-L12": _hf(
            "flax-sentence-embeddings/all_datasets_v3_MiniLM-L12", 384),
        "hf/all_datasets_v4_MiniLM-L12": _hf(
            "flax-sentence-embeddings/all_datasets_v4_MiniLM-L12", 384),
        "hf/all-MiniLM-L6-v1": _hf("sentence-transformers/all-MiniLM-L6-v1", 384),
        "hf/all-MiniLM-L6-v2": _hf("sentence-transformers/all-MiniLM-L6-v2", 384),
        "hf/all-mpnet-base-v1": _hf("sentence-transformers/all-mpnet-base-v1", 768),
        "hf/all-mpnet-base-v2": _hf("sentence-transformers/all-mpnet-base-v2", 768),
        "hf/ember-v1": _hf("llmrails/ember-v1", 1024, 512),
        "hf/snowflake-arctic-embed-m-v1.5": _hf(
            "Snowflake/snowflake-arctic-embed-m-v1.5", 768, 512, pooling="cls",
            query_prefix="Represent this sentence for searching relevant passages: "),
        # custom arch loaded with trust_remote_code in the reference
        # (model_registry.py:898-904, type hf_stella); arch in
        # models/stella.py
        "Marqo/dunzhang-stella_en_400M_v5": _hf(
            "Marqo/dunzhang-stella_en_400M_v5", 1024, 512, pooling="mean",
            model_type="hf_stella", trustRemoteCode=True),
    }
    return m


def _sbert_models() -> Dict[str, dict]:
    names = {
        "sentence-transformers/all-MiniLM-L6-v1": 384,
        "sentence-transformers/all-MiniLM-L6-v2": 384,
        "sentence-transformers/all-MiniLM-L12-v1": 384,
        "sentence-transformers/all-MiniLM-L12-v2": 384,
        "sentence-transformers/all-mpnet-base-v1": 768,
        "sentence-transformers/all-mpnet-base-v2": 768,
        "sentence-transformers/all-roberta-large-v1": 1024,
        "sentence-transformers/all-distilroberta-v1": 768,
        "sentence-transformers/multi-qa-MiniLM-L6-cos-v1": 384,
        "sentence-transformers/multi-qa-MiniLM-L6-dot-v1": 384,
        "sentence-transformers/multi-qa-mpnet-base-cos-v1": 768,
        "sentence-transformers/multi-qa-mpnet-base-dot-v1": 768,
        "sentence-transformers/multi-qa-distilbert-cos-v1": 768,
        "sentence-transformers/multi-qa-distilbert-dot-v1": 768,
        "sentence-transformers/paraphrase-multilingual-MiniLM-L12-v2": 384,
        "sentence-transformers/paraphrase-multilingual-mpnet-base-v2": 768,
        "sentence-transformers/paraphrase-MiniLM-L3-v2": 384,
        "sentence-transformers/paraphrase-MiniLM-L6-v2": 384,
        "sentence-transformers/paraphrase-albert-small-v2": 768,
        "sentence-transformers/msmarco-MiniLM-L6-cos-v5": 384,
        "sentence-transformers/msmarco-MiniLM-L12-cos-v5": 384,
        "sentence-transformers/msmarco-distilbert-cos-v5": 768,
        "sentence-transformers/msmarco-distilbert-base-tas-b": 768,
        "sentence-transformers/stsb-xlm-r-multilingual": 768,
        "sentence-transformers/distiluse-base-multilingual-cased-v1": 512,
        "sentence-transformers/distiluse-base-multilingual-cased-v2": 512,
        "flax-sentence-embeddings/all_datasets_v3_MiniLM-L12": 384,
        "flax-sentence-embeddings/all_datasets_v4_MiniLM-L12": 384,
        "flax-sentence-embeddings/all_datasets_v3_MiniLM-L6": 384,
        "flax-sentence-embeddings/all_datasets_v4_MiniLM-L6": 384,
        "flax-sentence-embeddings/all_datasets_v3_mpnet-base": 768,
        "flax-sentence-embeddings/all_datasets_v4_mpnet-base": 768,
    }
    out = {}
    for name, dims in names.items():
        out[name] = _hf(name, dims, 128, pooling="mean", model_type="sbert")
        # reference also registers these without the org prefix
        short = name.split("/", 1)[1]
        out[short] = dict(out[name])
    return out


def _openai_clip_models() -> Dict[str, dict]:
    return {
        "RN50": _clip("RN50", 1024),
        "RN101": _clip("RN101", 512),
        "RN50x4": _clip("RN50x4", 640, 288),
        "RN50x16": _clip("RN50x16", 768, 384),
        "RN50x64": _clip("RN50x64", 1024, 448),
        "ViT-B/32": _clip("ViT-B/32", 512),
        "ViT-B/16": _clip("ViT-B/16", 512),
        "ViT-L/14": _clip("ViT-L/14", 768),
        "ViT-L/14@336px": _clip("ViT-L/14@336px", 768, 336),
    }


def _open_clip_models() -> Dict[str, dict]:
    entries = [
        ("ViT-B-32", "laion400m_e31", 512, 224),
        ("ViT-B-32", "laion400m_e32", 512, 224),
        ("ViT-B-32", "laion2b_e16", 512, 224),
        ("ViT-B-32", "laion2b_s34b_b79k", 512, 224),
        ("ViT-B-16", "laion400m_e31", 512, 224),
        ("ViT-B-16", "laion400m_e32", 512, 224),
        ("ViT-B-16", "laion2b_s34b_b88k", 512, 224),
        ("ViT-L-14", "laion400m_e31", 768, 224),
        ("ViT-L-14", "laion400m_e32", 768, 224),
        ("ViT-L-14", "laion2b_s32b_b82k", 768, 224),
        ("ViT-L-14-336", "openai", 768, 336),
        ("ViT-H-14", "laion2b_s32b_b79k", 1024, 224),
        ("ViT-g-14", "laion2b_s12b_b42k", 1024, 224),
        ("ViT-g-14", "laion2b_s34b_b88k", 1024, 224),
        ("ViT-bigG-14", "laion2b_s39b_b160k", 1280, 224),
        ("roberta-ViT-B-32", "laion2b_s12b_b32k", 512, 224),
        ("xlm-roberta-base-ViT-B-32", "laion5b_s13b_b90k", 512, 224),
        ("xlm-roberta-large-ViT-H-14", "frozen_laion5b_s13b_b90k", 1024, 224),
        ("coca_ViT-B-32", "laion2b_s13b_b90k", 512, 224),
        ("coca_ViT-L-14", "laion2b_s13b_b90k", 768, 224),
        ("ViT-B-32-quickgelu", "laion400m_e31", 512, 224),
        ("ViT-B-32-quickgelu", "laion400m_e32", 512, 224),
        ("ViT-B-32-quickgelu", "openai", 512, 224),
        ("ViT-B-16-plus-240", "laion400m_e31", 640, 240),
        ("ViT-B-16-plus-240", "laion400m_e32", 640, 240),
        ("ViT-B-16-quickgelu", "openai", 512, 224),
        ("ViT-L-14", "openai", 768, 224),
        ("ViT-L-14-quickgelu", "openai", 768, 224),
        ("RN50", "openai", 1024, 224),
        ("RN50", "yfcc15m", 1024, 224),
        ("RN50", "cc12m", 1024, 224),
        ("RN50-quickgelu", "openai", 1024, 224),
        ("RN101", "openai", 512, 224),
        ("RN101", "yfcc15m", 512, 224),
        ("RN50x4", "openai", 640, 288),
        ("RN50x16", "openai", 768, 384),
        ("RN50x64", "openai", 1024, 448),
        ("convnext_base", "laion400m_s13b_b51k", 512, 224),
        ("convnext_base_w", "laion2b_s13b_b82k", 640, 256),
        ("convnext_large_d", "laion2b_s26b_b102k_augreg", 768, 256),
        ("convnext_xxlarge", "laion2b_s34b_b82k_augreg", 1024, 256),
        ("EVA02-B-16", "merged2b_s8b_b131k", 512, 224),
        ("EVA02-L-14", "merged2b_s4b_b131k", 768, 224),
        ("EVA02-L-14-336", "merged2b_s6b_b61k", 768, 336),
        ("ViT-SO400M-14-SigLIP", "webli", 1152, 224),
        ("ViT-SO400M-14-SigLIP-384", "webli", 1152, 384),
        ("ViT-B-16-SigLIP", "webli", 768, 224),
        ("ViT-B-16-SigLIP-256", "webli", 768, 256),
        ("ViT-B-16-SigLIP-384", "webli", 768, 384),
        ("ViT-B-16-SigLIP-512", "webli", 768, 512),
        ("ViT-L-16-SigLIP-256", "webli", 1024, 256),
        ("ViT-L-16-SigLIP-384", "webli", 1024, 384),
        # remaining reference long tail (model_registry.py open_clip section)
        ("ViT-B-32", "openai", 512, 224),
        ("ViT-B-16", "openai", 512, 224),
        ("ViT-B-32-256", "datacomp_s34b_b86k", 512, 256),
        ("ViT-B-16-quickgelu", "metaclip_fullcc", 512, 224),
        ("ViT-L-14-quickgelu", "dfn2b", 768, 224),
        ("ViT-L-14-CLIPA-336", "datacomp1b", 768, 336),
        ("ViT-H-14-quickgelu", "dfn5b", 1024, 224),
        ("ViT-H-14-378-quickgelu", "dfn5b", 1024, 378),
        ("RN50-quickgelu", "yfcc15m", 1024, 224),
        ("RN50-quickgelu", "cc12m", 1024, 224),
        ("RN101-quickgelu", "openai", 512, 224),
        ("RN101-quickgelu", "yfcc15m", 512, 224),
        ("coca_ViT-B-32", "mscoco_finetuned_laion2b_s13b_b90k", 512, 224),
        ("coca_ViT-L-14", "mscoco_finetuned_laion2b_s13b_b90k", 768, 224),
        ("convnext_base_w", "laion2b_s13b_b82k_augreg", 640, 256),
        ("convnext_base_w", "laion_aesthetic_s13b_b82k", 640, 256),
        ("convnext_base_w_320", "laion_aesthetic_s13b_b82k", 640, 320),
        ("convnext_base_w_320", "laion_aesthetic_s13b_b82k_augreg", 640, 320),
        ("convnext_large_d_320", "laion2b_s29b_b131k_ft", 768, 320),
        ("convnext_large_d_320", "laion2b_s29b_b131k_ft_soup", 768, 320),
        ("convnext_xxlarge", "laion2b_s34b_b82k_augreg_rewind", 1024, 256),
        ("convnext_xxlarge", "laion2b_s34b_b82k_augreg_soup", 1024, 256),
    ]
    out = {}
    for arch, pretrained, dims, size in entries:
        key = f"open_clip/{arch}/{pretrained}"
        out[key] = _open_clip(key, dims, pretrained, size)
    # Marqo fine-tunes from the reference registry
    out["Marqo/marqo-fashionCLIP"] = _open_clip(
        "Marqo/marqo-fashionCLIP", 512, "marqo", 224)
    out["Marqo/marqo-fashionSigLIP"] = _open_clip(
        "Marqo/marqo-fashionSigLIP", 768, "marqo", 224)
    # NLLB multilingual SigLIP family (reference model_registry.py:510-533;
    # registered as open_clip hf-hub checkpoints)
    for short, dims in [("nllb-clip-base-siglip", 768),
                        ("nllb-siglip-mrl-base", 768),
                        ("nllb-clip-large-siglip", 1152),
                        ("nllb-siglip-mrl-large", 1152)]:
        out[f"visheratin/{short}"] = {
            "name": f"hf-hub:visheratin/{short}", "dimensions": dims,
            "type": "open_clip", "image_size": 384,
            "note": "A multilingual CLIP model"}
    return out


def _fp16_clip_models() -> Dict[str, dict]:
    """Reference fp16-CLIP variants (clip_utils.py:495 FP16_CLIP). On TPU
    all CLIP towers already run bf16; these aliases keep old index settings
    loadable."""
    out = {}
    for name, dims, size in [("ViT-B/32", 512, 224), ("ViT-B/16", 512, 224),
                             ("ViT-L/14", 768, 224)]:
        out[f"fp16/{name}"] = {"name": name, "dimensions": dims,
                               "type": "fp16_clip", "image_size": size,
                               "notes": "fp16-alias of the CLIP model"}
    return out


def _onnx_alias_models() -> Dict[str, dict]:
    """Reference ONNX variants (onnx_clip_utils.py, sbert_onnx_utils.py —
    64 onnx-CLIP + 10 sbert-onnx entries) — alternative runtimes of the
    same checkpoints. They resolve to the native implementations (the
    runtime IS the accelerator-native one)."""
    out = {}
    # exact reference onnx-CLIP name set (model_registry.py onnx sections):
    # onnx{16,32}/open_clip/<arch>/<pretrained> for these 31 combos, plus
    # onnx{16,32}/openai/ViT-L/14
    combos = [
        "RN101-quickgelu/openai", "RN101-quickgelu/yfcc15m",
        "RN101/openai", "RN101/yfcc15m",
        "RN50-quickgelu/cc12m", "RN50-quickgelu/openai",
        "RN50-quickgelu/yfcc15m",
        "RN50/cc12m", "RN50/openai", "RN50/yfcc15m",
        "RN50x16/openai", "RN50x4/openai", "RN50x64/openai",
        "ViT-B-16-plus-240/laion400m_e31", "ViT-B-16-plus-240/laion400m_e32",
        "ViT-B-16/laion400m_e31", "ViT-B-16/laion400m_e32",
        "ViT-B-16/openai",
        "ViT-B-32-quickgelu/laion400m_e31",
        "ViT-B-32-quickgelu/laion400m_e32", "ViT-B-32-quickgelu/openai",
        "ViT-B-32/laion2b_e16", "ViT-B-32/laion400m_e31",
        "ViT-B-32/laion400m_e32", "ViT-B-32/openai",
        "ViT-H-14/laion2b_s32b_b79k",
        "ViT-L-14-336/openai", "ViT-L-14/laion2b_s32b_b82k",
        "ViT-L-14/laion400m_e32", "ViT-L-14/openai",
        "ViT-g-14/laion2b_s12b_b42k",
    ]
    arch_dims = {
        "RN50": (1024, 224), "RN50-quickgelu": (1024, 224),
        "RN101": (512, 224), "RN101-quickgelu": (512, 224),
        "RN50x4": (640, 288), "RN50x16": (768, 384),
        "RN50x64": (1024, 448),
        "ViT-B-32": (512, 224), "ViT-B-32-quickgelu": (512, 224),
        "ViT-B-16": (512, 224), "ViT-B-16-plus-240": (640, 240),
        "ViT-L-14": (768, 224), "ViT-L-14-336": (768, 336),
        "ViT-H-14": (1024, 224), "ViT-g-14": (1024, 224),
    }
    for combo in combos:
        arch = combo.split("/", 1)[0]
        dims, size = arch_dims[arch]
        for prefix in ("onnx16", "onnx32"):
            key = f"{prefix}/open_clip/{combo}"
            out[key] = {
                "name": f"open_clip/{combo}", "dimensions": dims,
                "type": "open_clip", "image_size": size,
                "pretrained": combo.split("/", 1)[1],
                "notes": "ONNX-named alias; served by the native CLIP runtime"}
    for prefix in ("onnx16", "onnx32"):
        out[f"{prefix}/openai/ViT-L/14"] = {
            "name": "ViT-L/14", "dimensions": 768, "type": "clip",
            "image_size": 224,
            "notes": "ONNX-named alias; served by the native CLIP runtime"}
    for name, dims in [("onnx/all-MiniLM-L6-v1", 384),
                       ("onnx/all-MiniLM-L6-v2", 384),
                       ("onnx/all-MiniLM-L12-v2", 384),
                       ("onnx/all-mpnet-base-v1", 768),
                       ("onnx/all-mpnet-base-v2", 768),
                       ("onnx/all-distilroberta-v1", 768),
                       ("onnx/multi-qa-MiniLM-L6-cos-v1", 384),
                       ("onnx/multi-qa-mpnet-base-cos-v1", 768),
                       ("onnx/all_datasets_v3_MiniLM-L6", 384),
                       ("onnx/all_datasets_v4_MiniLM-L6", 384),
                       ("onnx/all_datasets_v3_MiniLM-L12", 384),
                       ("onnx/all_datasets_v4_MiniLM-L12", 384),
                       ("onnx/all_datasets_v3_mpnet-base", 768),
                       ("onnx/all_datasets_v4_mpnet-base", 768)]:
        base = name.split("/", 1)[1]
        prefix = ("flax-sentence-embeddings/" if base.startswith("all_datasets")
                  else "sentence-transformers/")
        out[name] = _hf(prefix + base, dims, 128, model_type="sbert")
    return out


def _multilingual_clip_models() -> Dict[str, dict]:
    return {
        "multilingual-clip/XLM-Roberta-Large-Vit-L-14":
            {"name": "multilingual-clip/XLM-Roberta-Large-Vit-L-14",
             "dimensions": 768, "type": "multilingual_clip", "image_size": 224},
        "multilingual-clip/XLM-R Large Vit-B/32":
            {"name": "multilingual-clip/XLM-R Large Vit-B/32",
             "dimensions": 512, "type": "multilingual_clip", "image_size": 224},
        "multilingual-clip/XLM-R Large Vit-B/16+":
            {"name": "multilingual-clip/XLM-R Large Vit-B/16+",
             "dimensions": 640, "type": "multilingual_clip", "image_size": 240},
    }


def _languagebind_models() -> Dict[str, dict]:
    # A/V/image/text multimodal family (reference s2_inference/languagebind/).
    out = {}
    for key, modalities in [
        ("LanguageBind/Video_V1.5_FT_Audio_FT_Image", ["video", "audio", "image"]),
        ("LanguageBind/Video_V1.5_FT_Audio_FT", ["video", "audio"]),
        ("LanguageBind/Video_V1.5_FT_Image", ["video", "image"]),
        ("LanguageBind/Audio_FT_Image", ["audio", "image"]),
        ("LanguageBind/Audio_FT", ["audio"]),
        ("LanguageBind/Video_V1.5_FT", ["video"]),
    ]:
        out[key] = {"name": key, "dimensions": 768, "type": "languagebind",
                    "supported_modalities": modalities + ["language"]}
    return out


def _special_models() -> Dict[str, dict]:
    return {
        # deterministic random vectors, orchestration tests
        # (reference model_registry.py:2094)
        "random": {"name": "random", "dimensions": 384, "tokens": 128,
                   "type": "random"},
        "random/small": {"name": "random/small", "dimensions": 32,
                         "tokens": 128, "type": "random"},
        "random/medium": {"name": "random/medium", "dimensions": 128,
                          "tokens": 128, "type": "random"},
        "random/large": {"name": "random/large", "dimensions": 768,
                         "tokens": 128, "type": "random"},
        # tiny REAL torch encoder (runs the full device path at test scale)
        "test": {"name": "test", "dimensions": 16, "tokens": 128,
                 "type": "test"},
        "test/tiny-bert": {"name": "test/tiny-bert", "dimensions": 16,
                           "tokens": 128, "type": "test"},
        # reference test aliases (model_registry.py test section)
        "sentence-transformers/test": {
            "name": "sentence-transformers/all-MiniLM-L6-v1",
            "dimensions": 16, "tokens": 128, "type": "test", "notes": ""},
        "test_prefix": {
            "name": "sentence-transformers/all-MiniLM-L6-v1",
            "dimensions": 16, "tokens": 128, "type": "test",
            "text_query_prefix": "test query: ",
            "text_chunk_prefix": "test passage: ", "notes": ""},
        # no_model: storage-only indexes, custom vectors
        # (reference no_model_utils.py)
        "no_model": {"name": "no_model", "type": "no_model"},
    }


_REGISTRY: Optional[Dict[str, dict]] = None


def load_model_properties() -> Dict[str, dict]:
    """Full registry (reference model_registry.py:2147 load_model_properties)."""
    global _REGISTRY
    if _REGISTRY is None:
        reg = {}
        reg.update(_hf_models())
        reg.update(_sbert_models())
        reg.update(_openai_clip_models())
        reg.update(_open_clip_models())
        reg.update(_fp16_clip_models())
        reg.update(_onnx_alias_models())
        reg.update(_multilingual_clip_models())
        reg.update(_languagebind_models())
        reg.update(_special_models())
        _REGISTRY = reg
    return _REGISTRY


def get_model_properties_from_registry(model_name: str) -> dict:
    registry = load_model_properties()
    if model_name not in registry:
        from marqo_tpu_torch.core.exceptions import ModelError
        from marqo_tpu_torch import marqo_docs
        raise ModelError(
            f"Could not find model properties in model registry for model="
            f"{model_name}. Model is not supported by default. Please provide "
            f"model_properties or choose a model from the registry: "
            f"{marqo_docs.list_of_models()}")
    return registry[model_name]
