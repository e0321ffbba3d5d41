"""Cross-encoder reranker in PyTorch (port of marqo_tpu/models/cross_encoder.py).

Parity: reference s2_inference/reranking/cross_encoders.py ReRankerText —
HF cross-encoders (ms-marco MiniLM/TinyBERT family) scoring (query, text)
pairs; results re-sorted by the new score (rerank.rerank_search_results,
reranking/rerank.py:12-54 overwrites _score in place).

Architecture: the BERT-family encoder (models/bert.py, attention in kernel
B1's padding mode on a CUDA device) + pooler (dense + tanh over CLS) +
single-logit classification head — the BertForSequenceClassification
scoring graph. As in the JAX package, the pooler and head weights are held
in the compute dtype and their math runs in fp32, and positions carry no
``position_offset``. The JAX package jits ``cross_encoder_scores`` once per
(batch bucket, sequence bucket); on CUDA ``TorchCrossEncoder`` replays one
CUDA graph per such key (inference/graphs.py), captured at its first use.
"""

import hashlib
from dataclasses import replace
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.core.exceptions import ModelLoadError
from marqo_tpu_torch.inference import batching
from marqo_tpu_torch.inference.batching import (pick_batch_bucket,
                                                pick_seq_bucket)
from marqo_tpu_torch.inference.graphs import EncoderGraphs
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.models import bert
from marqo_tpu_torch.models.bert import TextEncoder, TextEncoderConfig
from marqo_tpu_torch.models.tokenizer import TextTokenizer


def _no_pool_config(config: TextEncoderConfig) -> TextEncoderConfig:
    return replace(config, pooling="cls", normalize=False)


class CrossEncoder(nn.Module):
    """Encoder + pooler + classifier; the module's dtype is the compute
    dtype."""

    def __init__(self, encoder: TextEncoder, pooler: nn.Linear,
                 classifier: nn.Linear):
        super().__init__()
        self.encoder = encoder
        self.pooler = pooler
        self.classifier = classifier

    @property
    def config(self) -> TextEncoderConfig:
        return self.encoder.config


def cross_encoder_scores(model: CrossEncoder, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor,
                         token_type_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) pair encodings → (B,) fp32 relevance logits."""
    encoder = model.encoder
    input_ids = input_ids.long()
    positions = torch.arange(input_ids.shape[1], device=input_ids.device)
    x = encoder.embeddings(input_ids, positions[None, :],
                           token_type_ids.long())
    x = encoder.run_layers(x, "padding", attention_mask)
    cls = x[:, 0, :].float()
    pooled = torch.tanh(cls @ model.pooler.weight.float().T +
                        model.pooler.bias.float())
    logits = pooled @ model.classifier.weight.float().T + \
        model.classifier.bias.float()
    return logits[:, 0]


def _assemble(encoder: TextEncoder, pooler_w, pooler_b, classifier_w,
              classifier_b, dtype, device) -> CrossEncoder:
    return CrossEncoder(
        encoder, bert.linear_layer(pooler_w, pooler_b, dtype, device),
        bert.linear_layer(classifier_w, classifier_b, dtype, device))


def init_cross_encoder(config: TextEncoderConfig,
                       generator: torch.Generator, dtype=torch.float32,
                       device="cuda") -> CrossEncoder:
    """Random-init model: the encoder as models/bert.py ``init_encoder``,
    the pooler and classifier normal(0, 0.05) with zero biases, drawn from
    ``generator`` on ``device``."""
    encoder = bert.init_encoder(config, generator, dtype=dtype,
                                device=device)
    H = config.hidden_size

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * 0.05

    return _assemble(encoder, normal(H, H), torch.zeros(H), normal(1, H),
                     torch.zeros(1), dtype, device)


def params_from_torch_state_dict(state_dict, config: TextEncoderConfig,
                                 dtype=torch.float32,
                                 device="cuda") -> CrossEncoder:
    """A model holding an HF BertForSequenceClassification ``state_dict``
    (``bert.*`` encoder keys, ``bert.pooler.dense``, ``classifier``)."""
    encoder = bert.params_from_torch_state_dict(state_dict, config,
                                                dtype=dtype, device=device)
    return _assemble(encoder, state_dict["bert.pooler.dense.weight"],
                     state_dict["bert.pooler.dense.bias"],
                     state_dict["classifier.weight"],
                     state_dict["classifier.bias"], dtype, device)


def params_from_jax(params_numpy: dict, config: TextEncoderConfig,
                    dtype=torch.float32, device="cuda") -> CrossEncoder:
    """A model holding marqo_tpu's cross-encoder pytree, given as numpy
    arrays ({"encoder": bert pytree, "pooler_w": (H, H), "pooler_b",
    "classifier_w": (H, 1), "classifier_b"}; (in, out) weights
    transpose)."""
    encoder = bert.params_from_jax(params_numpy["encoder"], config,
                                   dtype=dtype, device=device)
    return _assemble(encoder, np.asarray(params_numpy["pooler_w"]).T,
                     params_numpy["pooler_b"],
                     np.asarray(params_numpy["classifier_w"]).T,
                     params_numpy["classifier_b"], dtype, device)


class TorchCrossEncoder:
    """Reranker model wrapper (loads from HF hub / local dir / random-init
    for tests). On CUDA each (batch bucket, sequence bucket) replays one
    CUDA graph of ``cross_encoder_scores``, captured at its first use."""

    compute_dtype = torch.bfloat16

    def __init__(self, model_name: str, device: Device = Device.CUDA,
                 properties: Optional[dict] = None):
        self.model_name = model_name
        self.device = device
        self.properties = dict(properties or {})
        self.config: Optional[TextEncoderConfig] = None
        self.model: Optional[CrossEncoder] = None
        self.tokenizer: Optional[TextTokenizer] = None
        self._device = torch.device(
            "cuda" if device == Device.CUDA else "cpu")
        self.graphs = EncoderGraphs(self._device)

    def load(self) -> None:
        if self.properties.get("random_init"):
            self._load_random_init()
            return
        try:
            from transformers import (AutoConfig,
                                      AutoModelForSequenceClassification)
            repo = self.properties.get("name", self.model_name)
            hf_config = AutoConfig.from_pretrained(repo)
            self.config = _no_pool_config(bert.config_from_hf(hf_config))
            bert.check_kernel_shapes(self.config, self._device)
            torch_model = AutoModelForSequenceClassification.from_pretrained(
                repo)
            self.model = params_from_torch_state_dict(
                torch_model.state_dict(), self.config,
                dtype=self.compute_dtype, device=self._device)
            del torch_model
            self.tokenizer = TextTokenizer.from_pretrained(repo, max_length=512)
        except Exception as e:
            raise ModelLoadError(
                f"Could not load cross-encoder `{self.model_name}`: {e}. "
                f"If running offline, pass properties.random_init for tests.",
                cause=e)

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        self.config = _no_pool_config(TextEncoderConfig(
            vocab_size=int(arch.get("vocab_size", 128)),
            hidden_size=int(arch.get("hidden_size", 16)),
            num_layers=int(arch.get("num_layers", 2)),
            num_heads=int(arch.get("num_heads", 2)),
            intermediate_size=int(arch.get("intermediate_size", 32)),
        ))
        bert.check_kernel_shapes(self.config, self._device)
        seed = int.from_bytes(
            hashlib.sha256(self.model_name.encode()).digest()[:4], "little")
        generator = torch.Generator(device=self._device).manual_seed(seed)
        self.model = init_cross_encoder(self.config, generator,
                                        dtype=self.compute_dtype,
                                        device=self._device)
        self.tokenizer = TextTokenizer.build_test_wordpiece(max_length=128)

    def score(self, query: str, texts: List[str]) -> np.ndarray:
        """Relevance logits for (query, text) pairs."""
        if not texts:
            return np.zeros((0,), dtype=np.float32)
        pairs = self.tokenizer.encode_pairs(
            [query] * len(texts), texts,
            pad_to=pick_seq_bucket(min(
                self.tokenizer.max_length,
                self.tokenizer.max_pair_length([query] * len(texts), texts))))
        n = len(texts)
        bucket = pick_batch_bucket(n)
        out = []
        start = 0
        while start < n:
            size = min(bucket, n - start)
            shape = (bucket, pairs["input_ids"].shape[1])
            ids = np.zeros(shape, dtype=np.int32)
            mask = np.zeros(shape, dtype=np.int32)
            types = np.zeros(shape, dtype=np.int32)
            ids[:size] = pairs["input_ids"][start:start + size]
            mask[:size] = pairs["attention_mask"][start:start + size]
            types[:size] = pairs["token_type_ids"][start:start + size]
            mask[size:, 0] = 1
            out.append(self.scores(ids, mask, types)[:size])
            start += size
        # one device-to-host copy after all launches
        with torch.inference_mode():
            return torch.cat(out).cpu().numpy().astype(np.float32)

    def scores(self, ids: np.ndarray, mask: np.ndarray,
               types: np.ndarray) -> torch.Tensor:
        """One bucket's (B, S) int32 pair ids, mask and token types → (B,)
        fp32 logits on the device: on CUDA the replay of this reranker's
        graph of (B, S), captured at its first use; on the CPU the eager
        forward."""
        model = self.model
        graphs = batching.card_graphs(self.graphs)
        if graphs is None:
            with torch.inference_mode():
                return cross_encoder_scores(
                    model, *(torch.from_numpy(a).to(self._device)
                             for a in (ids, mask, types)))
        return graphs.run(
            "scores", model.pooler.weight.dtype,
            lambda *arrays: cross_encoder_scores(model, *arrays),
            ids, mask, types, static=(model.config,))
