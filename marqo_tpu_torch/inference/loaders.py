"""Embedding-model classes (port of marqo_tpu/inference/loaders.py; roles of
the reference's model wrappers clip_utils.py / hugging_face_model.py /
sbert_utils.py / random_utils.py / no_model_utils.py).

Every model exposes:
  load()                       — materialize weights on the target device
  encode(contents, normalize)  — list of content → (n, dims) float32 numpy
  memory_bytes()               — device footprint for cache eviction

Multi-device serving (parallel/serving.py): when the process serving mesh
spans a model's device, ``load`` places a replica of its module on each
data-parallel group (the float BERT encoder split over the group's tp
devices), and every encode batch splits across the groups; without a mesh
a model runs on its one device, where on CUDA the BERT-family text
encoder and the towers of the CLIP family (ViT, HF-text, ResNet,
ConvNeXt, SigLIP, NLLB-SigLIP, CoCa, EVA02) replay one CUDA graph per
bucket (inference/graphs.py), and so do Stella and the DeepSeek-V2
decoder embedder; LanguageBind replays its towers' graphs on its one
device under a mesh too. Served: the BERT-family text encoder (bf16, or
int8 W8A8 with ``quantize``), DeepSeek-V2 (type ``hf`` on a
``deepseek_v2`` checkpoint), Stella (``hf_stella``), the ViT CLIP towers
(models/clip.py), the HF-text CLIP composites (models/hf_clip.py), SigLIP,
ResNet-CLIP, ConvNeXt-CLIP, NLLB-SigLIP, CoCa, EVA02-CLIP and LanguageBind:
every registry entry.
"""

import hashlib
import os
from abc import ABC, abstractmethod
from typing import Any, List, Optional

import numpy as np
import torch

from marqo_tpu_torch.api import telemetry
from marqo_tpu_torch.core.exceptions import (InvalidArgumentError,
                                             ModelLoadError, VectoriseError)
from marqo_tpu_torch.inference.batching import (batch_buckets, graphs_for,
                                                pick_batch_bucket,
                                                pick_seq_bucket, row_buckets)
from marqo_tpu_torch.inference.graphs import EncoderGraphs
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.logging import get_logger
from marqo_tpu_torch.models.bert import (TextEncoder, TextEncoderConfig,
                                         check_kernel_shapes, config_from_hf,
                                         encode_tokens, encode_tokens_packed,
                                         init_encoder, packed_segment_sums,
                                         params_from_torch_state_dict,
                                         pool_segment_sums)
from marqo_tpu_torch.models import deepseek_v2
from marqo_tpu_torch.models.stella import \
    encode_tokens as stella_encode_tokens
from marqo_tpu_torch.models.tokenizer import TextTokenizer
from marqo_tpu_torch.parallel.serving import (map_data_parallel, model_mesh,
                                              put_params, round_up_to_dp,
                                              run_data_parallel)

logger = get_logger(__name__)


class EmbeddingModel(ABC):
    """Base model wrapper (role of reference AbstractEmbeddingModel,
    core/inference/embedding_models/abstract_embedding_model.py)."""

    def __init__(self, model_name: str, properties: dict, device: Device,
                 model_auth: Optional[Any] = None):
        self.model_name = model_name
        self.properties = dict(properties or {})
        self.device = device
        self.model_auth = model_auth
        self.loaded = False

    @property
    def dimensions(self) -> int:
        return int(self.properties.get("dimensions", 0))

    @abstractmethod
    def load(self) -> None:
        ...

    @abstractmethod
    def encode(self, contents: List[Any], normalize: bool = True,
               modality: Modality = Modality.TEXT) -> np.ndarray:
        ...

    def memory_bytes(self) -> int:
        return 0


class TorchHFTextModel(EmbeddingModel):
    """BERT/RoBERTa-family text encoder (replaces reference
    HuggingFaceModel, hugging_face_model.py:24, and SBERT wrapper).

    Checkpoint sources, in order:
      1. ``model_properties["localpath"]`` — local HF-format directory
      2. the HF hub via transformers (when cached / network available)
      3. deterministic random-init when ``model_properties["random_init"]``
         is set (test/bench mode: identical compute graph, synthetic weights)
    """

    compute_dtype = torch.bfloat16
    # the padded forward, ``(encoder, ids, mask) -> pooled``
    encode_tokens = staticmethod(encode_tokens)

    def __init__(self, model_name, properties, device, model_auth=None):
        super().__init__(model_name, properties, device, model_auth)
        self.config: Optional[TextEncoderConfig] = None
        self.encoder: Optional[TextEncoder] = None
        self.tokenizer: Optional[TextTokenizer] = None
        self._device = torch.device(
            "cuda" if device == Device.CUDA else "cpu")
        self._param_bytes = 0
        self.graphs = EncoderGraphs(self._device)

    # --- loading ---------------------------------------------------------

    def _hf_repo(self) -> str:
        return self.properties.get("name", self.model_name)

    def load(self) -> None:
        self._validate_properties()
        max_len = int(self.properties.get("tokens", 128))
        localpath = self._checkpoint_dir()
        if localpath:
            self._load_from_dir(localpath, max_len)
        elif self.properties.get("random_init"):
            self._load_random_init(max_len)
        else:
            try:
                self._load_from_hub(self._hf_repo(), max_len)
            except Exception as e:
                raise ModelLoadError(
                    f"Could not load model `{self.model_name}` from "
                    f"`{self._hf_repo()}`: {e}. If running offline, provide "
                    f"model_properties.localpath or a model_location.",
                    cause=e)
        self.encoder = put_params(self, self.encoder)
        self.loaded = True
        self._param_bytes = module_bytes(self.encoder)

    def _validate_properties(self) -> None:
        # validate custom model_properties through the reference-shaped
        # schema (hf_model_properties.py); resolves pooling inference and
        # camelCase aliases, and rejects url+model_location conflicts
        if self.properties.get("type") == "hf":
            import pydantic

            from marqo_tpu_torch.exceptions import InvalidArgumentError
            from marqo_tpu_torch.inference.hf_model_properties import \
                HuggingFaceModelProperties
            try:
                validated = HuggingFaceModelProperties(**self.properties)
            except pydantic.ValidationError as e:
                raise InvalidArgumentError(
                    f"Invalid model_properties for model "
                    f"`{self.model_name}`: {e}") from e
            if "pooling_method" not in self.properties and \
                    "poolingMethod" not in self.properties:
                self.properties["pooling_method"] = \
                    validated.pooling_method.value

    def _checkpoint_dir(self) -> Optional[str]:
        """The checkpoint's local directory: ``localpath``, or where a
        ``model_location`` or ``url`` was downloaded to; None where there
        is none."""
        localpath = self.properties.get("localpath")
        location = self.properties.get("model_location")
        if location and not localpath:
            # private checkpoint via s3/HF auth (reference ModelLocation)
            from marqo_tpu_torch.inference.model_download import (
                auth_for_location, download_model)
            localpath = download_model(
                repo_location=location,
                auth=auth_for_location(location, self.model_auth))
        elif self.properties.get("url") and not localpath:
            # public checkpoint URL (reference custom-model "url" flow,
            # model_download.py:102-140; zips extract to a directory)
            from marqo_tpu_torch.inference.model_download import \
                download_pretrained_from_url
            localpath = download_pretrained_from_url(self.properties["url"])
        return localpath

    def _pooling(self) -> str:
        return str(self.properties.get("pooling_method", "mean")).lower()

    def _load_from_dir(self, path: str, max_len: int) -> None:
        from transformers import AutoConfig
        hf_cfg = AutoConfig.from_pretrained(path)
        self.config = self._finalize_config(config_from_hf(hf_cfg))
        self.encoder = params_from_torch_state_dict(
            _load_state_dict(path), self.config, dtype=self.compute_dtype,
            device=self._device)
        self.tokenizer = TextTokenizer.from_pretrained(path, max_length=max_len)

    def _load_from_hub(self, repo: str, max_len: int) -> None:
        from transformers import AutoConfig, AutoModel
        hf_cfg = AutoConfig.from_pretrained(repo)
        self.config = self._finalize_config(config_from_hf(hf_cfg))
        torch_model = AutoModel.from_pretrained(repo)
        self.encoder = params_from_torch_state_dict(
            torch_model.state_dict(), self.config, dtype=self.compute_dtype,
            device=self._device)
        del torch_model
        self.tokenizer = TextTokenizer.from_pretrained(repo, max_length=max_len)

    def _load_random_init(self, max_len: int) -> None:
        """Deterministic synthetic weights with the real architecture."""
        arch = self.properties.get("architecture", {})
        self.config = self._finalize_config(TextEncoderConfig(
            vocab_size=int(arch.get("vocab_size", 30522)),
            hidden_size=int(arch.get("hidden_size", 768)),
            num_layers=int(arch.get("num_layers", 12)),
            num_heads=int(arch.get("num_heads", 12)),
            intermediate_size=int(arch.get("intermediate_size", 3072)),
        ))
        seed = int.from_bytes(
            hashlib.sha256(self.model_name.encode()).digest()[:4], "little")
        generator = torch.Generator(device=self._device).manual_seed(seed)
        self.encoder = init_encoder(self.config, generator,
                                    dtype=self.compute_dtype,
                                    device=self._device)
        self.tokenizer = TextTokenizer.build_test_wordpiece(max_length=max_len)

    def _finalize_config(self, config: TextEncoderConfig) -> TextEncoderConfig:
        """The served config; refused here, before any weights load, where
        no kernel takes its shapes on this model's device."""
        from dataclasses import replace
        config = replace(config, pooling=self._pooling(), normalize=False,
                         quantize=self._use_quantization())
        check_kernel_shapes(config, self._device)
        return config

    def _use_quantization(self) -> bool:
        """int8 W8A8 opt-in: model_properties.quantize or
        MARQO_TPU_QUANTIZE=int8 (ops/quant.py, kernel B3). The builders
        quantize the encoder after its cast to the compute dtype, at every
        load path, when the config says so."""
        if "quantize" in self.properties:
            return bool(self.properties["quantize"])
        from marqo_tpu_torch.api import configs
        return str(configs.read_env_vars_and_defaults("MARQO_TPU_QUANTIZE")
                   or "").lower() == "int8"

    # --- encoding --------------------------------------------------------

    # pack when real tokens fill less than this fraction of the padded grid
    PACKING_THRESHOLD = 0.75

    def encode(self, contents: List[Any], normalize: bool = True,
               modality: Modality = Modality.TEXT) -> np.ndarray:
        return self.encode_async(contents, normalize=normalize,
                                 modality=modality)()

    def encode_async(self, contents: List[Any], normalize: bool = True,
                     modality: Modality = Modality.TEXT):
        """Tokenize + launch every chunk NOW; the returned ``resolve()``
        performs the one device-to-host copy (+ normalize) for all of
        them. Launches are asynchronous, so the tokenization of chunk i+1
        overlaps the device's work on chunk i."""
        if modality != Modality.TEXT:
            raise VectoriseError(
                f"Model `{self.model_name}` only supports text content")
        texts = [c if isinstance(c, str) else str(c) for c in contents]
        if not texts:
            empty = np.zeros((0, self.dimensions or self.config.hidden_size),
                             dtype=np.float32)
            return lambda: empty
        # chunk-first: tokenize chunk i+1 while the device runs chunk i
        max_seqs = batch_buckets()[-1]
        pending = []  # (device tensor, n_valid)
        for start in range(0, len(texts), max_seqs):
            chunk = texts[start:start + max_seqs]
            with telemetry.span("inference.tokenize"):
                batch = self._tokenize(chunk)
            seq_bucket = batch["input_ids"].shape[1]
            n = len(chunk)
            density = sum(batch["lengths"]) / (n * seq_bucket)
            if n > 1 and density < self.PACKING_THRESHOLD:
                pending.extend(self._dispatch_packed(batch, seq_bucket))
            else:
                pending.extend(self._dispatch_padded(batch, seq_bucket, n))

        def resolve() -> np.ndarray:
            # ONE device-to-host copy for all pending outputs
            with telemetry.span("inference.device_wait"), \
                    torch.inference_mode():
                result = torch.cat([emb[:size] for emb, size in pending])
                result = result.cpu().numpy()
            with telemetry.span("inference.to_lists"):
                if normalize:
                    norms = np.linalg.norm(result, axis=-1, keepdims=True)
                    result = result / np.maximum(norms, 1e-12)
                return result.astype(np.float32, copy=False)

        return resolve

    def _tokenize(self, texts: List[str]) -> dict:
        """WordPiece ids and masks of ``texts``, padded to their sequence
        bucket."""
        batch = self.tokenizer.encode_batch(texts)
        seq_bucket = pick_seq_bucket(
            min(max(batch["lengths"]), self.tokenizer.max_length))
        width = batch["input_ids"].shape[1]
        if width < seq_bucket:
            pad = seq_bucket - width
            batch["input_ids"] = np.pad(
                batch["input_ids"], ((0, 0), (0, pad)),
                constant_values=self.tokenizer.pad_id)
            batch["attention_mask"] = np.pad(
                batch["attention_mask"], ((0, 0), (0, pad)))
        elif width > seq_bucket:  # can't happen (bucket ≥ max length)
            batch["input_ids"] = batch["input_ids"][:, :seq_bucket]
            batch["attention_mask"] = \
                batch["attention_mask"][:, :seq_bucket]
        return batch

    def _dispatch_padded(self, batch, seq_bucket: int, n: int):
        """Launch padded batches WITHOUT copying results back; encode()
        copies all outputs after all launches. Under a serving mesh the
        batch axis splits across dp, so the bucket rounds up to a dp
        multiple."""
        batch_bucket = round_up_to_dp(pick_batch_bucket(n), model_mesh(self))
        pending = []
        start = 0
        while start < n:
            size = min(batch_bucket, n - start)
            with telemetry.span("inference.pack"):
                ids = np.zeros((batch_bucket, seq_bucket), dtype=np.int32)
                mask = np.zeros((batch_bucket, seq_bucket), dtype=np.int32)
                ids[:size] = batch["input_ids"][start:start + size]
                mask[:size] = batch["attention_mask"][start:start + size]
                # pad rows must still be valid: give them one real token so
                # mean-pool denominators never hit zero
                mask[size:, 0] = 1
            pending.append((self._forward(ids, mask), size))
            start += size
        return pending

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """One padded device batch → pooled embeddings: on CUDA the replay
        of this model's graph of its (batch, seq) bucket (bf16, or int8 on
        B3 when quantized), captured at its first use or by ``warmup``;
        on the CPU and under a serving mesh the eager forward, split across
        the mesh's data-parallel groups when there is one."""
        with torch.inference_mode():
            graphs = graphs_for(self)
            if graphs is None:
                return run_data_parallel(self, self.encode_tokens, ids, mask)
            return graphs.run(
                "padded", self.compute_dtype,
                lambda ids, mask: self.encode_tokens(self.encoder, ids, mask),
                ids, mask, static=(self.encoder.config,))

    def _dispatch_packed(self, batch, seq_bucket: int):
        """Sequence-packed dispatch (ops/packing.py): ~1/density fewer rows
        through the encoder at identical numerics. Returns (device tensor,
        n_sequences) pairs without copying back — see _dispatch_padded.

        The pooled rows pad to ``n_bucket``, the batch bucket of the
        chunk's sequence count, as in the JAX package, where it is the
        compiled program's static ``num_sequences``: on CUDA the chunk
        replays this model's graph of (row bucket, seq bucket, n_bucket).
        Under a serving mesh the packed rows split across dp, so the row
        ladder rounds up to dp multiples; packing never splits a sequence
        across rows, so each group's pooling sums index the whole chunk's
        sequences, and their sum on the lead device is the chunk's."""
        from marqo_tpu_torch.ops.packing import pack_sequences

        ids, lengths = batch["input_ids"], batch["lengths"]
        max_seqs = batch_buckets()[-1]
        ladder = [round_up_to_dp(b, model_mesh(self)) for b in row_buckets()]
        pending = []
        for start in range(0, len(lengths), max_seqs):
            with telemetry.span("inference.pack"):
                packed = pack_sequences(
                    [ids[i, :lengths[i]] for i in
                     range(start, min(start + max_seqs, len(lengths)))],
                    seq_len=seq_bucket, pad_id=self.tokenizer.pad_id,
                    row_buckets=ladder)
            rows = (packed.input_ids, packed.segment_ids, packed.positions,
                    packed.seq_index)
            pending.append((self._packed(
                rows, pick_batch_bucket(packed.n_sequences)),
                packed.n_sequences))
        return pending

    def _packed(self, rows, n_bucket: int) -> torch.Tensor:
        """One packed chunk's host rows (input ids, segment ids, positions,
        sequence index) → (n_bucket, H) pooled embeddings: on CUDA the
        replay of this model's graph, else ``_packed_eager``."""
        with torch.inference_mode():
            graphs = graphs_for(self)
            if graphs is None:
                return self._packed_eager(rows, n_bucket)
            return graphs.run(
                "packed", self.compute_dtype,
                lambda *rows: encode_tokens_packed(self.encoder, *rows,
                                                   n_bucket),
                *rows, static=(self.encoder.config, n_bucket))

    def _packed_eager(self, rows, n_bucket: int) -> torch.Tensor:
        """The packed forward without a graph: each data-parallel group's
        pooling sums, added on the lead device, then pooled."""
        with torch.inference_mode():
            parts = map_data_parallel(
                self, lambda encoder, *rows: packed_segment_sums(
                    encoder, *rows, n_bucket), *rows)
            sums, counts = parts[0]
            for more_sums, more_counts in parts[1:]:
                sums, counts = sums + more_sums, counts + more_counts
            return pool_segment_sums(sums, counts, self.config)

    def memory_bytes(self) -> int:
        return self._param_bytes

    def warmup(self, shapes: Optional[List[List[int]]] = None) -> int:
        """Run the hot (batch, seq) buckets once through ``_forward`` (the
        int8 path too, when quantized), which on CUDA captures each
        bucket's graph, so serving latency never pays first-use costs
        (kernel build, library handles, capture; reference CacheModels runs
        timed warmup vectorise at startup, on_start_script.py:124-195).
        Returns #shapes run."""
        if shapes is None:
            from marqo_tpu_torch.api import configs
            raw = configs.read_env_vars_and_defaults("MARQO_TPU_WARMUP_SHAPES")
            if raw:
                import json as _json
                shapes = _json.loads(raw) if isinstance(raw, str) else raw
            else:
                # query path (batch 1, all seq buckets) + the ingest shape
                from marqo_tpu_torch.inference.batching import seq_buckets
                shapes = [[1, s] for s in seq_buckets()[:4]] + [[256, 128]]
        count = 0
        for batch, seq in shapes:
            seq = min(seq, self.tokenizer.max_length)
            batch = round_up_to_dp(batch, model_mesh(self))
            ids = np.zeros((batch, seq), dtype=np.int32)
            mask = np.ones((batch, seq), dtype=np.int32)
            self._forward(ids, mask)[:1, :1].cpu()
            count += 1
        return count


class TorchStellaModel(TorchHFTextModel):
    """Stella (GTE-v1.5 "NewModel" arch) text encoder — reference type
    `hf_stella` (HuggingFaceStellaModel, trust_remote_code). The arch
    lives in models/stella.py; weights load from a local checkpoint dir
    (`model_properties.localpath`, remote code can't be fetched offline)
    or random-init for tests. Packing is disabled: RoPE + the projection
    head use the plain padded path, which on CUDA replays the model's graph
    of each (batch, seq) bucket as the BERT family's does (the RoPE tables
    are built inside the forward, so the capture holds them)."""

    PACKING_THRESHOLD = -1.0  # never pack
    encode_tokens = staticmethod(stella_encode_tokens)

    def load(self) -> None:
        from marqo_tpu_torch.models.stella import (
            StellaConfig, init_stella, params_from_torch_state_dict,
            stella_400m_config)
        max_len = int(self.properties.get("tokens", 512))
        arch = self.properties.get("architecture", {})
        proj = int(self.properties.get("dimensions", 1024))
        if arch:
            self.config = StellaConfig(
                vocab_size=int(arch.get("vocab_size", 30528)),
                hidden_size=int(arch.get("hidden_size", 1024)),
                num_layers=int(arch.get("num_layers", 24)),
                num_heads=int(arch.get("num_heads", 16)),
                intermediate_size=int(arch.get("intermediate_size", 4096)),
                rope_theta=float(arch.get("rope_theta", 160000.0)),
                projection_dim=proj, normalize=False)
        else:
            from dataclasses import replace
            self.config = replace(stella_400m_config(proj), normalize=False)
        check_kernel_shapes(self.config, self._device)
        localpath = self.properties.get("localpath")
        if localpath:
            state_dict = _load_state_dict(localpath)
            head = None
            head_path = os.path.join(localpath, f"2_Dense_{proj}")
            if os.path.isdir(head_path):
                head_sd = _load_state_dict(head_path)
                head = {"weight": head_sd.get("linear.weight",
                                              head_sd.get("weight")),
                        "bias": head_sd.get("linear.bias",
                                            head_sd.get("bias"))}
            self.encoder = params_from_torch_state_dict(
                state_dict, self.config, dtype=self.compute_dtype,
                device=self._device, vector_linear=head)
            self.tokenizer = TextTokenizer.from_pretrained(
                localpath, max_length=max_len)
        elif self.properties.get("random_init"):
            seed = int.from_bytes(
                hashlib.sha256(self.model_name.encode()).digest()[:4],
                "little")
            generator = torch.Generator(device=self._device).manual_seed(seed)
            self.encoder = init_stella(self.config, generator,
                                       dtype=self.compute_dtype,
                                       device=self._device)
            self.tokenizer = TextTokenizer.build_test_wordpiece(
                max_length=max_len)
        else:
            raise ModelLoadError(
                f"Stella model `{self.model_name}` needs its checkpoint on "
                "disk: the architecture ships as hub remote code, which "
                "cannot be fetched in this offline environment. Provide "
                "model_properties.localpath (HF checkpoint directory, "
                "optionally with the 2_Dense_<dims> head).")
        self.encoder = put_params(self, self.encoder)
        self.loaded = True
        self._param_bytes = module_bytes(self.encoder)


class TorchDeepseekV2Model(TorchHFTextModel):
    """DeepSeek-V2 (``deepseek_v2``) as a mean-pooled text embedder: a
    decoder LLM served as Marqo serves any HF checkpoint, type ``hf`` with
    ``localpath``, which ``resolve_model_class`` sends here by the
    checkpoint's ``model_type`` (models/deepseek_v2.py). The checkpoint may
    be sharded (``model.safetensors.index.json``); each tensor is read and
    copied to the model's device on its own. Batches take the BERT family's
    path (tokenize, pack below ``PACKING_THRESHOLD``, one CUDA graph per
    key) with the decoder's forwards: B1's causal modes and the expert
    layer of ops/moe.py.

    Counters of a traced request (api/telemetry.py): ``moe.forwards``, the
    forwards it ran, each of which reads every expert's weights;
    ``moe.static_rows``, the routed rows those forwards' static buffers
    hold (token slots x top k x MoE layers); and
    ``moe.expert_tokens``, the tokens routed to routed experts, read from
    the model's device buffer at the request's device wait (after its one
    copy to the host, so an untraced request never waits for it), each
    (layer, expert)'s share logged with ``telemetry.record_counts``."""

    compute_dtype = torch.bfloat16
    encode_tokens = staticmethod(deepseek_v2.encode_tokens)

    def __init__(self, model_name, properties, device, model_auth=None):
        super().__init__(model_name, properties, device, model_auth)
        self._read_tokens = None  # the expert-token buffer at its last read

    def load(self) -> None:
        self._validate_properties()
        max_len = int(self.properties.get("tokens", 512))
        path = self._checkpoint_dir()
        if not path:
            raise ModelLoadError(
                f"Model `{self.model_name}`: a deepseek_v2 checkpoint loads "
                f"from a local directory (model_properties.localpath)")
        try:
            self.config = deepseek_v2.config_from_hf(read_hf_config(path))
        except ValueError as e:
            raise ModelLoadError(str(e), cause=e)
        check_decoder_shapes(self.config, max_len, self._device)
        if model_mesh(self) is not None:
            raise ModelLoadError(
                f"Model `{self.model_name}`: a deepseek_v2 model serves on "
                f"one device, not over a serving mesh")
        model = deepseek_v2.empty_model(self.config, self.compute_dtype,
                                        self._device)
        self.encoder = deepseek_v2.load_tensors(model,
                                                checkpoint_tensors(path))
        self.tokenizer = TextTokenizer.from_pretrained(path,
                                                       max_length=max_len)
        self.loaded = True
        self._param_bytes = module_bytes(self.encoder)

    def encode_async(self, contents: List[Any], normalize: bool = True,
                     modality: Modality = Modality.TEXT):
        resolve = super().encode_async(contents, normalize, modality)
        traced = telemetry.traced()
        if traced is None:
            return resolve

        def resolve_and_count() -> np.ndarray:
            result = resolve()
            tokens = self.encoder.expert_tokens.to("cpu", copy=True).numpy()
            read, self._read_tokens = self._read_tokens, tokens
            if read is not None:
                tokens = tokens - read
            traced.increment_counter("moe.expert_tokens", int(tokens.sum()))
            telemetry.record_counts(traced, "moe.expert_tokens", tokens)
            return result

        return resolve_and_count

    def _count_forward(self, slots: int) -> None:
        """A traced forward over ``slots`` static token slots: one
        ``moe.forwards``, and the routed rows its expert layers hold
        (``moe.static_rows``: slots x top k x MoE layers)."""
        traced = telemetry.traced()
        if traced is not None:
            c = self.encoder.config
            traced.increment_counter("moe.forwards")
            traced.increment_counter(
                "moe.static_rows",
                slots * c.num_experts_per_tok * c.moe_layers)

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        self._count_forward(ids.size)
        return super()._forward(ids, mask)

    def _packed(self, rows, n_bucket: int) -> torch.Tensor:
        """One packed chunk's rows through the decoder: on CUDA the replay
        of this model's graph of (row bucket, seq bucket, n_bucket), else
        the eager forward."""
        encode_tokens_packed = deepseek_v2.encode_tokens_packed
        self._count_forward(rows[0].size)
        with torch.inference_mode():
            graphs = graphs_for(self)
            if graphs is None:
                return encode_tokens_packed(
                    self.encoder, *(torch.from_numpy(r).to(self._device)
                                    for r in rows), n_bucket)
            return graphs.run(
                "packed", self.compute_dtype,
                lambda *rows: encode_tokens_packed(self.encoder, *rows,
                                                   n_bucket),
                *rows, static=(self.encoder.config, n_bucket))


def check_decoder_shapes(config, max_len: int, device) -> None:
    """Raise ModelLoadError where B1's causal modes do not take the model's
    latent attention on a CUDA device: (q/k, v) head dims outside
    ``CAUSAL_HEAD_DIMS`` or more tokens than ``MAX_SEQ_LEN``. The CPU runs
    every shape on the twins."""
    from marqo_tpu_torch.ops import flash_attention
    if torch.device(device).type != "cuda":
        return
    dims = (config.qk_head_dim, config.v_head_dim)
    if dims not in flash_attention.CAUSAL_HEAD_DIMS or \
            max_len > flash_attention.MAX_SEQ_LEN:
        raise ModelLoadError(
            f"deepseek_v2: (q/k, v) head dims {dims} and {max_len} tokens: "
            f"the causal attention kernel takes "
            f"{flash_attention.CAUSAL_HEAD_DIMS} and at most "
            f"{flash_attention.MAX_SEQ_LEN} tokens")


class TestModel(TorchHFTextModel):
    """Tiny real encoder for orchestration tests (reference ships
    `test`/sbert-test, model_registry.py:976): full device compute path,
    milliseconds to load."""

    def load(self) -> None:
        self.properties.setdefault("random_init", True)
        self.properties.setdefault("architecture", {
            "vocab_size": 128, "hidden_size": 16, "num_layers": 2,
            "num_heads": 2, "intermediate_size": 32,
        })
        self.properties.setdefault("dimensions", 16)
        super().load()


class RandomModel(EmbeddingModel):
    """Deterministic content-hash random vectors (reference
    s2_inference/random_utils.py): same content → same vector, no device work.
    """

    def load(self) -> None:
        self.loaded = True

    def encode(self, contents: List[Any], normalize: bool = True,
               modality: Modality = Modality.TEXT) -> np.ndarray:
        dims = self.dimensions or 384
        out = np.zeros((len(contents), dims), dtype=np.float32)
        for i, content in enumerate(contents):
            key = hashlib.sha256(
                repr(content).encode("utf-8", "ignore")).digest()
            seed = int.from_bytes(key[:8], "little") % (2 ** 31)
            rng = np.random.default_rng(seed)
            vec = rng.standard_normal(dims).astype(np.float32)
            out[i] = vec
        if normalize:
            out /= np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
        return out


class NoModel(EmbeddingModel):
    """Storage-only indexes / custom vectors (reference no_model_utils.py:
    vectorise must never be called)."""

    def load(self) -> None:
        self.loaded = True

    def encode(self, contents, normalize=True, modality=Modality.TEXT):
        raise VectoriseError(
            "Cannot vectorise anything with 'no_model'. This model is "
            "intended for adding documents and searching with custom vectors "
            "only. If vectorisation is needed, please use a different model ")


def module_bytes(module: torch.nn.Module) -> int:
    """Device footprint of a module: parameters and buffers (the int8
    weights and scales of a quantized encoder are buffers); the model cache
    evicts by it."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))


def read_hf_config(path: str) -> dict:
    """A checkpoint directory's config.json, or {} where it has none."""
    import json
    config = os.path.join(path, "config.json")
    if not os.path.isfile(config):
        return {}
    with open(config) as f:
        return json.load(f)


def checkpoint_tensors(path: str):
    """(name, read) for every tensor of an HF checkpoint directory's
    safetensors, in file order: the shards that
    ``model.safetensors.index.json`` names, else ``model.safetensors``.
    ``read()`` gives the one tensor on the host; nothing else of the file
    is held. A traced request's span ``inference.checkpoint_load`` covers
    each file."""
    from safetensors import safe_open
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.isfile(index):
        import json
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    elif os.path.isfile(os.path.join(path, "model.safetensors")):
        files = ["model.safetensors"]
    else:
        raise ModelLoadError(f"No safetensors weights found under `{path}`")
    for file in files:
        with telemetry.span("inference.checkpoint_load"), \
                safe_open(os.path.join(path, file), "pt") as f:
            for name in f.keys():
                yield name, (lambda f=f, name=name: f.get_tensor(name))


def _load_state_dict(path: str) -> dict:
    """Load torch weights from an HF-format directory (.safetensors or .bin)."""
    st_path = os.path.join(path, "model.safetensors")
    if os.path.isfile(st_path):
        from safetensors.torch import load_file
        return load_file(st_path)
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(bin_path):
        from marqo_tpu_torch.inference.checkpoint_load import \
            load_torch_checkpoint
        return load_torch_checkpoint(bin_path, family="hf")
    raise ModelLoadError(f"No model weights found under `{path}`")


def resolve_model_class(model_name: str, properties: dict):
    """Dispatch a registry entry to its model class WITHOUT loading
    weights (reference model_registry.py:2133-2145
    _get_model_load_mappings). Raises InvalidArgumentError for unknown
    types."""
    model_type = str(properties.get("type", "hf")).lower()
    if model_type in ("hf", "sbert"):
        # a decoder checkpoint on disk goes by its own model_type
        localpath = properties.get("localpath")
        if localpath and read_hf_config(localpath).get("model_type") == \
                "deepseek_v2":
            return TorchDeepseekV2Model
        return TorchHFTextModel
    if model_type == "random":
        return RandomModel
    if model_type == "test":
        return TestModel
    if model_type == "no_model":
        return NoModel
    if model_type == "hf_stella":
        return TorchStellaModel
    if model_type == "multilingual_clip":
        # M-CLIP: XLM-R text tower + linear projection, paired with an
        # openai CLIP image tower (models/hf_clip.py)
        from marqo_tpu_torch.models.hf_clip import TorchHFCLIPModel
        return TorchHFCLIPModel
    if model_type in ("clip", "open_clip", "fp16_clip"):
        # the reference's check order (marqo_tpu/inference/loaders.py):
        # coca, nllb, siglip, the RN tokens, convnext, roberta, eva02
        name = str(properties.get("name", model_name))
        lowered = name.lower()
        if "coca_" in lowered:
            # CoCa: appended-CLS text tower, attentional pooler and the
            # caption decoder; the vision blocks on B2's no-mask mode
            from marqo_tpu_torch.models.coca import TorchCoCaModel
            return TorchCoCaModel
        if "nllb" in lowered:
            # M2M-100 text tower (B1 padding mode) + SigLIP vision trunk
            from marqo_tpu_torch.models.nllb_siglip import \
                TorchNLLBSigLIPModel
            return TorchNLLBSigLIPModel
        if "siglip" in lowered:
            # SigLIP: no-class-token ViT with a latent attention pool and a
            # last-token text tower, both on B2's no-mask mode
            from marqo_tpu_torch.models.siglip import TorchSigLIPModel
            return TorchSigLIPModel
        if any(t in name for t in ("RN50", "RN101")):
            # ResNet-CLIP: ModifiedResNet vision tower + CLIP text tower
            from marqo_tpu_torch.models.resnet_clip import \
                TorchResNetCLIPModel
            return TorchResNetCLIPModel
        if "convnext" in lowered:
            # ConvNeXt-CLIP: timm ConvNeXt trunk + CLIP text tower
            from marqo_tpu_torch.models.convnext_clip import \
                TorchConvNextCLIPModel
            return TorchConvNextCLIPModel
        if "roberta" in lowered:
            # roberta/xlm-roberta text tower + ViT composites
            # (open_clip custom-text models) — models/hf_clip.py
            from marqo_tpu_torch.models.hf_clip import TorchHFCLIPModel
            return TorchHFCLIPModel
        if "eva02" in lowered:
            # RoPE + SwiGLU vision trunk on B2's no-mask mode + CLIP text
            # tower; real checkpoints load behind
            # MARQO_ALLOW_UNVERIFIED_CONVERSION (models/eva02.py)
            from marqo_tpu_torch.models.eva02 import TorchEVA02Model
            return TorchEVA02Model
        from marqo_tpu_torch.models.clip import TorchCLIPModel
        return TorchCLIPModel
    if model_type == "languagebind":
        # text, image, audio and video towers in one space
        # (models/languagebind.py)
        from marqo_tpu_torch.models.languagebind import \
            TorchLanguageBindModel
        return TorchLanguageBindModel
    raise InvalidArgumentError(
        f"Unknown model type `{model_type}` for model `{model_name}`")


def load_model(model_name: str, properties: dict, device: Device,
               model_auth=None) -> EmbeddingModel:
    """Resolve + construct + load (weights on device)."""
    cls = resolve_model_class(model_name, properties)
    model = cls(model_name, properties, device, model_auth)
    model.load()
    return model
