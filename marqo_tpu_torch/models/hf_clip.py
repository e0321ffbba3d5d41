"""HF-text CLIP composites in PyTorch (port of marqo_tpu/models/hf_clip.py):
roberta-ViT-B-32, xlm-roberta-base-ViT-B-32, xlm-roberta-large-ViT-H-14
(open_clip custom-text models) and the M-CLIP ``multilingual_clip``
entries.

open_clip pairs an HF RoBERTa/XLM-R encoder (HFTextEncoder with
mean_pooler and a bias-free 2-layer MLP projection, hf_model.py) with a
standard CLIP ViT vision tower. Both halves already exist here — the
BERT-family encoder (models/bert.py, attention in kernel B1's padding
mode) and the ViT tower (models/clip.py, attention in kernel B2's no-mask
mode) — so this module is conversion + pooling + the projection head: the
MLP with exact GELU, or M-CLIP's single biased linear, both in fp32 on
weights held in the compute dtype.
"""

import hashlib
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.core.exceptions import ModelLoadError
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.models import bert
from marqo_tpu_torch.models.bert import TextEncoder, TextEncoderConfig
from marqo_tpu_torch.models.clip import (CLIPTextConfig, CLIPVisionConfig,
                                         CLIPVisionTower, TorchCLIPModel,
                                         init_vision_tower, open_clip_vision,
                                         vision_tower_from_jax)
from marqo_tpu_torch.parallel.serving import put_params


class HFCLIPEncoder(nn.Module):
    """Text encoder + projection head + ViT tower; the module's dtype is
    the compute dtype. ``head`` holds the MLP (``proj1``, ``proj2``, no
    biases) or M-CLIP's linear (``proj``)."""

    def __init__(self, text: TextEncoder, head: nn.ModuleDict,
                 vision: CLIPVisionTower):
        super().__init__()
        self.text = text
        self.head = head
        self.vision = vision


def encode_hf_clip_text(model: HFCLIPEncoder, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor) -> torch.Tensor:
    """BERT-family encoder (mean pool) → projection head, in fp32:
    (B, S) → (B, projection_dim), unnormalized."""
    pooled = bert.encode_tokens(model.text, input_ids, attention_mask)
    head = model.head
    if "proj1" in head:
        h = torch.nn.functional.gelu(pooled @ head["proj1"].weight.float().T,
                                     approximate="none")
        return h @ head["proj2"].weight.float().T
    return pooled @ head["proj"].weight.float().T + head["proj"].bias.float()


def encode_hf_clip_image(model: HFCLIPEncoder,
                         pixels_u8: torch.Tensor) -> torch.Tensor:
    """(B, size, size, 3) uint8 → (B, projection_dim) fp32 (unnormalized)."""
    return model.vision(pixels_u8)


# vision tower configs per composite (open_clip model_configs; the M-CLIP
# entries pair with openai towers → quick_gelu)
_VISION = {
    "ViT-H-14": CLIPVisionConfig(image_size=224, patch_size=14,
                                 hidden_size=1280, num_layers=32,
                                 num_heads=16, intermediate_size=5120,
                                 projection_dim=1024, hidden_act="gelu"),
    "ViT-B-32": CLIPVisionConfig(image_size=224, patch_size=32,
                                 hidden_size=768, num_layers=12,
                                 num_heads=12, intermediate_size=3072,
                                 projection_dim=512, hidden_act="gelu"),
    "Vit-L-14": CLIPVisionConfig(image_size=224, patch_size=14,
                                 hidden_size=1024, num_layers=24,
                                 num_heads=16, intermediate_size=4096,
                                 projection_dim=768,
                                 hidden_act="quick_gelu"),
    "Vit-B/32": CLIPVisionConfig(image_size=224, patch_size=32,
                                 hidden_size=768, num_layers=12,
                                 num_heads=12, intermediate_size=3072,
                                 projection_dim=512,
                                 hidden_act="quick_gelu"),
    "Vit-B/16+": CLIPVisionConfig(image_size=240, patch_size=16,
                                  hidden_size=896, num_layers=12,
                                  num_heads=14, intermediate_size=3584,
                                  projection_dim=640, hidden_act="gelu"),
}


def _head(proj: dict, dtype, device) -> nn.ModuleDict:
    """The projection head from (in, out) arrays: ``proj_w1``/``proj_w2``
    (MLP) or ``proj_w``/``proj_b`` (M-CLIP linear)."""
    if "proj_w1" in proj:
        return nn.ModuleDict({
            name: bert.linear_layer(np.asarray(proj[key]).T, None, dtype,
                                    device)
            for name, key in (("proj1", "proj_w1"), ("proj2", "proj_w2"))})
    return nn.ModuleDict({"proj": bert.linear_layer(
        np.asarray(proj["proj_w"]).T, proj["proj_b"], dtype, device)})


def _assemble(text, proj, vision, dtype, device) -> HFCLIPEncoder:
    return HFCLIPEncoder(text, _head(proj, dtype, device), vision)


def params_from_jax(params_numpy: dict, text_config: TextEncoderConfig,
                    vision_config: CLIPVisionConfig, dtype=torch.float32,
                    device="cuda") -> HFCLIPEncoder:
    """A model holding marqo_tpu's HF-CLIP pytree, given as numpy arrays
    ({"text": bert pytree, "vision": CLIP vision layout, and "proj_w1" /
    "proj_w2" or "proj_w" / "proj_b"})."""
    text = bert.params_from_jax(params_numpy["text"], text_config,
                                dtype=dtype, device=device)
    vision = vision_tower_from_jax(params_numpy["vision"], vision_config,
                                   dtype=dtype, device=device)
    return _assemble(text, params_numpy, vision, dtype, device)


class TorchHFCLIPModel(TorchCLIPModel):
    """Composite wrapper: HF RoBERTa/XLM-R text + CLIP ViT vision. Images
    go through ``TorchCLIPModel``'s host preprocessing and batch buckets;
    text through the BERT-family encoder and the projection head."""

    compute_dtype = torch.bfloat16

    def __init__(self, model_name: str, properties: dict, device: Device,
                 model_auth=None):
        super().__init__(model_name, properties, device, model_auth)
        self.encoder: Optional[HFCLIPEncoder] = None
        self.text_config: Optional[TextEncoderConfig] = None

    @property
    def dimensions(self) -> int:
        return int(self.properties.get("dimensions", 0)) or \
            (self.vision_config.projection_dim if self.vision_config else 0)

    def _vision_token(self) -> str:
        name = self.properties.get("name", self.model_name)
        for token in ("ViT-H-14", "Vit-L-14", "Vit-B/16+", "Vit-B/32"):
            if token in name:
                return token
        return "ViT-B-32"

    def load(self) -> None:
        if self.properties.get("localpath"):
            self._load_from_checkpoint(self.properties["localpath"])
        elif self.properties.get("random_init"):
            self._load_random_init()
        else:
            raise ModelLoadError(
                f"HF-text CLIP model `{self.model_name}` requires an "
                "open_clip checkpoint: provide model_properties.localpath "
                "or a model_location.")
        self.encoder = put_params(self, self.encoder)
        self.loaded = True
        from marqo_tpu_torch.inference.loaders import module_bytes
        self._param_bytes = module_bytes(self.encoder)

    def _load_from_checkpoint(self, path: str) -> None:
        if os.path.isdir(path):
            for fname in ("open_clip_pytorch_model.bin", "pytorch_model.bin",
                          "model.pt"):
                cand = os.path.join(path, fname)
                if os.path.isfile(cand):
                    path = cand
                    break
        from marqo_tpu_torch.inference.checkpoint_load import \
            load_torch_checkpoint
        state = load_torch_checkpoint(path, family="multilingual_clip")
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        state = {k[len("module."):] if k.startswith("module.") else k: v
                 for k, v in state.items()}
        sd_np = {k: np.asarray(v.detach().cpu().float().numpy()
                               if hasattr(v, "detach") else v)
                 for k, v in state.items()}
        arch = self.properties.get("architecture", {})
        self.vision_config = _VISION[self._vision_token()]

        if "LinearTransformation.weight" in sd_np:
            # M-CLIP layout (reference MULTILINGUAL_CLIP, clip_utils.py:521):
            # transformer.<xlmr keys> + LinearTransformation Linear w/ bias.
            # The image tower ships separately (an openai CLIP checkpoint) —
            # model_properties.vision_localpath.
            prefix = "transformer."
            proj = {"proj_w": sd_np["LinearTransformation.weight"].T,
                    "proj_b": sd_np["LinearTransformation.bias"]}
            vision = self._load_vision_checkpoint()
        else:
            # open_clip composite layout: text.transformer.<hf keys> +
            # text.proj.{0,2}.weight + visual.* in one state dict
            prefix = "text.transformer."
            proj = {"proj_w1": sd_np["text.proj.0.weight"].T,
                    "proj_w2": sd_np["text.proj.2.weight"].T}
            vision = open_clip_vision(sd_np, self.vision_config)
        hf_sd = {k[len(prefix):]: v for k, v in sd_np.items()
                 if k.startswith(prefix)}
        self.text_config = self._text_config_from_weights(hf_sd, arch)
        text = bert.params_from_torch_state_dict(
            hf_sd, self.text_config, dtype=self.compute_dtype,
            device=self._device)
        self.encoder = _assemble(
            text, proj, vision_tower_from_jax(vision, self.vision_config,
                                              dtype=self.compute_dtype,
                                              device=self._device),
            self.compute_dtype, self._device)
        self._init_tokenizer(checkpoint=path)

    def _load_vision_checkpoint(self) -> dict:
        """Load the separate image-tower checkpoint for M-CLIP models:
        an openai/open_clip state dict (visual.*) or an HF CLIPModel dir;
        returns the JAX package's vision layout (numpy)."""
        vpath = self.properties.get("vision_localpath")
        if not vpath:
            raise ModelLoadError(
                f"M-CLIP model `{self.model_name}` pairs a separate CLIP "
                "image tower: provide model_properties.vision_localpath "
                "(openai/open_clip checkpoint or HF CLIPModel directory).")
        if os.path.isdir(vpath):
            from transformers import CLIPConfig, CLIPModel

            from marqo_tpu_torch.models.clip import params_from_hf_clip
            hf_config = CLIPConfig.from_pretrained(vpath)
            torch_model = CLIPModel.from_pretrained(vpath)
            dummy_text = CLIPTextConfig(
                vocab_size=hf_config.text_config.vocab_size,
                hidden_size=hf_config.text_config.hidden_size,
                num_layers=hf_config.text_config.num_hidden_layers,
                num_heads=hf_config.text_config.num_attention_heads,
                intermediate_size=hf_config.text_config.intermediate_size,
                projection_dim=hf_config.projection_dim)
            vision = params_from_hf_clip(torch_model.state_dict(), dummy_text,
                                         self.vision_config)["vision"]
            del torch_model
            return vision
        from marqo_tpu_torch.inference.checkpoint_load import \
            load_torch_checkpoint
        state = load_torch_checkpoint(vpath, family="clip",
                                      weights_only=False)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        sd_np = {k: np.asarray(v.detach().cpu().float().numpy()
                               if hasattr(v, "detach") else v)
                 for k, v in state.items()}
        return open_clip_vision(sd_np, self.vision_config)

    def _text_config_from_weights(self, hf_sd: dict,
                                  arch: dict) -> TextEncoderConfig:
        """Infer the RoBERTa/XLM-R shape from the converted weights."""
        vocab, hidden = hf_sd["embeddings.word_embeddings.weight"].shape
        n_layers = 0
        while f"encoder.layer.{n_layers}.attention.self.query.weight" in \
                hf_sd:
            n_layers += 1
        inter = hf_sd["encoder.layer.0.intermediate.dense.weight"].shape[0]
        max_pos = hf_sd["embeddings.position_embeddings.weight"].shape[0]
        return TextEncoderConfig(
            vocab_size=vocab, hidden_size=hidden, num_layers=n_layers,
            num_heads=int(arch.get("text_heads", max(1, hidden // 64))),
            intermediate_size=inter, max_position_embeddings=max_pos,
            type_vocab_size=1, hidden_act="gelu",
            position_offset=2,  # RoBERTa/XLM-R: padding_idx(1) + 1
            pooling="mean", normalize=False)

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        dims = int(self.properties.get("dimensions", 32))
        self.text_config = TextEncoderConfig(
            vocab_size=int(arch.get("vocab_size", 1024)),
            hidden_size=int(arch.get("text_hidden_size", 32)),
            num_layers=int(arch.get("text_layers", 2)),
            num_heads=int(arch.get("text_heads", 2)),
            intermediate_size=int(arch.get("text_intermediate", 64)),
            position_offset=2, pooling="mean", normalize=False)
        self.vision_config = CLIPVisionConfig(
            image_size=int(self.properties.get("image_size", 32)),
            patch_size=int(arch.get("patch_size", 16)),
            hidden_size=int(arch.get("vision_hidden_size", 32)),
            num_layers=int(arch.get("vision_layers", 2)),
            num_heads=int(arch.get("vision_heads", 2)),
            intermediate_size=int(arch.get("vision_intermediate", 64)),
            projection_dim=dims, hidden_act="gelu")
        seed = int.from_bytes(
            hashlib.sha256(self.model_name.encode()).digest()[:4], "little")
        generator = torch.Generator(device=self._device).manual_seed(seed)
        dtype = self.compute_dtype
        text = bert.init_encoder(self.text_config, generator, dtype=dtype,
                                 device=self._device)
        H = self.text_config.hidden_size
        mid = (H + dims) // 2

        def normal(*shape):
            return torch.randn(shape, generator=generator,
                               device=self._device) * 0.02

        vision = init_vision_tower(self.vision_config, generator,
                                   dtype=dtype, device=self._device)
        self.encoder = HFCLIPEncoder(text, nn.ModuleDict({
            "proj1": bert.linear_layer(normal(mid, H), None, dtype,
                                       self._device),
            "proj2": bert.linear_layer(normal(dims, mid), None, dtype,
                                       self._device),
        }), vision)
        self._init_tokenizer()

    def _init_tokenizer(self, checkpoint: str = None) -> None:
        from marqo_tpu_torch.models.tokenizer import resolve_model_tokenizer
        self.tokenizer = resolve_model_tokenizer(
            self.properties, max_length=int(self.properties.get("tokens",
                                                                128)),
            checkpoint_path=checkpoint,
            allow_test=bool(self.properties.get("random_init")))

    # -- encoding -------------------------------------------------------------

    def _encode_text(self, texts: List[str]) -> np.ndarray:
        batch = self.tokenizer.encode_batch(texts)
        ids = (batch["input_ids"] % self.text_config.vocab_size).astype(
            np.int32)
        mask = batch["attention_mask"].astype(np.int32)
        # ids and mask travel together: stack along a new axis so the
        # shared batched dispatcher pads them as one array
        both = np.stack([ids, mask], axis=1)  # (n, 2, S)
        # a row with an all-zero mask, the bucket's padding rows among
        # them, gets one real position so mean-pool denominators never hit
        # zero
        both[both[:, 1].sum(axis=1) == 0, 1, 0] = 1
        pad_row = np.zeros(both.shape[1:], dtype=np.int32)
        pad_row[1, 0] = 1

        # on CUDA one graph per (batch bucket, text length)
        from marqo_tpu_torch.inference.batching import batched_device_encode
        with torch.inference_mode():
            return batched_device_encode(
                self, both, lambda encoder, padded: encode_hf_clip_text(
                    encoder, padded[:, 0], padded[:, 1].contiguous()),
                pad_row, graph="text", static=(self.encoder.text.config,))
