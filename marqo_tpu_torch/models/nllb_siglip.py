"""NLLB-SigLIP: the M2M-100 (NLLB-200) text encoder and the SigLIP vision
trunk, in PyTorch (port of marqo_tpu/models/nllb_siglip.py).

Serves visheratin/nllb-clip-{base,large}-siglip and nllb-siglip-mrl-{base,
large} (open_clip's HF text tower + timm SigLIP trunk).

Text tower: token embeddings scaled by sqrt(H); fairseq sinusoidal
positions (``cumsum(mask) * mask + pad``, a [sin | cos] table whose
``padding_idx`` row is zero); pre-LN M2M-100 layers with a ReLU FFN; a
final LayerNorm; pooling at the FIRST token (the NLLB language code); a
linear projection. Its attention is padding-masked: ops/flash_attention.py's
padding mode (CUDA kernel B1 on a CUDA device, its plain twin on the CPU;
``attention_impl="plain"`` selects the twin), whose -1e9 fill is the JAX
package's pad bias. HF's M2M-100 scales q by D^-0.5 before the product;
B1 applies 1/sqrt(D) to the scores itself, so q goes in unscaled.

Vision tower: models/siglip.py's trunk (B2's no-mask mode). Images are
preprocessed as CLIP's (shorter-side bicubic resize, centre crop), as the
JAX package's wrapper does.

The open_clip pairing layout of a real checkpoint (``text.transformer.*``,
``text.proj``, ``visual.trunk.*`` key names) is not verified offline, so
loading one requires MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE, as in the JAX
package. The module's dtype is the compute dtype; the position table, the
embedding sum, LayerNorm statistics and the projection run in fp32.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from marqo_tpu_torch.core.exceptions import ModelLoadError
from marqo_tpu_torch.logging import get_logger
from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.models.clip import load_open_clip_state
from marqo_tpu_torch.models.siglip import (SigLIPVisionConfig,
                                           SigLIPVisionTower,
                                           TorchSigLIPModel,
                                           params_from_open_clip_siglip,
                                           vision_values)
from marqo_tpu_torch.ops import flash_attention
from marqo_tpu_torch.ops.common import layer_norm

logger = get_logger(__name__)


@dataclass(frozen=True)
class NLLBTextConfig:
    vocab_size: int = 256206        # NLLB-200
    hidden_size: int = 1024
    num_layers: int = 12            # distilled-600M encoder
    num_heads: int = 16
    intermediate_size: int = 4096   # encoder_ffn_dim
    max_positions: int = 1024
    pad_token_id: int = 1
    embed_dim: int = 768
    layer_norm_eps: float = 1e-5
    # "kernel": ops/flash_attention.py's padding mode (CUDA kernel B1 on a
    # CUDA device, plain twin on the CPU); "plain": always the plain twin
    attention_impl: str = "kernel"


# registry-name → (text (w, L, heads, mlp, embed),
#                  vision (w, L, heads, mlp, patch, image))
NLLB_SIGLIP_ARCHS = {
    "nllb-clip-base-siglip": ((1024, 12, 16, 4096, 768),
                              (768, 12, 12, 3072, 16, 384)),
    "nllb-siglip-mrl-base": ((1024, 12, 16, 4096, 768),
                             (768, 12, 12, 3072, 16, 384)),
    # large pairs the 1.3B NLLB encoder (24 layers) with SigLIP SO400M
    "nllb-clip-large-siglip": ((1024, 24, 16, 8192, 1152),
                               (1152, 27, 16, 4304, 14, 384)),
    "nllb-siglip-mrl-large": ((1024, 24, 16, 8192, 1152),
                              (1152, 27, 16, 4304, 14, 384)),
}

_ATTENTION = {
    "kernel": flash_attention.attention_padding,
    "plain": flash_attention.attention_padding_reference,
}


def sinusoidal_positions(num_positions: int, dim: int,
                         padding_idx: int = 1) -> np.ndarray:
    """fairseq/M2M100 sinusoidal table: [sin | cos] halves (NOT
    interleaved), row ``padding_idx`` zeroed (transformers
    M2M100SinusoidalPositionalEmbedding.get_embedding)."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64)
                  * -(np.log(10000.0) / (half - 1)))
    angles = np.outer(np.arange(num_positions, dtype=np.float64), freq)
    table = np.concatenate([np.sin(angles), np.cos(angles)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_positions, 1))], axis=1)
    table[padding_idx] = 0.0
    return table.astype(np.float32)


class M2MEncoderLayer(nn.Module):
    """One pre-LN M2M-100 encoder layer (ReLU FFN)."""

    def __init__(self, config: NLLBTextConfig):
        super().__init__()
        H, I = config.hidden_size, config.intermediate_size
        self.num_heads, self.eps = config.num_heads, config.layer_norm_eps
        self.attn_ln = nn.LayerNorm(H)
        self.q = nn.Linear(H, H)
        self.k = nn.Linear(H, H)
        self.v = nn.Linear(H, H)
        self.o = nn.Linear(H, H)
        self.ffn_ln = nn.LayerNorm(H)
        self.fc1 = nn.Linear(H, I)
        self.fc2 = nn.Linear(I, H)

    def forward(self, x: torch.Tensor, attend,
                mask: torch.Tensor) -> torch.Tensor:
        """x: (B, S, H); ``attend(q, k, v, mask)`` with q unscaled (the
        kernel applies 1/sqrt(D)); mask (B, S), 1 = real token."""
        B, S, H = x.shape
        N = self.num_heads
        h = layer_norm(x, self.attn_ln.weight, self.attn_ln.bias, self.eps)

        def heads(t):
            # a view: the kernel reads the projection's layout by strides
            return t.view(B, S, N, H // N).transpose(1, 2)

        ctx = attend(heads(self.q(h)), heads(self.k(h)), heads(self.v(h)),
                     mask)
        x = x + self.o(ctx.transpose(1, 2).reshape(B, S, H))
        h = layer_norm(x, self.ffn_ln.weight, self.ffn_ln.bias, self.eps)
        return x + self.fc2(F.relu(self.fc1(h)))


class NLLBTextTower(nn.Module):
    def __init__(self, config: NLLBTextConfig):
        super().__init__()
        H = config.hidden_size
        self.config = config
        self.token_embedding = nn.Parameter(torch.empty(config.vocab_size, H))
        # fp32 whatever the compute dtype (``_empty_model`` re-widens it
        # after the cast), as the JAX package keeps it
        self.register_buffer("position_table", torch.empty(
            config.max_positions + 2, H, dtype=torch.float32))
        self.layers = nn.ModuleList(M2MEncoderLayer(config)
                                    for _ in range(config.num_layers))
        self.final_ln = nn.LayerNorm(H)
        self.projection = nn.Linear(H, config.embed_dim)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S) int → (B, embed_dim) fp32 (unnormalized); ids equal to
        ``pad_token_id`` are padding."""
        config = self.config
        input_ids = input_ids.long()
        mask = (input_ids != config.pad_token_id).int()
        # fairseq position ids: cumsum over real tokens + padding_idx
        positions = torch.cumsum(mask, dim=1) * mask + config.pad_token_id
        x = self.token_embedding[input_ids].float() * math.sqrt(
            config.hidden_size) + self.position_table[positions]
        x = x.to(self.token_embedding.dtype)
        attend = _ATTENTION[config.attention_impl]
        for layer in self.layers:
            x = layer(x, attend, mask)
        x = layer_norm(x.float(), self.final_ln.weight, self.final_ln.bias,
                       config.layer_norm_eps)
        return F.linear(x[:, 0], self.projection.weight.float(),
                        self.projection.bias.float())


class NLLBSigLIP(nn.Module):
    """The M2M-100 text tower and the SigLIP vision trunk; the module's
    dtype is the compute dtype (the position table stays fp32)."""

    def __init__(self, text_config: NLLBTextConfig,
                 vision_config: SigLIPVisionConfig):
        super().__init__()
        self.text = NLLBTextTower(text_config)
        self.vision = SigLIPVisionTower(vision_config)


def encode_nllb_text(model: NLLBSigLIP,
                     input_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) int → (B, embed_dim) fp32 (unnormalized)."""
    return model.text(input_ids)


def encode_nllb_image(model: NLLBSigLIP,
                      pixels_u8: torch.Tensor) -> torch.Tensor:
    """(B, size, size, 3) uint8 → (B, hidden_size) fp32 (unnormalized)."""
    return model.vision(pixels_u8)


# --- init + conversion -------------------------------------------------------

def _empty_model(text_config, vision_config, dtype, device) -> NLLBSigLIP:
    model = empty_module(lambda: NLLBSigLIP(text_config, vision_config),
                         dtype, device)
    model.text.position_table = model.text.position_table.float()
    return model


def _position_table(config: NLLBTextConfig) -> np.ndarray:
    return sinusoidal_positions(config.max_positions + 2, config.hidden_size,
                                config.pad_token_id)


@torch.no_grad()
def init_nllb_siglip_params(text_config: NLLBTextConfig,
                            vision_config: SigLIPVisionConfig,
                            generator: torch.Generator, dtype=torch.float32,
                            device="cuda") -> NLLBSigLIP:
    """Random-init model (normal(0, 0.02) weights and embeddings, zero
    biases, unit LayerNorms, the sinusoidal table), drawn from
    ``generator`` on ``device``."""
    model = random_init(_empty_model(text_config, vision_config, dtype,
                                     device), generator)
    model.text.position_table.copy_(torch.from_numpy(
        _position_table(text_config)))
    return model


def params_from_m2m100_encoder(state_dict, config: NLLBTextConfig,
                               prefix: str = "model.encoder.",
                               proj=None) -> dict:
    """Convert a transformers M2M100 encoder state dict into the JAX
    package's text layout (numpy float32). ``proj`` is the (w (in, out), b)
    of the contrastive projection; absent, the projection is the identity
    cut to ``embed_dim``, as in the JAX package."""
    def array(key, transpose=False):
        tensor = state_dict[key]
        a = tensor.detach().float().cpu().numpy() if torch.is_tensor(tensor) \
            else np.asarray(tensor, np.float32)
        return np.asarray(a.T if transpose else a, np.float32)

    def stacked(name, transpose=False):
        return np.stack([array(f"{prefix}layers.{i}.{name}", transpose)
                         for i in range(config.num_layers)])

    layers = {}
    for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                         ("v", "self_attn.v_proj"),
                         ("o", "self_attn.out_proj"), ("fc1", "fc1"),
                         ("fc2", "fc2")):
        layers[f"{ours}_w"] = stacked(f"{theirs}.weight", True)
        layers[f"{ours}_b"] = stacked(f"{theirs}.bias")
    for ours, theirs in (("attn_ln", "self_attn_layer_norm"),
                         ("ffn_ln", "final_layer_norm")):
        layers[f"{ours}_scale"] = stacked(f"{theirs}.weight")
        layers[f"{ours}_bias"] = stacked(f"{theirs}.bias")
    embed_key = (prefix + "embed_tokens.weight"
                 if prefix + "embed_tokens.weight" in state_dict
                 else "model.shared.weight")
    if proj is not None:
        proj_w, proj_b = (np.asarray(a, np.float32) for a in proj)
    else:
        proj_w = np.eye(config.hidden_size, config.embed_dim,
                        dtype=np.float32)
        proj_b = np.zeros(config.embed_dim, np.float32)
    return {"token_embedding": array(embed_key),
            "position_table": _position_table(config),
            "layers": layers,
            "final_ln_scale": array(prefix + "layer_norm.weight"),
            "final_ln_bias": array(prefix + "layer_norm.bias"),
            "proj_w": proj_w, "proj_b": proj_b}


# this module's layer names ← the JAX package's stacked layer keys
_JAX_LAYER = {"q": ("q_w", "q_b"), "k": ("k_w", "k_b"), "v": ("v_w", "v_b"),
              "o": ("o_w", "o_b"), "fc1": ("fc1_w", "fc1_b"),
              "fc2": ("fc2_w", "fc2_b"),
              "attn_ln": ("attn_ln_scale", "attn_ln_bias"),
              "ffn_ln": ("ffn_ln_scale", "ffn_ln_bias")}


def text_values(prefix: str, text: dict, L: int) -> dict:
    """The values of an ``NLLBTextTower`` under ``prefix``, from the JAX
    package's text layout (numpy arrays; weights (in, out) there, so they
    transpose)."""
    values = {
        f"{prefix}token_embedding": text["token_embedding"],
        f"{prefix}position_table": text["position_table"],
        f"{prefix}final_ln.weight": text["final_ln_scale"],
        f"{prefix}final_ln.bias": text["final_ln_bias"],
        f"{prefix}projection.weight": np.asarray(text["proj_w"]).T,
        f"{prefix}projection.bias": text["proj_b"],
    }
    for i in range(L):
        for name, (w, b) in _JAX_LAYER.items():
            values[f"{prefix}layers.{i}.{name}.weight"] = \
                np.asarray(text["layers"][w][i]).T
            values[f"{prefix}layers.{i}.{name}.bias"] = text["layers"][b][i]
    return values


def params_from_jax(params_numpy: dict, text_config: NLLBTextConfig,
                    vision_config: SigLIPVisionConfig, dtype=torch.float32,
                    device="cuda") -> NLLBSigLIP:
    """A model holding parameters in the JAX package's layout, given as
    numpy arrays ({"text": {...}, "vision": {...}}): the JAX package's own
    params, or the converters' output."""
    model = _empty_model(text_config, vision_config, dtype, device)
    return fill_parameters(model, {
        **text_values("text.", params_numpy["text"], text_config.num_layers),
        **vision_values("vision.", params_numpy["vision"],
                        vision_config.num_layers)})


# --- wrapper -----------------------------------------------------------------

class TorchNLLBSigLIPModel(TorchSigLIPModel):
    """NLLB-SigLIP wrapper: multilingual text and SigLIP image embedding
    (reference JaxNLLBSigLIPModel). A real open_clip checkpoint loads only
    with MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE. Encoding, the batch
    buckets and ``set_attention_impl`` are ``TorchSigLIPModel``'s; the
    tokenizer, the text padding and the image preprocessing (CLIP's) are
    the reference wrapper's."""

    def _configs_for_name(self):
        name = self.properties.get("name", self.model_name)
        for token, (txt, vis) in NLLB_SIGLIP_ARCHS.items():
            if token in name:
                th, tL, theads, tmlp, embed = txt
                w, L, h, mlp, patch, image = vis
                return (NLLBTextConfig(hidden_size=th, num_layers=tL,
                                       num_heads=theads,
                                       intermediate_size=tmlp,
                                       embed_dim=embed),
                        SigLIPVisionConfig(image_size=image,
                                           patch_size=patch, hidden_size=w,
                                           num_layers=L, num_heads=h,
                                           intermediate_size=mlp))
        return NLLBTextConfig(), SigLIPVisionConfig(image_size=384)

    def load(self) -> None:
        if self.properties.get("localpath") or \
                self.properties.get("model_location"):
            from marqo_tpu_torch.api import configs
            allow = str(configs.read_env_vars_and_defaults(
                "MARQO_ALLOW_UNVERIFIED_CONVERSION") or "").upper() == "TRUE"
            if not allow:
                raise ModelLoadError(
                    f"NLLB-SigLIP model `{self.model_name}`: the open_clip "
                    "checkpoint pairing layout cannot be verified offline "
                    "(open_clip not installed; the M2M-100 text math itself "
                    "IS transformers-verified). Set "
                    "MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE to load anyway, "
                    "or use a SigLIP/ViT CLIP model.")
            logger.warning(
                f"Loading NLLB-SigLIP model `{self.model_name}` with "
                "UNVERIFIED open_clip pairing conversion "
                "(text.transformer.* / text.proj / visual.trunk.* key "
                "names assumed; MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE).")
            self._load_from_checkpoint(self._checkpoint_path())
        elif self.properties.get("random_init"):
            self._load_random_init()
        else:
            raise ModelLoadError(
                f"NLLB-SigLIP model `{self.model_name}` requires an "
                "open_clip checkpoint: provide model_properties.localpath "
                "or a model_location (and "
                "MARQO_ALLOW_UNVERIFIED_CONVERSION).")
        self._loaded()

    def _checkpoint_path(self) -> str:
        path = self.properties.get("localpath")
        if path:
            return path
        from marqo_tpu_torch.inference.model_download import (
            auth_for_location, download_model)
        location = self.properties["model_location"]
        return download_model(repo_location=location,
                              auth=auth_for_location(location,
                                                     self.model_auth))

    def _load_from_checkpoint(self, path: str) -> None:
        self.text_config, self.vision_config = self._configs_for_name()
        state = load_open_clip_state(path)
        proj = None
        if "text.proj.weight" in state:
            proj = (state["text.proj.weight"].float().numpy().T,
                    state["text.proj.bias"].float().numpy()
                    if "text.proj.bias" in state
                    else np.zeros(self.text_config.embed_dim, np.float32))
        text = params_from_m2m100_encoder(
            state, self.text_config, prefix="text.transformer.encoder.",
            proj=proj)
        vision = params_from_open_clip_siglip(
            state, None, self.vision_config, vision_only=True)["vision"]
        self.encoder = params_from_jax(
            {"text": text, "vision": vision}, self.text_config,
            self.vision_config, dtype=self.compute_dtype,
            device=self._device)
        self._init_tokenizer()

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        embed = int(self.properties.get("dimensions", 64))
        self.text_config = NLLBTextConfig(
            vocab_size=int(arch.get("vocab_size", 1024)),
            hidden_size=int(arch.get("text_hidden_size", 32)),
            num_layers=int(arch.get("text_layers", 2)),
            num_heads=int(arch.get("text_heads", 2)),
            intermediate_size=int(arch.get("text_intermediate", 64)),
            max_positions=int(arch.get("max_positions", 64)),
            embed_dim=embed)
        self.vision_config = SigLIPVisionConfig(
            image_size=int(self.properties.get("image_size", 32)),
            patch_size=int(arch.get("patch_size", 16)),
            hidden_size=embed,
            num_layers=int(arch.get("vision_layers", 2)),
            num_heads=int(arch.get("vision_heads", 2)),
            intermediate_size=int(arch.get("vision_intermediate", 64)))
        self.encoder = init_nllb_siglip_params(
            self.text_config, self.vision_config, self._generator(),
            dtype=self.compute_dtype, device=self._device)
        self._init_tokenizer()

    def _init_tokenizer(self, checkpoint: str = None) -> None:
        from marqo_tpu_torch.models.tokenizer import TextTokenizer
        self.tokenizer = TextTokenizer.build_test_wordpiece(max_length=64)

    def _tokenize(self, texts) -> np.ndarray:
        batch = self.tokenizer.encode_batch(texts, pad_to=None)
        ids = batch["input_ids"] % self.text_config.vocab_size
        # M2M100 reserves pad=1; remap collisions away from pad
        ids = np.where(ids == self.text_config.pad_token_id, 2, ids)
        mask = batch["attention_mask"]
        return np.where(mask > 0, ids,
                        self.text_config.pad_token_id).astype(np.int32)

    def _encode_text(self, texts) -> np.ndarray:
        # short batch buckets fill with all-pad rows
        return self._run(self._tokenize(texts), "text",
                         pad_value=self.text_config.pad_token_id)

    def _preprocess_host(self, content) -> np.ndarray:
        """CLIP's preprocessing (shorter-side bicubic resize, centre crop),
        as the reference wrapper's."""
        from marqo_tpu_torch.models.clip import TorchCLIPModel
        return TorchCLIPModel._preprocess_host(self, content)
