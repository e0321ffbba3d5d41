"""A tiny ``deepseek_v2`` checkpoint for the tests: its config, seeded
random weights under the HF state dict's names, a byte-level BPE
tokenizer with BOS first, written whole or in shards with their index.
Imports neither JAX nor the JAX package (the card's tests use it too)."""

import json
import os

import torch

TINY = {
    "model_type": "deepseek_v2", "architectures": ["DeepseekV2ForCausalLM"],
    "vocab_size": 300, "hidden_size": 64, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "kv_lora_rank": 32, "q_lora_rank": None, "intermediate_size": 96,
    "moe_intermediate_size": 24, "n_routed_experts": 8, "n_shared_experts": 2,
    "num_experts_per_tok": 2, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "norm_topk_prob": False,
    "routed_scaling_factor": 1.0, "topk_method": "greedy", "n_group": 1,
    "topk_group": 1, "scoring_func": "softmax", "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "max_position_embeddings": 16384,
    "rope_scaling": {"type": "yarn", "factor": 40,
                     "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707},
    "attention_bias": False, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 256, "eos_token_id": 257,
}
BOS = "<bos>"


def state_dict(c: dict = TINY, seed: int = 0, std: float = 0.1) -> dict:
    """HF-named float32 weights: N(0, std^2) (wider than a checkpoint's
    0.02 by default, so that a tiny model's layers move its output), the
    router's ten times that, RMSNorm scales 1 + 0.02 n."""
    g = torch.Generator().manual_seed(seed)
    H, N = c["hidden_size"], c["num_attention_heads"]
    nope, rd, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank = c["kv_lora_rank"]

    def w(*shape):
        return torch.randn(shape, generator=g) * std

    def norm(n):
        return 1 + 0.02 * torch.randn(n, generator=g)

    out = {"model.embed_tokens.weight": w(c["vocab_size"], H),
           "model.norm.weight": norm(H), "lm_head.weight": w(c["vocab_size"], H)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": norm(H),
            p + "post_attention_layernorm.weight": norm(H),
            p + "self_attn.q_proj.weight": w(N * (nope + rd), H),
            p + "self_attn.kv_a_proj_with_mqa.weight": w(rank + rd, H),
            p + "self_attn.kv_a_layernorm.weight": norm(rank),
            p + "self_attn.kv_b_proj.weight": w(N * (nope + dv), rank),
            p + "self_attn.o_proj.weight": w(H, N * dv)})
        if i < c["first_k_dense_replace"]:
            F = c["intermediate_size"]
            out.update({p + "mlp.gate_proj.weight": w(F, H),
                        p + "mlp.up_proj.weight": w(F, H),
                        p + "mlp.down_proj.weight": w(H, F)})
            continue
        F = c["moe_intermediate_size"]
        out[p + "mlp.gate.weight"] = w(c["n_routed_experts"], H) * 10
        for e in range(c["n_routed_experts"]):
            out.update({p + f"mlp.experts.{e}.gate_proj.weight": w(F, H),
                        p + f"mlp.experts.{e}.up_proj.weight": w(F, H),
                        p + f"mlp.experts.{e}.down_proj.weight": w(H, F)})
        S = F * c["n_shared_experts"]
        out.update({p + "mlp.shared_experts.gate_proj.weight": w(S, H),
                    p + "mlp.shared_experts.up_proj.weight": w(S, H),
                    p + "mlp.shared_experts.down_proj.weight": w(H, S)})
    return out


def write_tokenizer(directory: str) -> None:
    """A byte-level BPE of the 256 byte symbols and no merges, BOS first."""
    from tokenizers import Tokenizer, decoders, pre_tokenizers, processors
    from tokenizers.models import BPE
    symbols = list(pre_tokenizers.ByteLevel.alphabet())
    ids = {s: i for i, s in enumerate(sorted(symbols))}
    ids[BOS] = 256
    ids["<eos>"] = 257
    tok = Tokenizer(BPE(ids, []))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.TemplateProcessing(
        single=f"{BOS} $A", special_tokens=[(BOS, 256)])
    tok.add_special_tokens([BOS, "<eos>"])
    tok.save(os.path.join(directory, "tokenizer.json"))


def write_checkpoint(directory: str, sd: dict = None, shards: int = 0,
                     c: dict = TINY) -> str:
    """An HF-format checkpoint: config.json, tokenizer.json, and the
    weights as model.safetensors or ``shards`` files with their index."""
    from safetensors.torch import save_file
    sd = state_dict(c) if sd is None else sd
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(c, f)
    write_tokenizer(directory)
    if not shards:
        save_file(sd, os.path.join(directory, "model.safetensors"))
        return directory
    names = list(sd)
    weight_map = {}
    for s in range(shards):
        file = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = names[s::shards]
        save_file({n: sd[n] for n in part}, os.path.join(directory, file))
        weight_map.update({n: file for n in part})
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return directory
