"""The DeepSeek-V2 family (DeepSeek-V2-Lite as a mean-pooled text
embedder): its checkpoint, index and reference.

The checkpoint is an HF-format directory as the published one is laid out
(config.json, tokenizer.json, the weights in safetensors shards named by
``model.safetensors.index.json``), handed to the program as
``modelProperties.localpath``, the path users take for their own
checkpoints; the reference reads the same files. Its 31 GB of weights are
drawn from the configuration's ``weights_seed``, shard by shard on the
card (the host never holds more than a shard), and written once per
checkout under ``build/benchmark_checkpoints/``; each run links them into
its own directory beside the tokenizer of its seed's words, as the base
corpus keeps its snapshot. The program has no precision of its own below
bf16 for this model, so the control is the reference computed in fp8.
"""

import hashlib
import json
import os
import shutil
import sys
import time

import numpy as np

from reference import byte_bpe, corpus, deepseek_v2, text_split

CONTROL = "reference_fp8"

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NORMS = ("input_layernorm", "post_attention_layernorm", "kv_a_layernorm",
         "norm")
# room a run needs on the disk beside the weights it writes: the kernels'
# build, the base corpus's snapshot, temporary files
DISK_SPARE_BYTES = 8 * 10 ** 9
# keys the published config.json has beside the catalog's
EXTRA_HF = {"architectures": ["DeepseekV2ForCausalLM"],
            "torch_dtype": "bfloat16"}


def hf_config(config: dict) -> dict:
    """config.json: every key of the configuration but the benchmark's own."""
    own = ("family", "served_dtype", "source", "reduced", "why", "marqo",
           "assumed")
    out = {k: v for k, v in config.items() if k not in own}
    assumed = config["assumed"]
    return dict(out, **EXTRA_HF, bos_token_id=assumed["bos_token_id"],
                eos_token_id=assumed["eos_token_id"])


def vocabulary(config: dict, seed: int) -> tuple:
    """The seed's words (the corpus draws from them), the tokens and the
    merges."""
    words = corpus.words(seed, config["assumed"]["vocabulary_words"])
    tokens, merges = byte_bpe.vocabulary(words, config["vocab_size"],
                                         config["assumed"]["bos_token_id"])
    return words, tokens, merges


def _layer_shapes(c: dict, i: int) -> list:
    H, N = c["hidden_size"], c["num_attention_heads"]
    nope, rd, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank = c["kv_lora_rank"]
    pre = f"model.layers.{i}."
    out = [(pre + "input_layernorm.weight", (H,)),
           (pre + "post_attention_layernorm.weight", (H,)),
           (pre + "self_attn.q_proj.weight", (N * (nope + rd), H)),
           (pre + "self_attn.kv_a_proj_with_mqa.weight", (rank + rd, H)),
           (pre + "self_attn.kv_a_layernorm.weight", (rank,)),
           (pre + "self_attn.kv_b_proj.weight", (N * (nope + dv), rank)),
           (pre + "self_attn.o_proj.weight", (H, N * dv))]

    def swiglu(prefix, width):
        return [(prefix + "gate_proj.weight", (width, H)),
                (prefix + "up_proj.weight", (width, H)),
                (prefix + "down_proj.weight", (H, width))]

    if i < c["first_k_dense_replace"]:
        return out + swiglu(pre + "mlp.", c["intermediate_size"])
    F = c["moe_intermediate_size"]
    out.append((pre + "mlp.gate.weight", (c["n_routed_experts"], H)))
    for e in range(c["n_routed_experts"]):
        out += swiglu(pre + f"mlp.experts.{e}.", F)
    return out + swiglu(pre + "mlp.shared_experts.",
                        F * c["n_shared_experts"])


def shards(c: dict) -> list:
    """[(file, [(name, shape)])]: the embeddings first, ``layers_per_shard``
    layers a file, the final norm last; no LM head."""
    per = c["assumed"]["layers_per_shard"]
    H = c["hidden_size"]
    groups = [[("model.embed_tokens.weight", (c["vocab_size"], H))]]
    layers = c["num_hidden_layers"]
    for start in range(0, layers, per):
        groups.append([s for i in range(start, min(start + per, layers))
                       for s in _layer_shapes(c, i)])
    groups[-1].append(("model.norm.weight", (H,)))
    n = len(groups)
    return [(f"model-{k + 1:05d}-of-{n:05d}.safetensors", g)
            for k, g in enumerate(groups)]


# the assumed keys that shape the drawn weights
WEIGHT_KEYS = ("weights_seed", "layers_per_shard", "weight_std", "router_std")


def weight_std(name: str, assumed: dict) -> float:
    """The normal std a weight is drawn with: the router's ``router_std``,
    every other weight's ``weight_std``."""
    if name.endswith(".mlp.gate.weight"):
        return assumed["router_std"]
    return assumed["weight_std"]


def _draw_shard(shapes, seed: int, assumed: dict, device) -> dict:
    """{name: bf16 tensor on the host}: normal at ``weight_std``, RMSNorm
    scales 1 + ``weight_std`` n, drawn on ``device`` in one call."""
    import math

    import torch
    sizes = [math.prod(shape) for _, shape in shapes]
    generator = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=torch.bfloat16)
    out, start = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        tensor = flat[start:start + size].view(shape)
        tensor.mul_(weight_std(name, assumed))
        if name.split(".")[-2] in NORMS:
            tensor += 1
        out[name] = tensor
        start += size
    host = {name: t.cpu() for name, t in out.items()}
    del flat, out
    return host


def weights_dir(config: dict) -> str:
    """The checkout's directory of the configuration's weights: named by a
    digest of what shapes them."""
    assumed = config["assumed"]
    shaped = json.dumps([hf_config(config),
                         {k: assumed[k] for k in WEIGHT_KEYS}],
                        sort_keys=True)
    digest = hashlib.sha256(shaped.encode()).hexdigest()[:12]
    return os.path.join(CHECKOUT, "build", "benchmark_checkpoints",
                        f"deepseek_v2-{digest}")


def _log(message: str) -> None:
    print(f"deepseek_v2 checkpoint: {message}", file=sys.stderr, flush=True)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def remove_stale_partials(parent: str) -> None:
    """Remove the partial weight directories that runs killed mid-write
    left under ``parent`` (their process gone): each may hold up to 31 GB."""
    for name in os.listdir(parent):
        stem, _, pid = name.rpartition(".partial-")
        if stem.startswith("deepseek_v2-") and pid.isdigit() and \
                not _pid_alive(int(pid)):
            _log(f"removing {name}, left by a run that ended mid-write")
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)


def weight_bytes(config: dict) -> int:
    """Bytes of the checkpoint's bf16 weights."""
    import math
    return sum(2 * math.prod(shape) for _, shapes in shards(config)
               for _, shape in shapes)


def ensure_weights(config: dict, device) -> str:
    """The weights' directory, written first where this checkout has none:
    drawn shard by shard, each saved before the next is drawn. Raises
    SystemExit before writing where the disk cannot hold them."""
    from safetensors.torch import save_file
    target = weights_dir(config)
    if os.path.isfile(os.path.join(target, "model.safetensors.index.json")):
        return target
    parent = os.path.dirname(target)
    os.makedirs(parent, exist_ok=True)
    remove_stale_partials(parent)
    free, needed = shutil.disk_usage(parent).free, weight_bytes(config)
    _log(f"{free / 1e9:.1f} GB free under {parent} before writing "
         f"{needed / 1e9:.2f} GB")
    if free < needed + DISK_SPARE_BYTES:
        raise SystemExit(
            f"deepseek_v2 checkpoint: {needed / 1e9:.2f} GB of weights and "
            f"{DISK_SPARE_BYTES / 1e9:.0f} GB spare do not fit the "
            f"{free / 1e9:.1f} GB free under {parent}")
    # a directory of this process's own: runs of one checkout at once each
    # write theirs, and the first to finish names it
    partial = f"{target}.partial-{os.getpid()}"
    os.makedirs(partial)
    started = time.time()
    weight_map, total = {}, 0
    seed = config["assumed"]["weights_seed"]
    for k, (file, shapes) in enumerate(shards(config)):
        tensors = _draw_shard(shapes, seed * 1000 + k, config["assumed"],
                              device)
        save_file(tensors, os.path.join(partial, file),
                  metadata={"format": "pt"})
        total += sum(t.numel() * 2 for t in tensors.values())
        weight_map.update({name: file for name, _ in shapes})
        del tensors
    with open(os.path.join(partial, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    try:
        os.replace(partial, target)
    except OSError:
        if not os.path.isfile(os.path.join(target,
                                           "model.safetensors.index.json")):
            raise
        shutil.rmtree(partial)
    _log(f"{total / 1e9:.2f} GB written in {time.time() - started:.1f} s; "
         f"{shutil.disk_usage(parent).free / 1e9:.1f} GB free after")
    return target


def _tokenizer_files(tokens: list, merges: list, config: dict,
                     directory: str) -> None:
    """DeepSeek's tokenizer layout (a byte-level BPE, BOS prepended) over
    the benchmark's vocabulary."""
    from tokenizers import Tokenizer, decoders, pre_tokenizers, processors
    from tokenizers.models import BPE
    ids = {t: i for i, t in enumerate(tokens)}
    tok = Tokenizer(BPE(ids, [tuple(m) for m in merges], fuse_unk=False))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                                 use_regex=True)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.TemplateProcessing(
        single=f"{byte_bpe.BOS} $A",
        special_tokens=[(byte_bpe.BOS, ids[byte_bpe.BOS])])
    tok.add_special_tokens([byte_bpe.BOS, byte_bpe.EOS])
    tok.save(os.path.join(directory, "tokenizer.json"))


def check_program_serves(config: dict, directory: str) -> None:
    """Raise SystemExit where the program under test has no model of its
    own for a ``deepseek_v2`` checkpoint under the ``hf`` type (it would
    load it as BERT and fail each add): asked of its dispatch over a
    directory holding the config.json alone, before 31 GB are written."""
    from marqo_tpu_torch.inference import loaders
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf_config(config), f)
    served = loaders.resolve_model_class(
        "probe", dict(config["marqo"]["model_properties"],
                      localpath=directory))
    if served is loaders.TorchHFTextModel:
        raise SystemExit("the program under test serves no deepseek_v2 "
                         "model: its hf type would load the checkpoint as "
                         "BERT")


def write_checkpoint(config: dict, seed: int, directory: str, device) -> list:
    """The run's checkpoint: the checkout's weights linked in, config.json
    and the seed's tokenizer written; returns the seed's words."""
    check_program_serves(config, directory)
    weights = ensure_weights(config, device)
    os.makedirs(directory, exist_ok=True)
    for name in os.listdir(weights):
        os.symlink(os.path.join(weights, name), os.path.join(directory, name))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf_config(config), f)
    words, tokens, merges = vocabulary(config, seed)
    _tokenizer_files(tokens, merges, config, directory)
    return words


def index_settings(config: dict, seed: int, directory: str,
                   control: bool) -> dict:
    """The index the cell creates, its model named by the seed (the program
    caches models by name)."""
    marqo = config["marqo"]
    properties = dict(marqo["model_properties"], localpath=directory)
    return dict(marqo["index"], model=f"{marqo['registry_name']}-{seed}",
                modelProperties=properties)


class Reference:
    """The plain float32 model over the checkpoint in ``directory``, its
    weights read once and kept on ``device`` in their stored bf16, each
    layer's cast to float32 as it runs (``deepseek_v2.Weights``)."""

    def __init__(self, config: dict, seed: int, directory: str, device):
        import torch
        self.torch, self.device = torch, device
        self.c = deepseek_v2.read_config(directory)
        self.props = config["marqo"]["model_properties"]
        self.split = config["marqo"]["index"]["textPreprocessing"]
        _, tokens, merges = vocabulary(config, seed)
        self.tokenizer = byte_bpe.ByteBPE(tokens, merges)
        self.weights = deepseek_v2.Weights(directory, device, keep=True)
        self._ids = {}

    def chunks(self, doc: dict, fields) -> dict:
        """{field: [chunk texts]} as Marqo splits the document."""
        return {f: text_split.chunks(doc[f], self.split["splitLength"],
                                     self.split["splitOverlap"])
                for f in fields}

    def token_ids(self, text: str) -> list:
        """BOS and the text's tokens (the configuration has no prefixes),
        cut to the model's length; remembered, as the metrics ask again."""
        ids = self._ids.get(text)
        if ids is None:
            ids = self._ids[text] = self.tokenizer.encode(
                text, self.props["tokens"])
        return ids

    def embed(self, texts, precision: str = "float32") -> np.ndarray:
        """Unit vectors of ``texts``, one padded batch through the model."""
        torch = self.torch
        rows = [self.token_ids(t) for t in texts]
        width = max(len(r) for r in rows)
        ids = torch.zeros((len(rows), width), dtype=torch.long)
        mask = torch.zeros((len(rows), width), dtype=torch.long)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = torch.tensor(r)
            mask[i, :len(r)] = 1
        with torch.no_grad():
            out = deepseek_v2.encode(self.weights, self.c, ids, mask,
                                     precision)
        return out.cpu().numpy().astype(np.float32)

    def embed_field(self, doc: dict, field: str, chunks: list,
                    precision: str) -> np.ndarray:
        return self.embed(chunks, precision)

    def _lengths(self, doc: dict, fields) -> list:
        return [len(self.token_ids(text)) for texts in
                self.chunks(doc, fields).values() for text in texts]

    def work(self, doc: dict, fields) -> tuple:
        """(model operations, causal attention's least seconds) that the
        document's chunks need at the published widths."""
        layers = self.c["num_hidden_layers"]
        ops = attention_s = 0.0
        for n in self._lengths(doc, fields):
            ops += deepseek_v2.flops(self.c, n)
            attention_s += layers * deepseek_v2.attention_bound_s(self.c, n)
        return ops, attention_s

    def expert_work(self, doc: dict, fields) -> float:
        """Operations of the routed experts over the document's real
        tokens (the shared ones run as a dense SwiGLU, outside the grouped
        GEMM)."""
        return sum(deepseek_v2.expert_flops(self.c, n, shared=False)
                   for n in self._lengths(doc, fields))

    def expert_weight_bytes(self) -> float:
        """Bytes of the routed experts' weights."""
        return deepseek_v2.expert_weight_bytes(self.c, shared=False)
