"""The CLIP family (open_clip ViT-L-14): its checkpoint, index and
reference.

The checkpoint is an HF-format ``CLIPModel`` directory (config.json,
model.safetensors, tokenizer.json), handed to the program as
``modelProperties.localpath``; the reference reads the same files. The
program has no precision of its own below bf16 for CLIP, so the control is
the reference computed in fp8 (``CONTROL``).
"""

import json
import os

import numpy as np

from reference import clip, clip_bpe, corpus, image_prep, images, text_split
from reference.bounds import attention_bound

CONTROL = "reference_fp8"


def model_config(config: dict) -> dict:
    """The open_clip config with the sizes it leaves to defaults."""
    assumed = config["assumed"]
    return {"embed_dim": config["embed_dim"],
            "vision_cfg": dict(config["vision_cfg"], **assumed["vision_cfg"]),
            "text_cfg": dict(config["text_cfg"], **assumed["text_cfg"]),
            "layer_norm_eps": assumed["layer_norm_eps"]}


def vocabulary(config: dict, seed: int) -> tuple:
    words = corpus.words(seed, config["assumed"]["vocabulary_words"])
    tokens, merges = clip_bpe.vocabulary(words,
                                         config["text_cfg"]["vocab_size"])
    return words, tokens, merges


def _shapes(c: dict) -> list:
    v, t, E = c["vision_cfg"], c["text_cfg"], c["embed_dim"]

    def blocks(prefix, layers, width, mlp):
        out = []
        for i in range(layers):
            pre = f"{prefix}.{i}."
            for n in "qkv":
                out += [(pre + f"self_attn.{n}_proj.weight", (width, width)),
                        (pre + f"self_attn.{n}_proj.bias", (width,))]
            out += [(pre + "self_attn.out_proj.weight", (width, width)),
                    (pre + "self_attn.out_proj.bias", (width,)),
                    (pre + "mlp.fc1.weight", (mlp, width)),
                    (pre + "mlp.fc1.bias", (mlp,)),
                    (pre + "mlp.fc2.weight", (width, mlp)),
                    (pre + "mlp.fc2.bias", (width,))]
            for n in ("layer_norm1", "layer_norm2"):
                out += [(pre + n + ".weight", (width,)),
                        (pre + n + ".bias", (width,))]
        return out

    vw, tw, p = v["width"], t["width"], v["patch_size"]
    n = (v["image_size"] // p) ** 2 + 1
    return ([("vision_model.embeddings.class_embedding", (vw,)),
             ("vision_model.embeddings.patch_embedding.weight", (vw, 3, p, p)),
             ("vision_model.embeddings.position_embedding.weight", (n, vw)),
             ("vision_model.pre_layrnorm.weight", (vw,)),
             ("vision_model.pre_layrnorm.bias", (vw,))]
            + blocks("vision_model.encoder.layers", v["layers"], vw,
                     int(vw * v["mlp_ratio"]))
            + [("vision_model.post_layernorm.weight", (vw,)),
               ("vision_model.post_layernorm.bias", (vw,)),
               ("visual_projection.weight", (E, vw)),
               ("text_model.embeddings.token_embedding.weight",
                (t["vocab_size"], tw)),
               ("text_model.embeddings.position_embedding.weight",
                (t["context_length"], tw))]
            + blocks("text_model.encoder.layers", t["layers"], tw,
                     int(tw * t["mlp_ratio"]))
            + [("text_model.final_layer_norm.weight", (tw,)),
               ("text_model.final_layer_norm.bias", (tw,)),
               ("text_projection.weight", (E, tw))])


def _hf_config(c: dict) -> dict:
    v, t = c["vision_cfg"], c["text_cfg"]
    eps = c["layer_norm_eps"]
    return {
        "architectures": ["CLIPModel"], "model_type": "clip",
        "projection_dim": c["embed_dim"], "logit_scale_init_value": 2.6592,
        "text_config": {
            "vocab_size": t["vocab_size"], "hidden_size": t["width"],
            "intermediate_size": int(t["width"] * t["mlp_ratio"]),
            "num_hidden_layers": t["layers"],
            "num_attention_heads": t["heads"],
            "max_position_embeddings": t["context_length"],
            "hidden_act": "gelu", "layer_norm_eps": eps,
            "projection_dim": c["embed_dim"],
            "bos_token_id": t["vocab_size"] - 2,
            "eos_token_id": t["vocab_size"] - 1,
            "pad_token_id": t["vocab_size"] - 1},
        "vision_config": {
            "hidden_size": v["width"],
            "intermediate_size": int(v["width"] * v["mlp_ratio"]),
            "num_hidden_layers": v["layers"],
            "num_attention_heads": v["width"] // v["head_width"],
            "image_size": v["image_size"], "patch_size": v["patch_size"],
            "hidden_act": "gelu", "layer_norm_eps": eps,
            "projection_dim": c["embed_dim"]}}


def _tokenizer_files(tokens: list, merges: list, context: int,
                     directory: str) -> None:
    """CLIP's tokenizer layout (transformers' CLIPTokenizerFast) over the
    benchmark's vocabulary."""
    from tokenizers import Regex, Tokenizer, decoders, normalizers
    from tokenizers import pre_tokenizers, processors
    from tokenizers.models import BPE
    ids = {t: i for i, t in enumerate(tokens)}
    tok = Tokenizer(BPE(ids, [tuple(m) for m in merges],
                        unk_token=clip_bpe.EOS, end_of_word_suffix="</w>",
                        continuing_subword_prefix="", fuse_unk=False))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFC(), normalizers.Replace(Regex(r"\s+"), " "),
        normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"),
            behavior="removed", invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.RobertaProcessing(
        sep=(clip_bpe.EOS, ids[clip_bpe.EOS]),
        cls=(clip_bpe.BOS, ids[clip_bpe.BOS]),
        add_prefix_space=False, trim_offsets=False)
    tok.save(os.path.join(directory, "tokenizer.json"))
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer",
                   "model_max_length": context,
                   "bos_token": clip_bpe.BOS, "eos_token": clip_bpe.EOS,
                   "unk_token": clip_bpe.EOS, "pad_token": clip_bpe.EOS}, f)
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(ids, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in merges)


def write_checkpoint(config: dict, seed: int, directory: str, device) -> list:
    from harness.weights import draw, save
    c = model_config(config)
    os.makedirs(directory, exist_ok=True)
    weights = draw(_shapes(c), seed, device)
    import torch
    weights["logit_scale"] = torch.tensor(2.6592, dtype=torch.bfloat16)
    save(weights, directory)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(_hf_config(c), f)
    words, tokens, merges = vocabulary(config, seed)
    _tokenizer_files(tokens, merges, c["text_cfg"]["context_length"],
                     directory)
    return words


def index_settings(config: dict, seed: int, directory: str,
                   control: bool) -> dict:
    marqo = config["marqo"]
    properties = dict(marqo["model_properties"], localpath=directory)
    return dict(marqo["index"], model=f"{marqo['registry_name']}-{seed}",
                modelProperties=properties)


class Reference:
    """The plain float32 towers over the checkpoint in ``directory``."""

    def __init__(self, config: dict, seed: int, directory: str, device):
        import torch
        self.torch, self.device, self.seed = torch, device, seed
        self.c = model_config(config)
        self.split = config["marqo"]["index"]["textPreprocessing"]
        _, tokens, merges = vocabulary(config, seed)
        self.tokenizer = clip_bpe.ClipBPE(tokens, merges)
        self.path = os.path.join(directory, "model.safetensors")
        self._params = None

    @property
    def params(self) -> dict:
        if self._params is None:
            from safetensors.torch import load_file
            self._params = clip.load(load_file(self.path), self.device)
        return self._params

    @staticmethod
    def is_image(value) -> bool:
        return isinstance(value, str) and value.startswith("http") and \
            value.endswith(".jpg")

    def chunks(self, doc: dict, fields) -> dict:
        """{field: [chunks]}: an image is its one URL, text splits as
        Marqo's default does."""
        return {f: [doc[f]] if self.is_image(doc[f]) else
                text_split.chunks(doc[f], self.split["splitLength"],
                                  self.split["splitOverlap"])
                for f in fields}

    def image_bytes(self, url: str) -> bytes:
        return images.jpeg(self.seed, int(url.rsplit("/", 1)[1][:-4]))

    def token_ids(self, text: str) -> list:
        return self.tokenizer.encode(text, self.c["text_cfg"]["context_length"])

    def embed_field(self, doc: dict, field: str, chunks: list,
                    precision: str) -> np.ndarray:
        torch = self.torch
        with torch.no_grad():
            if self.is_image(doc[field]):
                size = self.c["vision_cfg"]["image_size"]
                pixels = torch.stack([image_prep.pixels(
                    self.image_bytes(u), size) for u in chunks])
                out = clip.encode_images(self.params, self.c,
                                         pixels.to(self.device), precision)
            else:
                context = self.c["text_cfg"]["context_length"]
                ids = torch.full((len(chunks), context),
                                 self.tokenizer.eos, dtype=torch.long)
                for i, text in enumerate(chunks):
                    row = self.token_ids(text)
                    ids[i, :len(row)] = torch.tensor(row)
                out = clip.encode_texts(self.params, self.c,
                                        ids.to(self.device),
                                        self.tokenizer.eos, precision)
        return out.cpu().numpy().astype(np.float32)

    def work(self, doc: dict, fields) -> tuple:
        """(model operations, the image tower's attention's least seconds)
        that the document needs at the published widths: an image's
        operations at 257 tokens, a caption's at its tokens up to the end
        token. Only the image tower's attention runs on a hand-written
        kernel (B2); the caption tower's runs in plain PyTorch."""
        v = self.c["vision_cfg"]
        ops = attention_s = 0.0
        for field, chunks in self.chunks(doc, fields).items():
            for chunk in chunks:
                if self.is_image(chunk):
                    ops += clip.image_flops(self.c)
                    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
                    heads = v["width"] // v["head_width"]
                    attention_s += v["layers"] * attention_bound(
                        1, heads, n, v["head_width"])["bound_s"]
                else:
                    ops += clip.text_flops(self.c, len(self.token_ids(chunk)))
        return ops, attention_s
