"""The BERT family (e5-base-v2): its checkpoint, index and reference.

The checkpoint is an HF-format directory (config.json, model.safetensors,
tokenizer.json), handed to the program as ``modelProperties.localpath``,
the path users take for their own checkpoints; the reference reads the
same files.
"""

import json
import os

import numpy as np

from reference import bert, corpus, text_split, wordpiece
from reference.bounds import attention_bound

# the control is the program's own int8 path (kernel B3), a step below bf16
CONTROL = "program"

HF_KEYS = ("architectures", "attention_probs_dropout_prob", "hidden_act",
           "hidden_dropout_prob", "hidden_size", "initializer_range",
           "intermediate_size", "layer_norm_eps", "max_position_embeddings",
           "model_type", "num_attention_heads", "num_hidden_layers",
           "pad_token_id", "position_embedding_type", "type_vocab_size",
           "vocab_size")


def vocabulary(config: dict, seed: int) -> list:
    """The seed's words (the corpus draws from them) and its tokens."""
    words = corpus.words(seed, config["assumed"]["vocabulary_words"])
    return words, wordpiece.vocabulary(words, config["vocab_size"])


def _shapes(config: dict) -> list:
    H, F = config["hidden_size"], config["intermediate_size"]
    out = [("embeddings.word_embeddings.weight", (config["vocab_size"], H)),
           ("embeddings.position_embeddings.weight",
            (config["max_position_embeddings"], H)),
           ("embeddings.token_type_embeddings.weight",
            (config["type_vocab_size"], H)),
           ("embeddings.LayerNorm.weight", (H,)),
           ("embeddings.LayerNorm.bias", (H,))]
    for i in range(config["num_hidden_layers"]):
        pre = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (H, H)),
                            ("attention.self.key", (H, H)),
                            ("attention.self.value", (H, H)),
                            ("attention.output.dense", (H, H)),
                            ("intermediate.dense", (F, H)),
                            ("output.dense", (H, F))):
            out += [(pre + name + ".weight", shape),
                    (pre + name + ".bias", shape[:1])]
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            out += [(pre + name + ".weight", (H,)), (pre + name + ".bias", (H,))]
    return out


def write_checkpoint(config: dict, seed: int, directory: str, device) -> list:
    """Writes the checkpoint made from ``seed``; returns the seed's words."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    from tokenizers.normalizers import BertNormalizer
    from tokenizers.pre_tokenizers import BertPreTokenizer
    from tokenizers.processors import TemplateProcessing

    from harness.weights import draw, save
    os.makedirs(directory, exist_ok=True)
    save(draw(_shapes(config), seed, device), directory)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({k: config[k] for k in HF_KEYS}, f)
    words, tokens = vocabulary(config, seed)
    ids = {t: i for i, t in enumerate(tokens)}
    tok = Tokenizer(WordPiece(ids, unk_token="[UNK]",
                              max_input_chars_per_word=64))
    tok.normalizer = BertNormalizer(lowercase=True)
    tok.pre_tokenizer = BertPreTokenizer()
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", ids["[CLS]"]), ("[SEP]", ids["[SEP]"])])
    tok.save(os.path.join(directory, "tokenizer.json"))
    return words


def index_settings(config: dict, seed: int, directory: str,
                   control: bool) -> dict:
    """The index the cell creates, its model named by the seed (the
    program caches models by name); ``control`` serves the model in int8
    (the program's own path a step below bf16: kernel B3)."""
    marqo = config["marqo"]
    properties = dict(marqo["model_properties"], localpath=directory)
    name = f"{marqo['registry_name']}-{seed}"
    if control:
        properties["quantize"] = True
        name += "-int8"
    return dict(marqo["index"], model=name, modelProperties=properties)


class Reference:
    """The plain float32 model over the checkpoint in ``directory``."""

    def __init__(self, config: dict, seed: int, directory: str, device):
        import torch
        self.torch, self.config, self.device = torch, config, device
        self.props = config["marqo"]["model_properties"]
        self.split = config["marqo"]["index"]["textPreprocessing"]
        _, tokens = vocabulary(config, seed)
        self.tokenizer = wordpiece.WordPiece(tokens)
        self.path = os.path.join(directory, "model.safetensors")
        self._params = None

    @property
    def params(self) -> dict:
        if self._params is None:
            from safetensors.torch import load_file
            self._params = bert.load(load_file(self.path), self.device)
        return self._params

    def chunks(self, doc: dict, fields) -> dict:
        """{field: [chunk texts]} as Marqo splits the document."""
        return {f: text_split.chunks(doc[f], self.split["splitLength"],
                                     self.split["splitOverlap"])
                for f in fields}

    def token_ids(self, text: str, prefix_key: str) -> list:
        return self.tokenizer.encode(self.props.get(prefix_key, "") + text,
                                     self.props["tokens"])

    def embed(self, texts, prefix_key: str = "text_chunk_prefix",
              precision: str = "float32", block: int = 64) -> np.ndarray:
        """Unit vectors of ``texts`` (chunks, or queries with
        ``text_query_prefix``), in blocks of ``block`` rows."""
        torch = self.torch
        out = []
        for start in range(0, len(texts), block):
            rows = [self.token_ids(t, prefix_key)
                    for t in texts[start:start + block]]
            width = max(len(r) for r in rows)
            ids = torch.zeros((len(rows), width), dtype=torch.long)
            mask = torch.zeros((len(rows), width), dtype=torch.long)
            for i, r in enumerate(rows):
                ids[i, :len(r)] = torch.tensor(r)
                mask[i, :len(r)] = 1
            with torch.no_grad():
                out.append(bert.encode(self.params, self.config,
                                       ids.to(self.device),
                                       mask.to(self.device),
                                       precision).cpu().numpy())
        return np.concatenate(out).astype(np.float32)

    def embed_field(self, doc: dict, field: str, chunks: list,
                    precision: str) -> np.ndarray:
        return self.embed(chunks, "text_chunk_prefix", precision)

    def work(self, doc: dict, fields) -> tuple:
        """(model operations, attention's least seconds) that the document's
        chunks need at the published widths."""
        c = self.config
        heads = c["num_attention_heads"]
        width = c["hidden_size"] // heads
        ops = attn = 0.0
        for texts in self.chunks(doc, fields).values():
            for text in texts:
                n = len(self.token_ids(text, "text_chunk_prefix"))
                ops += bert.flops(c, n)
                attn += c["num_hidden_layers"] * attention_bound(
                    1, heads, n, width)["bound_s"]
        return ops, attn
