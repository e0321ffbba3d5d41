"""The plain reference against the port at a tiny size on the CPU, both
reading the checkpoint the benchmark writes: the split, the tokenizers
(exactly), the BERT encoder and both CLIP towers (the port computing in
float32 here, within float32's rounding), and open_clip's preprocessing
where its size arithmetic and the port's agree."""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import BENCH
from reference import corpus, image_prep, images, text_split
from tiny import BERT, CLIP

import run as bench

SEED = 2147483901
TEXT = {"id_prefix": "d", "title_words": [4, 12], "body_lognormal": [4.1, 0.45],
        "body_clip": [16, 512], "sentence_words": [6, 30]}


def family_and_config(name: str, tiny: dict):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        config = bench.merge(json.load(f), tiny)
    family = bench.load_module(os.path.join(BENCH, "families",
                                            f"{config['family']}.py"),
                               f"family_{config['family']}")
    return family, config


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    family, config = family_and_config("e5_base_v2", BERT)
    path = str(tmp_path_factory.mktemp("bert"))
    words = family.write_checkpoint(config, SEED, path, "cpu")
    return family, config, path, words


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    family, config = family_and_config("vit_l14", CLIP)
    path = str(tmp_path_factory.mktemp("clip"))
    words = family.write_checkpoint(config, SEED, path, "cpu")
    return family, config, path, words


def texts(words, n=40):
    docs = [corpus.text_document(SEED, k, words, TEXT) for k in range(n)]
    return [d["title"] for d in docs] + \
        [c for d in docs for c in text_split.chunks(d["body"])]


def test_split_matches_the_port(bert):
    from marqo_tpu_torch.core.models.marqo_index import (TextPreProcessing,
                                                         TextSplitMethod)
    from marqo_tpu_torch.inference.text_chunker import chunk_text
    _, _, _, words = bert
    setting = TextPreProcessing(split_length=2, split_overlap=0,
                                split_method=TextSplitMethod.Sentence)
    for k in range(60):
        body = corpus.text_document(SEED, k, words, TEXT)["body"]
        assert text_split.chunks(body) == chunk_text(body, setting)


def test_wordpiece_matches_the_port(bert):
    from marqo_tpu_torch.models.tokenizer import TextTokenizer
    family, config, path, words = bert
    reference = family.Reference(config, SEED, path, "cpu")
    port = TextTokenizer.from_pretrained(path, max_length=512)
    batch = texts(words) + ["Query: it's, e.g. UPPER case!"]
    encoded = port.encode_batch(batch)
    for i, text in enumerate(batch):
        ids = reference.tokenizer.encode(text, 512)
        assert encoded["input_ids"][i, :len(ids)].tolist() == ids
        assert encoded["lengths"][i] == len(ids)


def test_bert_matches_the_port(bert, monkeypatch):
    from marqo_tpu_torch.inference.loaders import TorchHFTextModel
    from marqo_tpu_torch.inference.types import Device
    family, config, path, words = bert
    monkeypatch.setattr(TorchHFTextModel, "compute_dtype", torch.float32)
    port = TorchHFTextModel("tiny-e5", dict(
        config["marqo"]["model_properties"], localpath=path, name="tiny-e5"),
        Device.CPU)
    port.load()
    batch = texts(words, 12)
    got = port.encode(batch)
    want = family.Reference(config, SEED, path, "cpu").embed(batch, "none")
    assert np.abs(got - want).max() < 1e-4


def test_clip_bpe_matches_the_port(clip):
    from transformers import CLIPTokenizerFast
    family, config, path, words = clip
    reference = family.Reference(config, SEED, path, "cpu")
    port = CLIPTokenizerFast.from_pretrained(path)
    captions = [corpus.image_document(SEED, k, words, {
        "id_prefix": "i", "image_pool": 4, "caption_words": [8, 20]}, "")
        ["caption"] for k in range(80)] + [" ".join(words[:120])]
    for caption in captions:
        want = reference.token_ids(caption)
        got = port(caption, truncation=True, max_length=77)["input_ids"]
        assert got == want


def test_clip_towers_match_the_port(clip, monkeypatch):
    from marqo_tpu_torch.inference.types import Device
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    from reference import clip as plain
    family, config, path, words = clip
    monkeypatch.setattr(TorchCLIPModel, "compute_dtype", torch.float32)
    port = TorchCLIPModel("tiny-clip", dict(
        config["marqo"]["model_properties"], localpath=path), Device.CPU)
    port.load()
    reference = family.Reference(config, SEED, path, "cpu")
    captions = [" ".join(words[i:i + 9]) for i in range(0, 90, 9)]
    got = port.encode(captions)
    want = reference.embed_field({"c": "x"}, "c", captions, "float32")
    assert np.abs(got - want).max() < 1e-4
    size = reference.c["vision_cfg"]["image_size"]
    crops = np.stack([np.asarray(Image.open(io.BytesIO(images.jpeg(SEED, i)))
                                 .convert("RGB").resize((size, size)))
                      for i in range(4)])
    got = port._run(crops, "vision")
    got /= np.linalg.norm(got, axis=-1, keepdims=True)
    pixels = torch.from_numpy(crops.astype(np.float32) / 255.0)
    pixels = ((pixels - torch.tensor(plain.MEAN)) / torch.tensor(plain.STD))
    want = plain.encode_images(reference.params, reference.c,
                               pixels.permute(0, 3, 1, 2))
    assert np.abs(got - want.numpy()).max() < 1e-4


def test_image_prep_matches_the_port_at_whole_scales(clip):
    from marqo_tpu_torch.inference.types import Device
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    from reference import clip as plain
    family, config, path, _ = clip
    port = TorchCLIPModel("tiny-clip-prep", dict(
        config["marqo"]["model_properties"], localpath=path), Device.CPU)
    port.load()
    size = port.vision_config.image_size
    for w, h in ((3 * size, 2 * size), (2 * size, 4 * size)):
        buf = io.BytesIO()
        Image.open(io.BytesIO(images.jpeg(SEED, 0))).resize((w, h)).save(
            buf, format="JPEG", quality=90)
        crop = port._preprocess_host(buf.getvalue()).astype(np.float32) / 255
        crop = (crop - np.asarray(plain.MEAN)) / np.asarray(plain.STD)
        want = image_prep.pixels(buf.getvalue(), size).permute(1, 2, 0)
        assert np.abs(crop - want.numpy()).max() < 1e-5
