"""Whole tiny runs on the CPU with the timed path broken underneath: the
comparison has to find each fault the cells can have and ``correct`` come
out false. The faults are planted in the program where it produces its
answer: a token altered in every chunk as it is tokenized, the encoder's
rows handed to the wrong chunks, a search's hits put out of order, every
image and caption vector's elements shifted by one, and those of one
image in four alone, which the widest gap finds where a mean would
dilute it."""

import json

import numpy as np
import pytest

from tiny import run_cell


def alter_a_token(monkeypatch):
    from marqo_tpu_torch.models.tokenizer import TextTokenizer
    original = TextTokenizer.encode_batch

    def encode_batch(self, texts, pad_to=None):
        batch = original(self, texts, pad_to)
        for row, length in enumerate(batch["lengths"]):
            batch["input_ids"][row, max(1, length - 2)] += 1
        return batch

    monkeypatch.setattr(TextTokenizer, "encode_batch", encode_batch)


def shift_the_rows(monkeypatch):
    from marqo_tpu_torch.inference.loaders import TorchHFTextModel
    original = TorchHFTextModel.encode_async

    def encode_async(self, contents, normalize=True, **kwargs):
        resolve = original(self, contents, normalize, **kwargs)
        return lambda: np.roll(resolve(), 1, axis=0)

    monkeypatch.setattr(TorchHFTextModel, "encode_async", encode_async)


def reverse_the_hits(monkeypatch):
    from marqo_tpu_torch.tensor_search import tensor_search
    original = tensor_search.search

    def search(*args, **kwargs):
        answer = original(*args, **kwargs)
        answer["hits"] = answer["hits"][::-1]
        return answer

    monkeypatch.setattr(tensor_search, "search", search)


def alter_the_vectors(monkeypatch):
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    original = TorchCLIPModel.encode

    def encode(self, *args, **kwargs):
        return np.roll(original(self, *args, **kwargs), 1, axis=-1)

    monkeypatch.setattr(TorchCLIPModel, "encode", encode)


def alter_some_images(monkeypatch):
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    original = TorchCLIPModel._encode_images

    def _encode_images(self, contents):
        out = original(self, contents)
        out[::4] = np.roll(out[::4], 1, axis=-1)
        return out

    monkeypatch.setattr(TorchCLIPModel, "_encode_images", _encode_images)


@pytest.mark.parametrize("cell,fault", [
    ("e5_base.bulk_ingest", alter_a_token),
    ("e5_base.bulk_ingest", shift_the_rows),
    ("e5_base.search", alter_a_token),
    ("e5_base.search", reverse_the_hits),
    ("vit_l14.bulk_ingest", alter_the_vectors),
    ("vit_l14.bulk_ingest", alter_some_images),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, line, err = run_cell(cell, 2147483800, capsys)
    assert rc == 0, err[-2000:]
    result = json.loads(line)
    assert result["failed"] == 0
    assert result["correct"] is False, result["checks"]
