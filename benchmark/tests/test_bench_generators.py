"""The inputs repeat for a seed and differ across seeds; the bulk base
corpus splits as the reference splits one document."""

import numpy as np
import pytest

from reference import corpus, images, text_split

TEXT = {"id_prefix": "d", "title_words": [4, 12], "body_lognormal": [4.1, 0.45],
        "body_clip": [16, 512], "sentence_words": [6, 30], "split_length": 2}
IMAGE = {"id_prefix": "i", "image_pool": 1024, "caption_words": [8, 20]}
QUERY = {"query_lognormal": [1.8, 0.45], "query_words": [3, 16]}
SEEDS = (2147483659, 2147483660)


def make(kind, seed):
    words = corpus.words(seed, 500)
    if kind == "words":
        return words
    if kind == "text":
        return [corpus.text_document(seed, k, words, TEXT) for k in range(20)]
    if kind == "image":
        return [corpus.image_document(seed, k, words, IMAGE, "http://h")
                for k in range(20)]
    if kind == "query":
        return [corpus.query(seed, k, words, QUERY) for k in range(20)]
    if kind == "arrivals":
        return corpus.arrivals(seed, 50.0, 2.0).tolist()
    if kind == "base":
        return corpus.base_corpus(seed, 50, words, TEXT)
    if kind == "vectors":
        return corpus.clustered_vectors(seed, 600, 16).tolist()
    if kind == "jpeg":
        return images.jpeg(seed, 3)
    raise ValueError(kind)


KINDS = ("words", "text", "image", "query", "arrivals", "base", "vectors",
         "jpeg")


@pytest.mark.parametrize("kind", KINDS)
def test_repeats_for_a_seed(kind):
    assert make(kind, SEEDS[0]) == make(kind, SEEDS[0])


@pytest.mark.parametrize("kind", KINDS)
def test_differs_across_seeds(kind):
    assert make(kind, SEEDS[0]) != make(kind, SEEDS[1])


def test_every_seed_offers_the_same_load():
    a, b = (corpus.arrivals(s, 120.0, 10.0) for s in SEEDS)
    assert len(a) == len(b) == 1200
    assert 0 <= a.min() and a.max() < 10.0


def test_shapes_follow_the_mix():
    docs = make("text", SEEDS[0])
    for doc in docs:
        assert 4 <= len(doc["title"].split()) <= 12
        assert 14 <= len(doc["body"].split()) <= 510
        for sentence in text_split.sentences(doc["body"]):
            assert 6 <= len(sentence.split()) <= 2 * 30
    n = [len(q.split()) for q in make("query", SEEDS[0])]
    assert 3 <= min(n) and max(n) <= 16


def test_base_corpus_splits_as_the_reference():
    titles, bodies = make("base", SEEDS[0])
    assert len(titles) == len(bodies) == 50
    for chunks in bodies:
        assert text_split.chunks(" ".join(chunks)) == chunks


def test_vectors_are_unit_and_clustered():
    v = np.asarray(make("vectors", SEEDS[0]), dtype=np.float32)
    assert np.allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
    # clustered: a row's nearest other row is far closer than a random one
    sims = v @ v.T
    np.fill_diagonal(sims, -1)
    assert np.median(sims.max(1)) > np.median(sims) + 0.3
