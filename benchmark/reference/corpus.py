"""Inputs made from a seed: the word vocabulary, documents, captions,
queries and the base corpus's clustered unit vectors.

The passage lengths follow the repository's bench.py ``build_text_corpus``
(log-normal, mu 4.1, sigma 0.45, one vocabulary word to one word piece);
the clustered vectors follow perf_tests/engine_bench.py ``make_corpus``
(a mixture of Gaussians around n/250 centres, normalised: uniform vectors
are HNSW's worst case and no real corpus looks like them). Both are copied
here in NumPy so that the benchmark imports neither.

Every function is a pure function of its arguments: document ``k`` of a
seed is the same wherever it is made, so the reference can remake any
document that the load generator sent.
"""

import numpy as np

from reference.text_split import ABBREVIATIONS

# English letter frequencies (per cent), a to z
_LETTER_P = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15,
                      0.77, 4.0, 2.4, 6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1,
                      2.8, 0.98, 2.4, 0.15, 2.0, 0.074])
_LETTER_P = _LETTER_P / _LETTER_P.sum()
_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def words(seed: int, n_words: int) -> list:
    """``n_words`` distinct lowercase words of 3 to 10 letters."""
    rng = np.random.default_rng([seed, 0x766f63])
    out, seen = [], set()
    while len(out) < n_words:
        n = 2 * (n_words - len(out)) + 64
        lengths = rng.integers(3, 11, size=n)
        letters = _LETTERS[rng.choice(26, size=(n, 10), p=_LETTER_P)]
        for row, length in zip(letters, lengths):
            word = "".join(row[:length])
            if word not in seen and word not in ABBREVIATIONS:
                seen.add(word)
                out.append(word)
                if len(out) == n_words:
                    break
    return out


def _rng(seed: int, stream: int, k: int):
    return np.random.default_rng([seed, stream, k])


def _phrase(rng, vocab, lo: int, hi: int) -> str:
    n = int(rng.integers(lo, hi + 1))
    return " ".join(vocab[i] for i in rng.integers(0, len(vocab), size=n))


def passage_lengths(rng, n: int, mu: float, sigma: float, lo: int,
                    hi: int) -> np.ndarray:
    """bench.py's passage lengths: log-normal, clipped to [lo, hi]."""
    return np.clip(rng.lognormal(mean=mu, sigma=sigma, size=n),
                   lo, hi).astype(np.int64)


def text_document(seed: int, k: int, vocab, spec: dict) -> dict:
    """Document ``k``: a title of ``title_words`` words, and a body whose
    length in words is log-normal (``body_lognormal`` mu, sigma, clipped to
    ``body_clip``, less the two special tokens), in sentences of
    ``sentence_words`` words, each ending with a full stop."""
    rng = _rng(seed, 0x646f63, k)
    title = _phrase(rng, vocab, *spec["title_words"])
    mu, sigma = spec["body_lognormal"]
    n = int(passage_lengths(rng, 1, mu, sigma, *spec["body_clip"])[0]) - 2
    lo, hi = spec["sentence_words"]
    ids = rng.integers(0, len(vocab), size=n)
    sentences, start = [], 0
    while start < n:
        size = int(rng.integers(lo, hi + 1))
        if n - (start + size) < lo:
            size = n - start
        sentences.append(" ".join(vocab[i] for i in ids[start:start + size])
                         + ".")
        start += size
    return {"_id": f"{spec['id_prefix']}{seed}-{k}", "title": title,
            "body": " ".join(sentences)}


def image_document(seed: int, k: int, vocab, spec: dict, base_url: str) -> dict:
    """Document ``k``: an image URL of its own and a caption of
    ``caption_words`` words. The URL names the pool image it serves."""
    rng = _rng(seed, 0x696d67, k)
    image = int(rng.integers(0, spec["image_pool"]))
    return {"_id": f"{spec['id_prefix']}{seed}-{k}",
            "image": f"{base_url}/{seed}/{k}/{image}.jpg",
            "caption": _phrase(rng, vocab, *spec["caption_words"])}


def query(seed: int, k: int, vocab, spec: dict) -> str:
    """Query ``k``: log-normal word count (``query_lognormal``) clipped to
    ``query_words``."""
    rng = _rng(seed, 0x717279, k)
    mu, sigma = spec["query_lognormal"]
    n = int(passage_lengths(rng, 1, mu, sigma, *spec["query_words"])[0])
    return " ".join(vocab[i] for i in rng.integers(0, len(vocab), size=n))


def clustered_vectors(seed: int, n: int, dim: int, device="cpu") -> np.ndarray:
    """engine_bench.py ``make_corpus``: ``n`` unit vectors in clusters of
    about 250 around ``n // 250`` centres, drawn on ``device`` in bulk."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed * 7919 + 0x766563)
    centers = torch.randn((max(8, n // 250), dim), generator=g,
                          device=device) * 3
    pick = torch.randint(0, len(centers), (n,), generator=g, device=device)
    data = centers[pick] + torch.randn((n, dim), generator=g, device=device)
    data /= data.norm(dim=1, keepdim=True)
    return data.cpu().numpy()


def base_corpus(seed: int, n_docs: int, vocab, spec: dict) -> tuple:
    """``n_docs`` documents of ``text_document``'s shape, drawn in bulk:
    (titles, body chunks per document). Sentences end with a full stop and
    the chunks join ``split_length`` of them, as Marqo's default split
    does (the vocabulary holds no abbreviation, so every full stop ends a
    sentence)."""
    rng = np.random.default_rng([seed, 0x626173])
    vocab = np.asarray(vocab, dtype=object)
    lo, hi = spec["title_words"]
    t_len = rng.integers(lo, hi + 1, size=n_docs)
    t_words = vocab[rng.integers(0, len(vocab), size=int(t_len.sum()))]
    t_ends = np.cumsum(t_len)
    titles = [" ".join(t_words[e - k:e]) for e, k in zip(t_ends, t_len)]
    mu, sigma = spec["body_lognormal"]
    b_len = passage_lengths(rng, n_docs, mu, sigma, *spec["body_clip"]) - 2
    b_words = vocab[rng.integers(0, len(vocab), size=int(b_len.sum()))]
    s_lo, s_hi = spec["sentence_words"]
    per = spec["split_length"]
    sizes = rng.integers(s_lo, s_hi + 1, size=int(b_len.sum()) // s_lo + n_docs)
    bodies, start, s = [], 0, 0
    for n in b_len.tolist():
        sentences, used = [], 0
        while used < n:
            size = int(sizes[s])
            s += 1
            if n - (used + size) < s_lo:
                size = n - used
            sentences.append(" ".join(b_words[start + used:start + used + size])
                             + ".")
            used += size
        start += n
        bodies.append([" ".join(sentences[i:i + per])
                       for i in range(0, len(sentences), per)])
    return titles, bodies


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """A Poisson process of ``rate`` over ``seconds``, conditioned on its
    count: round(rate x seconds) arrival times, sorted uniforms. Every seed
    offers the same number of requests, at other times."""
    rng = np.random.default_rng([seed, 0x617272])
    return np.sort(rng.uniform(0.0, seconds, size=int(round(rate * seconds))))
