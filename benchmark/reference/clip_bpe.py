"""CLIP's byte-level BPE tokenizer, plainly: clean white space, lower-case,
split into words, numbers and runs of other symbols, map bytes to CLIP's
printable characters, mark a word's last symbol with "</w>", merge the
pair of lowest rank until none is left; then <|startoftext|> ...
<|endoftext|>, cut to the context length with the end token kept.

``vocabulary`` makes the benchmark's vocabulary from the seed's words: the
512 byte symbols, one merge for each new left-to-right prefix of a word,
filler rows that no merge makes, and the two specials last (49406 and
49407 at open_clip's width), so the end token has the largest id.
"""

import re

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
_SPLIT = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+")


def bytes_to_unicode() -> dict:
    """CLIP's (and GPT-2's) reversible map of the 256 bytes to printable
    characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def vocabulary(words, vocab_size: int):
    """(tokens in id order, merges in rank order)."""
    base = list(bytes_to_unicode().values())
    tokens = base + [b + "</w>" for b in base]
    known = set(tokens)
    merges = []
    budget = vocab_size - 2 - len(tokens)
    for word in words:
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
        new = []
        left = symbols[0]
        for right in symbols[1:]:
            merged = left + right
            if merged not in known:
                new.append((left, right, merged))
            left = merged
        if len(merges) + len(new) > budget:
            break
        for left, right, merged in new:
            known.add(merged)
            merges.append((left, right))
            tokens.append(merged)
    tokens += [f"<|filler{i}|>" for i in range(vocab_size - 2 - len(tokens))]
    return tokens + [BOS, EOS], merges


class ClipBPE:
    def __init__(self, tokens: list, merges: list):
        self.ids = {t: i for i, t in enumerate(tokens)}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_map = bytes_to_unicode()
        self.bos, self.eos = self.ids[BOS], self.ids[EOS]

    def _bpe(self, word: str) -> list:
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = [(self.ranks.get(p, float("inf")), i)
                     for i, p in enumerate(zip(symbols, symbols[1:]))]
            rank, first = min(pairs)
            if rank == float("inf"):
                break
            pair = (symbols[first], symbols[first + 1])
            merged, i = [], 0
            while i < len(symbols):
                if i < len(symbols) - 1 and (symbols[i], symbols[i + 1]) == pair:
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        return [self.ids[s] for s in symbols]

    def encode(self, text: str, context_length: int) -> list:
        text = " ".join(text.split()).lower()
        ids = [self.bos]
        for piece in _SPLIT.findall(text):
            word = "".join(self.byte_map[b] for b in piece.encode("utf-8"))
            ids.extend(self._bpe(word))
        return ids[:context_length - 1] + [self.eos]
