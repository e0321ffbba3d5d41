"""A byte-level BPE tokenizer, plainly, in the layout of DeepSeek's (GPT-2's
byte-level BPE with a begin-of-sentence token prepended and none
appended): split the text into words, numbers, runs of other symbols and
white space, each word carrying the space before it ("Ġ" once mapped);
map bytes to printable characters; merge the pair of lowest rank until
none is left; then BOS first, cut to the model's length.

``vocabulary`` makes the benchmark's vocabulary from the seed's words: the
256 byte symbols, then for each word with its space ("Ġword") and bare
(the first word of a text) the merges that join, left to right, the pieces
the merges so far leave of it, so that each word is one token (as most
English words are one token of DeepSeek's), while they fit below the
specials; filler rows up to ``bos_id``, the begin- and end-of-sentence
tokens there (100000 and 100001 at DeepSeek-V2's width), and filler rows
up to the vocabulary size. A merge added later has a higher rank, so it
never changes how an earlier word merges.
"""

import re

from reference.clip_bpe import bytes_to_unicode

BOS, EOS = "<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>"
# GPT-2's pre-tokenizer (transformers' ByteLevel with use_regex), for ASCII
_SPLIT = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+|"
                    r" ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+")


def merge(symbols: list, ranks: dict) -> list:
    """BPE: merge the pair of lowest rank until none is left."""
    while len(symbols) > 1:
        rank, first = min((ranks.get(p, float("inf")), i)
                          for i, p in enumerate(zip(symbols, symbols[1:])))
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
    return symbols


def vocabulary(words, vocab_size: int, bos_id: int):
    """(tokens in id order, merges in rank order)."""
    byte_map = bytes_to_unicode()
    tokens = [byte_map[b] for b in range(256)]
    known = set(tokens)
    merges, ranks = [], {}
    space = byte_map[ord(" ")]
    for word in words:
        for form in (space + word, word):
            pieces = merge(list(form), ranks)
            new = []
            left = pieces[0]
            for right in pieces[1:]:
                new.append((left, right))
                left += right
            if len(tokens) + len(new) > bos_id:
                break
            for left, right in new:
                ranks[(left, right)] = len(merges)
                merges.append((left, right))
                if left + right not in known:
                    known.add(left + right)
                    tokens.append(left + right)
    tokens += [f"<|filler{i}|>" for i in range(bos_id - len(tokens))]
    tokens += [BOS, EOS]
    tokens += [f"<|filler{i}|>" for i in range(len(tokens) - 2,
                                                vocab_size - 2)]
    return tokens, merges


class ByteBPE:
    def __init__(self, tokens: list, merges: list):
        self.ids = {t: i for i, t in enumerate(tokens)}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_map = bytes_to_unicode()
        self.bos = self.ids[BOS]
        self._words = {}

    def _bpe(self, piece: str) -> list:
        ids = self._words.get(piece)
        if ids is None:
            ids = self._words[piece] = [
                self.ids[s] for s in merge(list(piece), self.ranks)]
        return ids

    def encode(self, text: str, max_length: int) -> list:
        ids = [self.bos]
        for piece in _SPLIT.findall(text):
            ids.extend(self._bpe("".join(self.byte_map[b]
                                         for b in piece.encode("utf-8"))))
        return ids[:max_length]
