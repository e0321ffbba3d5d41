"""BERT's WordPiece tokenizer, plainly: lower-case, split on white space and
punctuation, take the longest piece of the vocabulary from the left (later
pieces with "##"), a word with no split is [UNK]; then [CLS] ... [SEP].

``vocabulary`` makes the benchmark's word-level vocabulary: the specials,
the full stop and comma, single letters with and without "##", the seed's
words, and [unusedN] rows up to the model's vocabulary size.
"""

import unicodedata

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
_ALPHABET = list("abcdefghijklmnopqrstuvwxyz0123456789")


def vocabulary(words, vocab_size: int) -> list:
    tokens = SPECIALS + [".", ","] + _ALPHABET + ["##" + c for c in _ALPHABET]
    tokens += [w for w in words if w not in set(tokens)]
    if len(tokens) > vocab_size:
        raise ValueError(f"{len(tokens)} tokens exceed {vocab_size}")
    tokens += [f"[unused{i}]" for i in range(vocab_size - len(tokens))]
    return tokens


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _basic(text: str) -> list:
    text = unicodedata.normalize("NFD", text.lower())
    text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out = []
    for word in text.split():
        current = ""
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    out.append(current)
                out.append(ch)
                current = ""
            else:
                current += ch
        if current:
            out.append(current)
    return out


class WordPiece:
    def __init__(self, tokens: list):
        self.ids = {t: i for i, t in enumerate(tokens)}
        self.unk, self.cls, self.sep = (self.ids[t] for t in
                                        ("[UNK]", "[CLS]", "[SEP]"))

    def _word(self, word: str) -> list:
        if len(word) > 64:
            return [self.unk]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.ids:
                    out.append(self.ids[piece])
                    break
                end -= 1
            if end == start:
                return [self.unk]
            start = end
        return out

    def encode(self, text: str, max_length: int) -> list:
        """[CLS] pieces [SEP], cut to ``max_length`` ids."""
        ids = [self.cls]
        for word in _basic(text):
            ids.extend(self._word(word))
        ids.append(self.sep)
        return ids[:max_length]
