"""Marqo's default text preprocessing: split a field into sentences and join
``split_length`` of them, ``split_overlap`` shared, into one chunk.

Marqo splits sentences with NLTK's punkt model: a sentence ends at ".", "!"
or "?" followed by white space, except after a common abbreviation or a
single initial. This is that rule written out plainly.
"""

ABBREVIATIONS = frozenset({
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "no", "vs", "etc",
    "e.g", "i.e", "inc", "ltd", "co", "corp", "fig", "al", "vol", "pp"})


def sentences(text: str) -> list:
    out, current = [], []
    for word in text.split():
        current.append(word)
        if word[-1] in ".!?":
            stem = word.rstrip(".!?").lower()
            if stem in ABBREVIATIONS or (len(stem) == 1 and stem.isalpha()):
                continue
            out.append(" ".join(current))
            current = []
    if current:
        out.append(" ".join(current))
    return out


def chunks(text: str, split_length: int = 2, split_overlap: int = 0) -> list:
    """The chunks Marqo embeds for one text field; an empty field is the
    single chunk " "."""
    units = sentences(text)
    if not units:
        return [" "]
    step = max(1, split_length - split_overlap)
    out = []
    for start in range(0, len(units), step):
        out.append(" ".join(units[start:start + split_length]))
        if start + split_length >= len(units):
            break
    return out
