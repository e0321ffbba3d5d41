"""The base corpus an index holds before the window: documents of the
mix's shape with the clustered vectors of ``reference.corpus``, fed
through the program's own engine (``StoreEngine.feed``, in the shape the
add path writes them) rather than the encoder, whose 100,000 documents
would take minutes a run.
"""

import numpy as np

from reference import corpus


class BaseCorpus:
    """Titles, body chunks and vectors; row r of ``vectors`` belongs to
    document ``row_doc[r]``: its title, then its body's chunks."""

    def __init__(self, seed: int, words, spec: dict, dim: int, device):
        n = spec["docs"]
        self.ids = [f"{spec['id_prefix']}{seed}-{k}" for k in range(n)]
        self.titles, self.bodies = corpus.base_corpus(seed, n, words, spec)
        counts = np.array([1 + len(b) for b in self.bodies])
        self.row_doc = np.repeat(np.arange(n), counts)
        self.vectors = corpus.clustered_vectors(seed, int(counts.sum()), dim,
                                                device)
        self.starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    def feed(self, engine, index: str, fields) -> None:
        title, body = fields
        for k, doc_id in enumerate(self.ids):
            at = int(self.starts[k])
            chunks = self.bodies[k]
            engine.feed(index, doc_id,
                        {title: self.titles[k], body: " ".join(chunks)},
                        {title: {"chunks": [self.titles[k]],
                                 "embeddings": self.vectors[at:at + 1]},
                         body: {"chunks": chunks,
                                "embeddings":
                                    self.vectors[at + 1:at + 1 + len(chunks)]}})
