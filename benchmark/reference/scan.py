"""An exact scan in NumPy: Marqo's tensor search over an unstructured
index scores every chunk of every searched field by closeness (Vespa's
1 / (1 + distance), distance 1 - cos for prenormalised-angular), a
document by its best chunk, and ranks documents by that score.
"""

import numpy as np


def closeness(vectors: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(n, d) unit rows, (d,) unit query -> (n,) float64 closeness."""
    cos = (vectors @ query.astype(np.float32)).astype(np.float64)
    return 1.0 / (2.0 - cos)


def doc_scores(vectors: np.ndarray, row_doc: np.ndarray, n_docs: int,
               query: np.ndarray) -> np.ndarray:
    """The best chunk's closeness of each document; ``row_doc`` gives each
    row's document number."""
    best = np.full(n_docs, -np.inf)
    np.maximum.at(best, row_doc, closeness(vectors, query))
    return best


def top_k(scores: np.ndarray, k: int) -> np.ndarray:
    """Document numbers of the ``k`` best scores, best first."""
    part = np.argpartition(-scores, k)[:k]
    return part[np.argsort(-scores[part], kind="stable")]
