"""The comparison that decides ``correct``: what the timed path produced,
against the configuration's plain reference, after the window.

Ingest: a sample of the documents acknowledged in the window, drawn from
the seed and with the window's longest document in it, read back through
the API with their vectors (``expose_facets``). ``chunk_mismatch`` counts
the fields whose stored chunks differ from the reference's split;
``gap_<field>`` is the widest distance, in a field, between a stored unit
vector and the reference's for the same chunk.

Search: a sample of the window's answered searches, drawn from the seed
and with the longest query in it. The reference embeds each query and
scores every base-corpus document by its best chunk (an exact scan).
``missing_hits`` counts answers with fewer hits than asked or a hit that
is no base document, ``misordered_hits`` answers whose scores do not fall
from rank to rank, and ``score_rms`` is the root mean square, over every
sampled hit, of the gap between the hit's score and the reference's score
of that document. Which documents HNSW returns is not compared: the
configuration searches approximately, and its misses outweigh the query's
rounding (PERF.md).

Each returns (attempted, failed, [(name, value, limit)]).
"""

import numpy as np

from reference import scan


def _sample(seed: int, items: list, n: int, longest, salt: int) -> list:
    rng = np.random.default_rng([seed, salt])
    picked = [items[i] for i in rng.choice(len(items), size=min(n, len(items)),
                                           replace=False)]
    if longest is not None and longest not in picked:
        picked[-1] = longest
    return picked


def ingest(window, server, index: str, control_fp8: bool) -> tuple:
    spec = window.traffic["check"]
    fields = window.traffic["tensor_fields"]
    acked = window.acknowledged()
    attempted = sum(r[4] for r in window.in_window())
    failed = attempted - len(acked)
    if not acked:
        return attempted, failed, [("acknowledged_docs", 0, 1)]
    reference = window.reference()
    pool = _sample(window.seed, acked, spec["longest_of"], None, 0x6c6f6e)
    longest = max(pool, key=lambda k: len(str(window.document(k))))
    picked = _sample(window.seed, acked, spec["sample"], longest, 0x636b)
    mismatch, gaps = 0, {field: [] for field in fields}
    for k in picked:
        doc = window.document(k)
        stored = server.call("GET", f"/indexes/{index}/documents/"
                             f"{doc['_id']}?expose_facets=true")
        facets = stored.get("_tensor_facets", []) if stored else []
        for field, chunks in reference.chunks(doc, fields).items():
            got = [f for f in facets if field in f]
            if [f[field] for f in got] != chunks:
                mismatch += 1
                continue
            port = np.asarray([f["_embedding"] for f in got], np.float32)
            if control_fp8:
                port = reference.embed_field(doc, field, chunks, "fp8")
            ref = reference.embed_field(doc, field, chunks, "float32")
            gaps[field].extend(np.linalg.norm(port - ref, axis=1))
    compared = [("chunk_mismatch", mismatch, 0)]
    for field in fields:
        compared.append((f"gap_{field}", float(max(gaps[field], default=0.0)),
                         spec["limits"][f"gap_{field}"]))
    return attempted, failed, compared


def search(window, base) -> tuple:
    spec = window.traffic["check"]
    limit = window.traffic["search"]["limit"]
    records = window.in_window()
    answered = [r for r in records if r[4] == 200]
    attempted, failed = len(records), len(records) - len(answered)
    if not answered:
        return attempted, failed, [("answered_searches", 0, 1)]
    reference = window.reference()
    queries = {r[0]: window.query(r[0]) for r in answered}
    longest = max(answered, key=lambda r: len(queries[r[0]]))
    picked = _sample(window.seed, answered, spec["sample"], longest, 0x7372)
    vectors = reference.embed([queries[r[0]] for r in picked],
                              "text_query_prefix")
    number = {doc_id: i for i, doc_id in enumerate(base.ids)}
    missing = misordered = 0
    gaps = []
    for r, q in zip(picked, vectors):
        ids, scores = r[5], r[6]
        if len(ids) < limit or any(i not in number for i in ids):
            missing += 1
            continue
        if any(a < b for a, b in zip(scores, scores[1:])):
            misordered += 1
        truth = scan.doc_scores(base.vectors, base.row_doc, len(base.ids), q)
        gaps.extend(np.asarray(scores) - truth[[number[i] for i in ids]])
    rms = float(np.sqrt(np.mean(np.square(gaps)))) if gaps else 0.0
    return attempted, failed, [
        ("missing_hits", missing, 0), ("misordered_hits", misordered, 0),
        ("score_rms", rms, spec["limits"]["score_rms"])]
