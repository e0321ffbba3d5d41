"""What a run hands to the readers of its metrics and to its check: the
cell's files, the load generator's records of the window, the trace of a
traced run, and the inputs remade from the seed.
"""

import statistics

from reference import corpus


class Window:
    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, results: dict, words, family, checkpoint: str,
                 device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds = seed, seconds
        self.results, self.words = results, words
        self.family, self.checkpoint, self.device = family, checkpoint, device
        self.trace = None          # harness.trace.Trace in a traced run
        self.setup_s = None
        self.power_limit_w = None
        self._reference = None

    @property
    def requests(self) -> list:
        return [r for r in self.results["requests"] if r is not None]

    def in_window(self) -> list:
        """The window's requests: every search due in it (open loop), or
        every add that completed in it (closed loop; not those of the
        ramp before it)."""
        if self.results["kind"] == "open_search":
            return self.requests
        return [r for r in self.requests if 0 <= r[2] <= self.seconds]

    def fifths(self) -> list:
        """Per fifth of the window: the documents acknowledged a second
        (closed loop), or the median latency in ms of the searches due
        (open loop); how steady the window was."""
        step = self.seconds / 5
        out = []
        for i in range(5):
            lo, hi = i * step, (i + 1) * step
            if self.results["kind"] == "open_search":
                out.append(median([(r[3] - r[1]) * 1e3 if r[4] == 200
                                   else 1000.0 for r in self.in_window()
                                   if lo <= r[1] < hi]))
            else:
                out.append(sum(r[4] - len(r[6]) for r in self.in_window()
                               if r[5] == 200 and lo <= r[2] < hi) / step)
        return out

    def reference(self):
        """The configuration's plain reference (weights loaded once)."""
        if self._reference is None:
            self._reference = self.family.Reference(
                self.config, self.seed, self.checkpoint, self.device)
        return self._reference

    def document(self, k: int) -> dict:
        docs = self.traffic["documents"]
        if docs["kind"] == "image_caption":
            return corpus.image_document(self.seed, k, self.words, docs,
                                         self.results.get("base_url", ""))
        return corpus.text_document(self.seed, k, self.words, docs)

    def query(self, k: int) -> str:
        return corpus.query(self.seed, k, self.words, self.traffic["queries"])

    def acknowledged(self) -> list:
        """Numbers of the documents acknowledged inside the window."""
        out = []
        for r in self.in_window():
            _client, _sent, _done, first, n, status, failed, _t = r
            if status == 200:
                bad = set(failed)
                out.extend(first + j for j in range(n) if j not in bad)
        return out

    def timers(self, name: str) -> list:
        """One server timer of every request completed in the window."""
        return [r[-1][name] for r in self.in_window() if name in r[-1]]


def median(values):
    return statistics.median(values) if values else None
