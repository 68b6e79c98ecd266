"""The one traffic generator: a mix's data file and a seed make each
client's endless sequence of requests.

A mix (``portbench/mixes/<name>.json``) names its queries with their
shares.  Each client walks blocks that hold every query in its share, in
an order of its own drawn from the seed, so every seed sends the same
proportions.  A query whose text holds ``{{const}}`` gets a constant per
request: a university drawn by Zipf's law over the generated ones
(``universities.zipf_s``; university 0 the most requested), then an entity
of the query's ``const`` class uniformly within that university.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench import manifest


@dataclass(frozen=True)
class Request:
    query: str  # the mix's query name
    text: str


class Traffic:
    def __init__(self, mix: dict, ds, seed: int):
        self.mix = mix
        self.ds = ds
        self.seed = int(seed)
        self.templates = {r["query"]: manifest.query_text(r["query"])
                          for r in mix["requests"]}
        self.block = [r["query"] for r in mix["requests"]
                      for _ in range(int(r["share"]))]
        self.const_class = {r["query"]: r.get("const")
                            for r in mix["requests"]}
        n = ds.universities
        s = float(mix.get("universities", {}).get("zipf_s", 0.0))
        w = 1.0 / np.arange(1, n + 1) ** s
        self.univ_p = w / w.sum()

    def text(self, query: str, const: int) -> str:
        t = self.templates[query]
        return t if const < 0 else t.replace("{{const}}",
                                             self.ds.terms[const])

    def stream(self, client: int, salt: int = 0):
        """Client ``client``'s requests; ``salt`` gives another stream of
        the same mix (the warm-up's)."""
        rng = np.random.default_rng(
            [self.seed % (1 << 63), self.seed >> 63, client, salt])
        while True:
            order = rng.permutation(len(self.block))
            for i in order.tolist():
                q = self.block[i]
                c = -1
                cls = self.const_class[q]
                if cls is not None:
                    u = int(rng.choice(self.univ_p.shape[0], p=self.univ_p))
                    pool = self.ds.instances(cls)[u]
                    c = int(pool[rng.integers(0, pool.shape[0])])
                yield Request(q, self.text(q, c))
