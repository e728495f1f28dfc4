"""Deals the requests of a traffic mix to its clients.

A mix (a JSON file in `benchmark/traffic/`) lists request templates with
weights, and the size of its deck. The deck is the same for every seed:
each template gets its share of the deck by weight (largest remainder),
and its values are stratified draws of their distributions:
`{"zipf": "SERVICES"}` a name of `benchmark.spans`'s table Zipf-skewed
(constant 0.99, the table's first entry the most frequent),
`{"zipf_list": [...]}` the same over the given list, `{"choice": [...]}`
uniform. The clients take their requests from one sequence of passes
over the deck, each pass in a seeded order: every seed offers the same
work, in another order. Each request carries its HTTP path and the spec
the reference judges it by.
"""

from __future__ import annotations

import re
import urllib.parse

import numpy as np

from benchmark import spans

_DURATION = re.compile(r"\d+(ns|us|ms|s|m)")


def stratified_value(v, u: float):
    """The value of draw spec v at quantile u in (0, 1)."""
    if not isinstance(v, dict):
        return v
    if "zipf" in v or "zipf_list" in v:
        table = getattr(spans, v["zipf"]) if "zipf" in v else v["zipf_list"]
        cdf = np.cumsum(spans.zipf_p(len(table)))
        return table[min(int(np.searchsorted(cdf, u, side="right")), len(table) - 1)]
    if "choice" in v:
        return v["choice"][min(int(u * len(v["choice"])), len(v["choice"]) - 1)]
    raise ValueError(f"unknown draw {v}")


def _literal(value: str) -> str:
    return value if _DURATION.fullmatch(value) else '"' + value.replace('"', '\\"') + '"'


def traceql_filter(where: list) -> str:
    return "{ " + " && ".join(f"{f} {op} {_literal(str(v))}" for f, op, v in where) + " }"


def _shares(weights: list, n: int) -> list:
    w = np.asarray(weights, float) / sum(weights) * n
    out = np.floor(w).astype(int)
    for i in np.argsort(-(w - out), kind="stable")[: n - out.sum()]:
        out[i] += 1
    return out.tolist()


class Mix:
    def __init__(self, traffic: dict, cfg: dict):
        self.t = traffic
        self.templates = traffic["requests"]
        data = cfg["data"]
        rng_ = traffic["range"]
        self.start = data["start_s"] + rng_["offset_s"]
        self.end = self.start + rng_["length_s"]
        self.step = rng_["step_s"]

    def deck(self) -> list:
        """Every request of the deck, template by template."""
        n = self.t["deck"]
        out = []
        for tpl, n_t in zip(self.templates, _shares([r["weight"] for r in self.templates], n)):
            for j in range(n_t):
                # each draw of a template takes its own stratum order, so
                # two draws of one template decorrelate
                us = [((j * (2 * k + 1) + k) % n_t + 0.5) / n_t for k in range(4)]
                out.append(self._query_range(tpl, us))
        return out

    def passes(self, rng: np.random.Generator):
        """The deck again and again, each pass in a new seeded order."""
        deck = self.deck()
        while True:
            yield [deck[i] for i in rng.permutation(len(deck))]

    def _query_range(self, tpl, us) -> dict:
        where = [[f, op, stratified_value(v, us[k])] for k, (f, op, v) in enumerate(tpl["where"])]
        q = f"{traceql_filter(where)} | {tpl['func']}()"
        qs = {"q": q, "start": self.start, "end": self.end, "step": self.step}
        spec = {"func": tpl["func"], "where": where, "start": self.start, "end": self.end,
                "step": self.step}
        return {"path": "/api/metrics/query_range?" +
                urllib.parse.urlencode(qs), "spec": spec}
