"""Exact search of a store: a closed loop of one caller, each request a
batch of query rows against the whole store, through
`store/index.py::DeviceIndex.search` and `to_host` (the body of
`Reverso.search_batch` without a filter). The index is built from the
rows directly: a persisted store of this size would write gigabytes a
run.

Traffic keys: `rows` of the store, each one of `centers` seeded unit
centres plus N(0, noise^2 / d) noise, normalised (`chip_smoke.py`'s
`capacity_data`), at the configuration's `embed_dim`, held as
`store_dtype`; `queries` a request and `k`; `pool` distinct seeded
requests, cycled, each query a stored row plus fresh noise at
`query_noise`, so that it has near neighbours, as a region looked up
again does; `check_requests` calls of the window compared with the
reference, a uniform sample drawn from the seed.

`correct`: every query of the sampled calls against a plain fp32 scan
of the bf16-rounded rows and queries (`reference/search.py`).
`score_gap`: the largest distance between a returned score and the
reference's score of the same row; `rank_gap`: how far the reference's
score of a returned row lies below the reference's k-th best (a row
returned twice, or an id out of range, reads infinity). The control is
the same scan on int8 rows (one global scale, as the store's int8 mode
keeps them) in the program's place.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from harness import device, weights
from harness.sample import Sample
from reference import search as ref

UNITS = "queries"


def store_rows(cell, device):
    """The store's fp32 rows, chunk by chunk, from the seed."""
    t = cell.traffic
    return weights.clustered_rows(t["rows"], cell.config["embed_dim"], t["centers"],
                                  t["noise"], cell.seed, device)


class ControlIndex:
    """The reference in the program's place, one precision step below the
    store's bfloat16: int8 rows at one global scale (amax / 127), scored
    against the bf16 queries (products of int8 values and bf16 are exact
    in fp32)."""

    def __init__(self, cell, device):
        chunks = [x for _, x in store_rows(cell, device)]
        amax = max(float(x.abs().max()) for x in chunks)
        self.scale = amax / 127.0
        # int8 values, held as bf16 (exact) for the products
        self.rows = torch.cat([torch.round(x / self.scale).clamp(-127, 127).to(torch.bfloat16)
                               for x in chunks])
        self.device = device

    def search(self, queries, k: int):
        q = torch.from_numpy(np.asarray(queries, np.float32)).to(self.device).bfloat16()
        s = (q @ self.rows.t()).float() * self.scale
        return s.topk(k, dim=1)


class Search:
    def __init__(self, cell, control: bool = False):
        from reverso_tpu_torch.store.index import DeviceIndex, to_host

        t = cell.traffic
        self.cell, self.k, self.q = cell, t["k"], t["queries"]
        self.to_host = to_host
        dev = torch.device(cell.device)
        n, d = t["rows"], cell.config["embed_dim"]
        rows = np.empty((n, d), np.float32)
        for lo, x in store_rows(cell, dev):
            rows[lo:lo + len(x)] = x.cpu().numpy()
        g = weights.generator(cell.seed, weights.QUERIES, dev)
        src = torch.randint(0, n, (t["pool"] * self.q,), generator=g, device=dev)
        x = torch.from_numpy(rows[src.cpu().numpy()]).to(dev)
        x = x + torch.randn(x.shape, generator=g, device=dev) * (t["query_noise"] / d ** 0.5)
        x = x / x.norm(dim=1, keepdim=True)
        self.pool = x.cpu().numpy().reshape(t["pool"], self.q, d)
        if control:
            del rows
            self.index = ControlIndex(cell, dev)
        else:
            self.index = DeviceIndex(rows, dtype=t["store_dtype"], distance="cosine",
                                     device=dev)
        self.outs = Sample(t["check_requests"], cell.seed)

    def warm_up(self) -> None:
        for j in range(2):
            self.call(j)
        self.outs.clear()

    def call(self, i: int) -> int:
        j = i % len(self.pool)
        s, ids = self.index.search(self.pool[j], self.k)
        self.outs.offer((j, self.to_host(s), self.to_host(ids)))
        return self.q

    def check(self) -> list:
        cell, outs = self.cell, self.outs.items
        del self.index
        device.free_cache()
        queries = np.concatenate([self.pool[j] for j, _, _ in outs])
        scores = np.concatenate([s for _, s, _ in outs])
        ids = np.concatenate([i for _, _, i in outs])
        dev = torch.device(cell.device)
        score_gap, rank_gap = ref.gaps(store_rows(self.cell, dev), cell.traffic["rows"],
                                       queries, scores, ids, self.k, dev)
        return [("score_gap", score_gap, cell.limits["score_gap"]),
                ("rank_gap", rank_gap, cell.limits["rank_gap"])]


@contextlib.contextmanager
def altered_answer():
    """Fault: the last id of every request's first query altered where
    the program produces it (the next row)."""
    from reverso_tpu_torch.store.index import DeviceIndex

    produce = DeviceIndex.search

    def altered(self, queries, k, **kw):
        s, i = produce(self, queries, k, **kw)
        i = i.clone()
        i[0, k - 1] = (i[0, k - 1] + 1) % self.n_valid
        return s, i

    DeviceIndex.search = altered
    try:
        yield
    finally:
        DeviceIndex.search = produce


# faults a run of this entry can have, planted in the program
FAULTS = {"altered_answer": altered_answer}


def setup(cell, control: bool = False) -> Search:
    return Search(cell, control)


def end_to_end(work: dict, seconds: float) -> dict:
    return {"search_qps": work[UNITS] / seconds}
