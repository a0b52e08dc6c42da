"""The universal query surface, JAX package vs PyTorch port, on the CPU.

One seeded store (2,000 x 64 unit rows, a named space "aux" of 32, a
sparse space "sp" and a multivector space "mv" of 16, payloads as in
test_torch_filter.py plus a class, a datetime, a price, a geo point and a
document key) and a six-row "docs" collection for lookups are opened in
`reverso_tpu.Reverso` and `reverso_tpu_torch.Reverso(device="cpu")`, and
the same requests run through both: `query` in every shape (plain,
filtered, named / sparse / multivector spaces, random sampling, order_by,
the recommend / discover / context operands, prefetch with RRF / DBSF,
exact / formula / MMR / combine rescoring, lookup_from, payload
selectors), `query_groups`, `query_batch`, `recommend`, `discover`,
`scroll`, `retrieve`, `facet`, `search_matrix`, `search_groups` (with
lookups) and `search_by_text`; the cases follow the reference's
test_recommend.py, test_mmr.py, test_formula.py, test_sparse.py,
test_groups.py, test_lookup.py and test_matrix.py.

Tolerance: the store is float32, so scores agree within 1e-5; ids are
equal wherever the reference's scores clear their neighbours by
test_topk.py's tie margin (TOL), and payloads equal where ids do. Ids
that are not scored (random samples, scroll pages, facets) are equal.
"""
import dataclasses
import inspect

import numpy as np
import pytest

from reverso_tpu.config import SearchConfig as JaxSearchConfig
from reverso_tpu.config import StoreConfig as JaxStoreConfig
from reverso_tpu.config import default_config as jax_default_config
from reverso_tpu.engine import Reverso as JaxReverso
from reverso_tpu_torch.config import SearchConfig, StoreConfig, default_config
from reverso_tpu_torch.engine import Reverso
from reverso_tpu_torch.store import VectorStore

from test_topk import TOL

N, D, DA, DM = 2000, 64, 32, 16
SCORE_TOL = 1e-5


class FakeTextEmbedder:
    """Text -> a fixed unit [1, D] row per string (both engines share
    it; the text tower's `embed` shape)."""

    def embed(self, text):
        rng = np.random.default_rng(sum(map(ord, text)))
        v = rng.standard_normal((1, D)).astype(np.float32)
        return v / np.linalg.norm(v)


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def build_store(root, name="main", seed=0, n=N):
    """The shared store: clustered rows, every kind of vector space."""
    N = n
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((12, D)).astype(np.float32)
    x = cent[rng.integers(0, 12, N)] + 0.3 * rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    aux = _unit(rng, N, DA)
    conf = rng.random(N)
    pays = [{"folder": i % 10, "confidence": float(conf[i]),
             "filename": f"{i // 4}.jpg", "region_id": f"r{i}",
             "cls": ("person", "car", "dog")[i % 3],
             "created": f"2024-01-{1 + i % 28:02d}T00:00:00Z",
             "price": i % 17, "doc": i % 6,
             "loc": {"lat": float(i % 90), "lon": float(i % 180)}}
            for i in range(N)]
    for i in range(0, N, 11):
        del pays[i]["folder"]                 # rows without the group key
    sp = []
    for i in range(N):
        t = np.sort(rng.choice(50, size=1 + i % 4, replace=False))
        sp.append({"indices": t.tolist(),
                   "values": rng.random(len(t)).round(3).tolist()}
                  if i % 9 else None)
    mv = [None if i % 13 == 0 else _unit(rng, 1 + i % 3, DM) for i in range(N)]
    with VectorStore.create(root, name, D, named={"aux": DA}, sparse=["sp"],
                            multi={"mv": DM}) as s:
        for lo in range(0, N, 1000):
            s.append({"": x[lo:lo + 1000], "aux": aux[lo:lo + 1000]},
                     pays[lo:lo + 1000], {"sp": sp[lo:lo + 1000]},
                     {"mv": mv[lo:lo + 1000]})
    return x, aux


def engines(root, dtype="float32", **search):
    jcfg = jax_default_config().replace(
        store=JaxStoreConfig(root_dir=root, dtype=dtype),
        search=dataclasses.replace(JaxSearchConfig(), **search))
    tcfg = default_config().replace(
        store=StoreConfig(root_dir=root, dtype=dtype),
        search=dataclasses.replace(SearchConfig(), **search))
    return (JaxReverso(jcfg, text_embedder=FakeTextEmbedder()),
            Reverso(tcfg, text_embedder=FakeTextEmbedder(), device="cpu"))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("query"))
    x, aux = build_store(root)
    rng = np.random.default_rng(1)
    with VectorStore.create(root, "docs", D) as s:
        s.append(_unit(rng, 6, D), [{"region_id": f"d{i}", "title": f"Doc {i}"}
                                    for i in range(6)])
    jax_eng, port = engines(root)
    assert "Loaded" in jax_eng.load_database("main")
    assert "Loaded" in port.load_database("main")
    return jax_eng, port, x, aux


# -- comparison ----------------------------------------------------------

def _is_hits(v):
    return (isinstance(v, list) and v and isinstance(v[0], dict)
            and "id" in v[0] and "score" in v[0])


def _clear(scores, tol):
    """Positions whose score clears both neighbours by `tol`."""
    s = np.asarray(scores, np.float64)
    pad = np.array([np.inf])
    gaps = np.abs(np.diff(s)) if len(s) > 1 else np.zeros(0)
    return (np.concatenate([pad, gaps]) > tol) & (np.concatenate([gaps, pad]) > tol)


def same(j, t, tol=SCORE_TOL, path="out"):
    """Recursive equality of two outputs: floats within `tol`, hit lists
    by the tie-margin rule, everything else exactly."""
    if _is_hits(j):
        assert _is_hits(t) and len(t) == len(j), (path, len(j), len(t))
        js = [h["score"] for h in j]
        np.testing.assert_allclose([h["score"] for h in t], js, atol=tol,
                                   err_msg=path)
        for p, ok in enumerate(_clear(js, TOL)):
            if ok or j[p]["id"] == t[p]["id"]:
                assert j[p]["id"] == t[p]["id"], (path, p, j[p]["id"], t[p]["id"])
                same({a: b for a, b in j[p].items() if a != "score"},
                     {a: b for a, b in t[p].items() if a != "score"},
                     tol, f"{path}[{p}]")
        return
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), (path, j.keys(), t.keys())
        for key in j:
            same(j[key], t[key], tol, f"{path}.{key}")
        return
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(j) == len(t), (path, j, t)
        for n, (a, b) in enumerate(zip(j, t)):
            same(a, b, tol, f"{path}[{n}]")
        return
    if isinstance(j, (np.ndarray, np.generic)) or isinstance(t, (np.ndarray, np.generic)):
        ja, ta = np.asarray(j), np.asarray(t)
        assert ja.shape == ta.shape, (path, ja.shape, ta.shape)
        if ja.dtype.kind == "f":
            np.testing.assert_allclose(ta, ja, atol=tol, err_msg=path)
        else:
            np.testing.assert_array_equal(ta, ja, err_msg=path)
        return
    if isinstance(j, float) and not isinstance(t, bool):
        assert t == pytest.approx(j, abs=tol), (path, j, t)
        return
    assert j == t, (path, j, t)


def same_rendered(j, t):
    """(text, items) of recommend / discover / search_*: the status line
    and the items (thumbnail images are None in both)."""
    assert j[0].split("\n")[0].split(":")[0] == t[0].split("\n")[0].split(":")[0]
    same(list(j[1]), list(t[1]))


# -- query() in every shape -------------------------------------------------

def _q(x, aux):
    """name -> kwargs of one query() call (the reference's cases)."""
    q9 = x[9] + 0.01
    # MMR's nearest operand is no stored row: against a stored row the
    # first pick is the query itself, and every later objective is
    # rel - max_sim = 0 up to rounding
    qm = (x[0] + x[1234]) / np.linalg.norm(x[0] + x[1234])
    return {
        "plain_vector": dict(query=x[3], k=10),
        "plain_point_id": dict(query=3, k=10),
        "plain_region_id": dict(query="r3", k=10),
        "nearest_wrapper": dict(query={"nearest": x[5]}, k=10),
        "filter_dict": dict(query=x[7], k=10, filter={"folder": 3}),
        "filter_string": dict(query=x[7], k=10, filter="confidence>=0.5"),
        "filter_must_any": dict(query=x[7], k=10, filter={"must": [
            {"key": "cls", "match": {"any": ["car", "dog"]}},
            {"key": "price", "range": {"lt": 8}}]}),
        "named_space": dict(query=aux[4], k=10, using="aux"),
        "named_space_point": dict(query=4, k=10, using="aux"),
        "sparse_dict": dict(query={"indices": [1, 7, 20], "values": [0.5, 1.0, 0.25]},
                            k=10, using="sp"),
        "sparse_point": dict(query=10, k=10, using="sp"),
        "multivector": dict(query=np.stack([aux[0][:DM], aux[1][:DM]]), k=10,
                            using="mv"),
        "random_sample": dict(query={"sample": "random"}, k=20, seed=7),
        "random_filtered": dict(query={"sample": "random"}, k=20, seed=3,
                                filter={"cls": "car"}),
        "order_by_desc": dict(query={"order_by": {"key": "confidence",
                                                  "direction": "desc"}}, k=8),
        "order_by_start": dict(query={"order_by": {"key": "price", "start_from": 5}},
                               k=8),
        "order_by_datetime": dict(query={"order_by": "created"}, k=8,
                                  filter={"folder": 2}),
        "recommend_average": dict(query={"recommend": {"positive": [3, 7]}}, k=10),
        "recommend_alias_mixed": dict(query={"recommend": {
            "positive": [3, x[7]], "strategy": "average_vector"}}, k=10),
        "recommend_sum_scores": dict(query={"recommend": {
            "positive": [3, 8], "negative": [5], "strategy": "sum_scores"}}, k=10),
        "recommend_best_score": dict(query={"recommend": {
            "positive": [3], "negative": [5], "strategy": "best_score"}}, k=10),
        "recommend_filtered": dict(query={"recommend": {"positive": [4]}}, k=10,
                                   filter={"cls": "person"}),
        "discover": dict(query={"discover": {
            "target": 2, "context": [{"positive": 0, "negative": 5}]}}, k=10),
        "context": dict(query={"context": [(0, 5), (11, 12)]}, k=10),
        "fusion_rrf": dict(prefetch=[{"query": 2, "limit": 20},
                                     {"query": 11, "limit": 20}], k=10),
        "fusion_dbsf": dict(prefetch=[{"query": 2, "limit": 20},
                                      {"query": 11, "limit": 20}],
                            fusion="dbsf", k=10),
        "fusion_global_filter": dict(prefetch=[{"query": 2, "limit": 20}],
                                     filter={"cls": "person"}, k=5),
        "rescore_exact": dict(query=x[0], prefetch=[
            {"query": 5, "limit": 16},
            {"query": 9, "limit": 16, "filter": "cls=car"}], k=8),
        "hybrid_sparse_dense": dict(prefetch=[
            {"query": {"indices": [1, 7], "values": [1.0, 0.5]}, "using": "sp",
             "limit": 20},
            {"query": x[1], "limit": 20}], k=10),
        "named_prefetch_default_rescore": dict(query=x[6], prefetch=[
            {"query": aux[6], "using": "aux", "limit": 30}], k=10),
        "multivector_rescore": dict(query=np.stack([aux[2][:DM]]), using="mv",
                                    prefetch=[{"query": x[2], "limit": 40}], k=10),
        "sparse_rescore": dict(query={"indices": [3, 9], "values": [1.0, 1.0]},
                               using="sp", prefetch=[{"query": x[3], "limit": 200}],
                               k=10),
        "formula_boost": dict(query={"formula": {"sum": [
            "$score", {"mult": [0.1, {"key": "cls", "match": {"value": "car"}}]},
            {"neg": {"mult": [0.01, "price"]}}]}},
            prefetch=[{"query": q9, "limit": 30}], k=20),
        "formula_defaults": dict(query={"formula": {"sum": ["$score", "missing"]},
                                        "defaults": {"missing": 0.25}},
                                 prefetch=[{"query": x[5], "limit": 5}], k=3),
        "formula_two_branches": dict(query={"formula": {
            "sum": ["$score[0]", "$score[1]"]}, "defaults": {"$score": 0.0}},
            prefetch=[{"query": x[2], "limit": 10}, {"query": x[9], "limit": 10}],
            k=8),
        "formula_decay_geo": dict(query={"formula": {"sum": [
            "$score",
            {"exp_decay": {"x": "created", "target": "2024-01-10T00:00:00Z",
                           "scale": 86400.0 * 5}},
            {"mult": [-1e-7, {"geo_distance": {"origin": {"lat": 10.0, "lon": 20.0},
                                               "to": "loc"}}]}]}},
            prefetch=[{"query": x[4], "limit": 25}], k=10),
        "mmr": dict(query={"nearest": qm, "mmr": {"diversity": 0.5}}, k=8),
        "mmr_zero_is_plain": dict(query={"nearest": qm, "mmr": {"diversity": 0.0}},
                                  k=8),
        "mmr_prefetch_filtered": dict(query={"nearest": qm, "mmr": {"diversity": 0.6}},
                                      prefetch=[{"query": x[0], "limit": 24}],
                                      filter={"cls": "dog"}, k=5),
        "mmr_small_pool": dict(query={"nearest": qm, "mmr": {
            "diversity": 0.5, "candidates_limit": 3}}, k=10),
        "combine_in_prefetch": dict(query=x[9], k=5, prefetch=[
            {"query": {"recommend": {"positive": [3, 7]}}, "limit": 200}]),
        "combine_rescores_union": dict(query={"recommend": {
            "positive": [3], "strategy": "best_score"}}, k=5,
            prefetch=[{"query": x[9], "limit": 100}]),
        "order_by_branch_and_rescore": dict(query={"order_by": {
            "key": "confidence", "direction": "desc"}}, k=5,
            prefetch=[{"query": x[9], "limit": 10}]),
        "random_branch_exact_rescore": dict(query=x[1], k=5, seed=11, prefetch=[
            {"query": {"sample": "random"}, "limit": 300}]),
        "payload_keys": dict(query=x[3], k=5, with_payload=["folder", "cls"]),
        "payload_exclude": dict(query=x[3], k=5,
                                with_payload={"exclude": ["loc", "created"]}),
        "payload_none": dict(query=x[3], k=5, with_payload=False),
        "lookup_point": dict(query=1, k=8, lookup_from="docs"),
        "lookup_recommend": dict(query={"recommend": {"positive": [2, 4]}}, k=8,
                                 lookup_from={"collection": "docs"}),
        "text_operand": dict(query={"text": "a red car"}, k=6),
    }


QUERY_CASES = list(_q(np.ones((N, D)), np.ones((N, DA))))


@pytest.mark.parametrize("case", QUERY_CASES)
def test_query_matches_jax(pair, case):
    jax_eng, port, x, aux = pair
    kw = _q(x, aux)[case]
    same(jax_eng.query(**kw), port.query(**kw))


GROUP_CASES = {
    "plain": dict(query=3, group_by="folder", group_size=3, limit=4),
    "filename": dict(query=3, group_by="filename", group_size=2, limit=5),
    "filtered_selector": dict(query=3, group_by="cls", group_size=4, limit=2,
                              filter="confidence>=0.3", with_payload=["cls"]),
    "prefetch_fusion": dict(prefetch=[{"query": 2, "limit": 10},
                                      {"query": 11, "limit": 10}],
                            group_by="folder", group_size=2, limit=3),
    "recommend_groups": dict(query={"recommend": {"positive": [3, 7]}},
                             group_by="cls", group_size=2, limit=2),
    "with_lookup": dict(query=3, group_by="doc", group_size=2, limit=3,
                        with_lookup={"collection": "docs", "with_vectors": True}),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_query_groups_matches_jax(pair, case):
    jax_eng, port, _, _ = pair
    kw = GROUP_CASES[case]
    same(jax_eng.query_groups(**kw), port.query_groups(**kw))


def test_query_batch_matches_jax_and_sequential(pair):
    """Plain requests sharing (space, filter) coalesce; hybrid branches
    coalesce; everything else runs per request. Batched equals
    sequential in the port, and equals the JAX package."""
    jax_eng, port, x, aux = pair
    reqs = [{"query": x[1], "k": 5}, {"query": x[2], "k": 9},
            {"query": 7, "k": 5, "filter": {"folder": 3}},
            {"query": x[8], "k": 5, "filter": {"folder": 3}},
            {"query": aux[3], "k": 5, "using": "aux"},
            {"query": {"nearest": x[4]}, "k": 5, "with_payload": False},
            {"prefetch": [{"query": x[5], "limit": 20},
                          {"query": x[6], "limit": 20, "filter": {"cls": "car"}}],
             "k": 5},
            {"prefetch": [{"query": x[10], "limit": 20},
                          {"query": x[12], "limit": 20, "filter": {"cls": "car"}}],
             "k": 5},
            {"query": {"recommend": {"positive": [3, 7]}}, "k": 5},
            {"query": {"indices": [1, 7], "values": [1.0, 0.5]}, "using": "sp", "k": 5},
            {"query": np.stack([aux[0][:DM]]), "using": "mv", "k": 5},
            {"query": {"nearest": (x[0] + x[1234]) / 2, "mmr": {"diversity": 0.8}},
             "k": 4}]
    got = port.query_batch(reqs, with_payload=["folder"])
    same(jax_eng.query_batch(reqs, with_payload=["folder"]), got)
    for r, res in zip(reqs, got):
        r = dict(r)
        r.setdefault("with_payload", ["folder"])
        same(port.query(**r), res)


def _count_scans(eng, monkeypatch):
    """Record (space, Q, k) of every index search `eng` launches."""
    calls = []
    real = eng._get_index

    def spy(using=""):
        index = real(using)

        class Counting:
            def search(self, q, k, **kw):
                calls.append((using, np.asarray(q).shape[0], k))
                return index.search(q, k, **kw)
        return Counting()

    monkeypatch.setattr(eng, "_get_index", spy)
    return calls


def test_query_batch_launches_one_scan_per_group(pair, monkeypatch):
    """Plain requests: one scan per (space, filter); hybrid branches: one
    per (space, limit, branch filter, global filter)."""
    _, port, x, _ = pair
    calls = _count_scans(port, monkeypatch)
    reqs = [{"query": x[n], "k": 5} for n in range(4)]
    reqs += [{"query": x[n], "k": 5, "filter": {"folder": 3}} for n in range(4, 7)]
    reqs += [{"prefetch": [{"query": x[n], "limit": 20},
                           {"query": x[n + 1], "limit": 20, "filter": {"cls": "car"}}],
              "k": 5} for n in range(10, 16, 2)]
    port.query_batch(reqs)
    assert sorted(calls) == sorted([("", 4, 5), ("", 3, 5), ("", 3, 20), ("", 3, 20)])


def test_query_batch_exact_filter_keys(pair, monkeypatch):
    """Two filters that differ only inside a {"match": {"value":
    ndarray}} leaf, in the middle of the array: numpy truncates both
    reprs to the same "[   0    1    2 ... 1997 1998 1999]", so the JAX
    package's `default=repr` key puts both requests in one launch under
    the first one's filter. The port keys a group by exact JSON only: a
    filter that is not plain JSON runs alone, and each result equals its
    own query(). A match against an ndarray raises on any row holding
    the key, so the leaf here names a key no row holds: the two masks
    agree, and the JAX package's answers agree with the port's; the
    divergence is in the grouping, asserted through the launches."""
    jax_eng, port, x, _ = pair
    a = np.arange(N)
    b = a.copy()
    b[N // 2] = -1
    assert repr(a) == repr(b) and not np.array_equal(a, b)
    fa = {"should": [{"key": "folder", "match": {"value": 3}},
                     {"key": "absent", "match": {"value": a}}]}
    fb = {"should": [fa["should"][0], {"key": "absent", "match": {"value": b}}]}
    reqs = [{"query": x[5], "k": 5, "filter": fa},
            {"query": x[6], "k": 5, "filter": fb},
            {"query": x[7], "k": 5, "filter": {"folder": 3}}]
    calls = _count_scans(port, monkeypatch)
    got = port.query_batch(reqs)
    assert sorted(calls) == [("", 1, 5)] * 3
    for r, res in zip(reqs, got):
        same(port.query(**r), res)
    assert all(h["payload"]["folder"] == 3 for res in got for h in res)
    jcalls = _count_scans(jax_eng, monkeypatch)
    same(jax_eng.query_batch(reqs), got)
    assert sorted(jcalls) == [("", 1, 5), ("", 2, 5)]     # fa and fb joined


QUERY_ERRORS = {
    "nothing": dict(),
    "fusion_and_query": dict(query=3, prefetch=[3], fusion="rrf"),
    "bad_point": dict(query=99999),
    "bad_dim": dict(query=np.zeros(7)),
    "bad_fusion": dict(prefetch=[2], fusion="mean"),
    "random_rescore": dict(query={"sample": "random"}, prefetch=[2]),
    "formula_no_prefetch": dict(query={"formula": "$score"}),
    "formula_and_mmr": dict(query={"formula": "$score", "mmr": {}}, prefetch=[2]),
    "mmr_diversity": dict(query={"nearest": 0, "mmr": {"diversity": 1.5}}),
    "mmr_no_nearest": dict(query={"mmr": {"diversity": 0.5}}),
    "recommend_strategy": dict(query={"recommend": {"positive": [1], "strategy": "x"}}),
    "recommend_no_positive": dict(query={"recommend": {"negative": [1]}}),
    "context_empty": dict(query={"context": []}),
    "discover_empty": dict(query={"discover": {}}),
    "order_by_direction": dict(query={"order_by": {"key": "price", "direction": "up"}}),
    "lookup_unknown": dict(query=1, lookup_from="nope"),
}


@pytest.mark.parametrize("case", list(QUERY_ERRORS))
def test_query_errors_match_jax(pair, case):
    jax_eng, port, _, _ = pair
    kw = QUERY_ERRORS[case]
    with pytest.raises(Exception) as je:
        jax_eng.query(**kw)
    with pytest.raises(Exception) as te:
        port.query(**kw)
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


# -- the engine's read surface ----------------------------------------------

def _calls(x):
    return {
        "recommend_average": lambda e: e.recommend([1, 2], [3], 10),
        "recommend_sum_scores": lambda e: e.recommend([1, 2], [3], 10,
                                                      strategy="sum_scores"),
        "recommend_best_score_filtered": lambda e: e.recommend(
            [1, x[2]], [3], 10, strategy="best_score", filter={"cls": "car"}),
        "recommend_threshold": lambda e: e.recommend([1], None, 10, 0.5),
        "recommend_lookup": lambda e: e.recommend([2], max_results=5,
                                                  lookup_from={"collection": "docs"}),
        "recommend_bad_strategy": lambda e: e.recommend([1], strategy="nope"),
        "recommend_batcher": lambda e: e.recommend([1, 2], None, 10, use_batcher=True),
        "discover_target_context": lambda e: e.discover(2, [(0, 5), (7, 8)], 10),
        "discover_context_only": lambda e: e.discover(None, [(0, 5)], 10,
                                                      filter={"folder": 1}),
        "discover_lookup": lambda e: e.discover(1, [(2, 3)], 5, lookup_from="docs"),
        "discover_nothing": lambda e: e.discover(None, None),
        "search_groups": lambda e: e.search_groups(
            0.0, 4, embeddings=x[:2], query_index=1, group_by="folder", group_size=3),
        "search_groups_filename": lambda e: e.search_groups(
            0.2, 5, embeddings=x[8:9], group_by="filename", group_size=2),
        "search_groups_filtered": lambda e: e.search_groups(
            0.0, 3, embeddings=x[:1], group_by="cls", group_size=5,
            filter="confidence<0.4"),
        "search_groups_named": lambda e: e.search_groups(
            -1.0, 3, embeddings=np.zeros((1, DA), np.float32) + 0.1, using="aux",
            group_by="folder", group_size=2),
        "search_groups_lookup": lambda e: e.search_groups(
            0.0, 3, embeddings=x[:1], group_by="doc", group_size=2,
            with_lookup="docs"),
        "search_groups_missing_key": lambda e: e.search_groups(
            0.0, 3, embeddings=x[:1], group_by="nokey"),
        "search_by_text": lambda e: e.search_by_text("a red car", -1.0, 5,
                                                     stateless=True),
        "search_similar_batcher": lambda e: e.search_similar(
            0.0, 10, embeddings=x[:3], query_index=2, use_batcher=True),
    }


CALL_CASES = list(_calls(np.ones((N, D))))


@pytest.mark.parametrize("case", CALL_CASES)
def test_rendered_calls_match_jax(pair, case):
    jax_eng, port, x, _ = pair
    fn = _calls(x)[case]
    same_rendered(fn(jax_eng), fn(port))


POINT_READS = {
    "scroll": lambda e: e.scroll(limit=7),
    "scroll_filter_offset": lambda e: e.scroll({"folder": 4}, offset=100, limit=9),
    "scroll_order_by": lambda e: e.scroll(order_by="confidence", direction="desc",
                                          limit=6),
    "scroll_order_by_token": lambda e: e.scroll(
        order_by="price", offset=e.scroll(order_by="price", limit=5)[1], limit=5),
    "scroll_datetime": lambda e: e.scroll(order_by="created", limit=6,
                                          with_payload=["created"]),
    "scroll_vectors": lambda e: e.scroll(limit=3, with_vectors=True, using="aux"),
    "retrieve_mixed": lambda e: e.retrieve([5, "r9", "nope", 99999, 3],
                                           with_vectors=True),
    "retrieve_sparse": lambda e: e.retrieve([1, 2, 9], with_vectors=True, using="sp"),
    "retrieve_multi": lambda e: e.retrieve([1, 13], with_vectors=True, using="mv"),
    "facet": lambda e: e.facet("folder"),
    "facet_filtered": lambda e: e.facet("cls", {"folder": 3}, limit=2),
    "count": lambda e: [e.count(), e.count({"cls": "dog"}),
                        e.count("confidence>=0.5")],
    "matrix_pairs": lambda e: e.search_matrix(sample=40, limit=3, seed=0),
    "matrix_offsets_filtered": lambda e: e.search_matrix(
        sample=24, limit=2, seed=5, filter={"cls": "car"}, offsets=True),
    "matrix_named": lambda e: e.search_matrix(sample=16, limit=4, seed=1, using="aux"),
    "index_payload": lambda e: e.index_payload(["cls", "folder"]),
}


@pytest.mark.parametrize("case", list(POINT_READS))
def test_point_reads_match_jax(pair, case):
    jax_eng, port, _, _ = pair
    fn = POINT_READS[case]
    same(fn(jax_eng), fn(port))


def test_search_matrix_errors_match_jax(pair):
    jax_eng, port, _, _ = pair
    for kw in (dict(sample=1), dict(sample=9000), dict(limit=0)):
        with pytest.raises(ValueError) as je:
            jax_eng.search_matrix(**kw)
        with pytest.raises(ValueError) as te:
            port.search_matrix(**kw)
        assert str(te.value) == str(je.value)


def test_search_by_text_without_embedder_matches_jax(tmp_path):
    root = str(tmp_path)
    build_store(root)
    jax_eng, port = engines(root)
    jax_eng.text_embedder = port.text_embedder = None
    jax_eng.load_database("main")
    port.load_database("main")
    same_rendered(jax_eng.search_by_text("car"), port.search_by_text("car"))
    assert port.search_by_text("car")[0].startswith("❌ No text encoder")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_query_batch_other_dtypes_match_jax(tmp_path_factory, pair, dtype):
    """The coalesced plain launch on bf16 and int8 rows (the kernels'
    dtypes on the card): ids under the tie margin, scores within the
    dtype's tolerance (int8: the JAX CPU compiler's FMA, as in
    test_torch_filter.py)."""
    _, _, x, _ = pair
    root = str(tmp_path_factory.mktemp(f"query_{dtype}"))
    build_store(root)
    jax_eng, port = engines(root, dtype)
    jax_eng.load_database("main")
    port.load_database("main")
    reqs = [{"query": x[n] + 0.02, "k": 10} for n in range(6)]
    reqs += [{"query": x[n], "k": 10, "filter": {"folder": 3}} for n in range(6, 9)]
    tol = 1e-5 if dtype == "bfloat16" else 3e-5
    same(jax_eng.query_batch(reqs), port.query_batch(reqs), tol=tol)


MESH_CASES = ("hybrid_sparse_dense", "plain_vector", "filter_dict", "named_space",
              "multivector", "recommend_best_score", "discover", "context", "fusion_rrf")


def test_use_mesh_raises_with_its_item(tmp_path, pair, monkeypatch):
    """`use_mesh=True`, which once raised here, runs: the JAX engine on its
    8 CPU devices and the port's on 8 CPU shards (every visible device
    replaced by eight CPUs) give the same answers to the hybrid query of
    `__graft_entry__.py::_dryrun_hybrid_engine` (a sparse branch on the
    host, the dense branch sharded, RRF) and to the other sharded forms,
    and the port's mesh engine gives its single engine's answers."""
    import torch

    from reverso_tpu_torch.parallel import sharding

    _, port_single, x, aux = pair
    root = str(tmp_path)
    build_store(root)
    monkeypatch.setattr(sharding, "local_devices", lambda: [torch.device("cpu")] * 8)
    jcfg = jax_default_config().replace(store=JaxStoreConfig(root_dir=root, dtype="float32"))
    tcfg = default_config().replace(store=StoreConfig(root_dir=root, dtype="float32"))
    jax_eng = JaxReverso(jcfg, text_embedder=FakeTextEmbedder(), use_mesh=True)
    port = Reverso(tcfg, text_embedder=FakeTextEmbedder(), use_mesh=True, device="cpu")
    assert port.mesh.shape == dict(jax_eng.mesh.shape)
    assert "Loaded" in jax_eng.load_database("main") and "Loaded" in port.load_database("main")
    cases = _q(x, aux)
    for name in MESH_CASES:
        t = port.query(**cases[name])
        same(jax_eng.query(**cases[name]), t, path=name)
        same(port_single.query(**cases[name]), t, tol=1e-6, path=name)


SURFACE = ("query", "query_groups", "query_batch", "recommend", "discover", "scroll",
           "retrieve", "facet", "search_matrix", "search_groups", "search_by_text",
           "search_similar", "search_batch", "count", "upsert_points", "delete_points",
           "set_payload", "overwrite_payload", "delete_payload", "clear_payload",
           "index_payload", "update_vectors", "delete_vectors", "update_batch", "warmup")


@pytest.mark.parametrize("name", SURFACE)
def test_surface_signatures_match_jax(name):
    """The port's Reverso is a UniversalQuery, and each method of the
    surface has the JAX engine's signature."""
    from reverso_tpu_torch.query import UniversalQuery
    assert issubclass(Reverso, UniversalQuery)
    def params(cls):
        # each engine has its own "not passed" sentinel object
        return [(p.name, p.kind, "<engine state>" if p.default is cls._USE_ENGINE_STATE
                 else p.default) for p in inspect.signature(getattr(cls, name)).parameters.values()]

    assert params(Reverso) == params(JaxReverso)
    assert isinstance(Reverso.searcher, property)
