"""Point and payload mutations, JAX package vs PyTorch port, on the CPU.

One seeded store (test_torch_query.py's, at 600 rows: a default space, a
named space, a sparse and a multivector space) is copied twice; the same
sequence of mutations runs through `reverso_tpu.Reverso` on one copy and
`reverso_tpu_torch.Reverso(device="cpu")` on the other. The status
strings must be equal word for word, the two stores equal afterwards
(count, `vector_version`, `data_version`, `mutation_epoch`, every
space's vectors bit for bit, payloads, sparse and multivector rows,
deleted masks), and the next searches equal (test_torch_query.py's
rule: float32 scores within 1e-5, ids equal outside ties). The cases
follow the reference's test_delete_vectors.py and the mutation cases of
test_recommend.py, test_sparse.py and test_groups.py.
"""
import shutil

import numpy as np
import pytest

from reverso_tpu_torch.store import VectorStore

from test_torch_query import D, DA, DM, _unit, build_store, engines, same

N = 600


@pytest.fixture(scope="module")
def seed_store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mut_seed"))
    x, aux = build_store(root, n=N)
    return root, x, aux


def _pair(seed_store, tmp_path):
    """Two copies of the seed store (same versions), one engine each."""
    src, x, aux = seed_store
    roots = []
    for side in ("jax", "port"):
        dst = str(tmp_path / side)
        shutil.copytree(src, dst)
        roots.append(dst)
    jax_eng, _ = engines(roots[0])
    _, port = engines(roots[1])
    assert "Loaded" in jax_eng.load_database("main")
    assert "Loaded" in port.load_database("main")
    return jax_eng, port, roots, x, aux


def _store_state(root):
    s = VectorStore.open(root, "main")
    try:
        rows = list(range(s.count))
        return {"count": s.count, "vector_version": s.vector_version,
                "data_version": s.data_version,
                "mutation_epoch": s.mutation_epoch,
                "vectors": np.array(s.vectors()), "aux": np.array(s.vectors("aux")),
                "payloads": s.payloads(rows),
                "deleted": s.deleted_rows().tolist(),
                "deleted_aux": s.deleted_rows("aux").tolist(),
                "sparse": s.sparse_rows("sp", rows),
                "multi": [None if m is None else np.asarray(m)
                          for m in s.multivector_rows("mv", rows)]}
    finally:
        s.close()


def _assert_same_stores(roots):
    j, t = (_store_state(r) for r in roots)
    for key in ("vectors", "aux"):
        np.testing.assert_array_equal(t[key], j[key])
    for key in ("count", "vector_version", "data_version", "mutation_epoch",
                "payloads", "deleted", "deleted_aux"):
        assert t[key] == j[key], key
    same(j["sparse"], t["sparse"], tol=0.0)
    assert len(t["multi"]) == len(j["multi"])
    for a, b in zip(j["multi"], t["multi"]):
        assert (a is None) == (b is None) or (len(a) == 0 and len(b) == 0)
        if a is not None and b is not None:
            np.testing.assert_array_equal(b, a)


def _next_searches(eng, x, aux):
    """The searches after a mutation: plain, filtered, named, sparse,
    multivector, a recommend and a group-by."""
    return [eng.search_batch(x[:4] + 0.01, 10),
            eng.search_batch(x[4:6], 10, filter={"cls": "car"}),
            eng.query(aux[1], k=8, using="aux"),
            eng.query({"indices": [1, 7, 20], "values": [1.0, 1.0, 1.0]},
                      k=8, using="sp"),
            eng.query(np.stack([aux[0][:DM]]), k=8, using="mv"),
            eng.query({"recommend": {"positive": [2, 3]}}, k=8),
            eng.query_groups(x[9], group_by="folder", limit=3, group_size=2),
            eng.search_matrix(sample=16, limit=2, seed=0),
            eng.count(), eng.count({"cls": "dog"})]


def _unit_rows(seed, n, d):
    return _unit(np.random.default_rng(seed), n, d)


def _upsert(e):
    return e.upsert_points({"": _unit_rows(5, 3, D), "aux": _unit_rows(6, 3, DA),
                            "sp": [{"indices": [2, 7], "values": [0.5, 1.0]}, None,
                                   {"indices": [40], "values": [2.0]}],
                            "mv": [_unit_rows(7, 2, DM), None, _unit_rows(8, 1, DM)]},
                           [{"region_id": "new0", "cls": "car", "folder": 1},
                            {"region_id": "new1"}, {"cls": "dog"}])


# name -> list of engine calls, applied in order to both engines
CASES = {
    "set_payload_points": [lambda e: e.set_payload({"tag": "x", "folder": 9},
                                                   points=[1, "r5", 77])],
    "set_payload_filter": [lambda e: e.set_payload({"seen": True},
                                                   filter={"cls": "dog"})],
    "overwrite_payload": [lambda e: e.overwrite_payload({"only": 1}, points=[3, 4])],
    "delete_payload": [lambda e: e.delete_payload(["cls", "price"],
                                                  filter="confidence<0.3")],
    "clear_payload": [lambda e: e.clear_payload(points=["r7", 8])],
    "payload_nothing_selected": [lambda e: e.set_payload({"a": 1}),
                                 lambda e: e.clear_payload(points=["nope"])],
    "payload_bad_filter": [lambda e: e.set_payload({"a": 1}, filter={"must": 3})],
    "delete_points_filter": [lambda e: e.delete_points({"folder": 9})],
    "delete_points_ids": [lambda e: e.delete_points(points=[0, "r10", 599, "nope"])],
    "delete_points_empty": [lambda e: e.delete_points(),
                            lambda e: e.delete_points(points=["nope"])],
    "upsert_points": [_upsert],
    "upsert_errors": [lambda e: e.upsert_points({"": np.zeros((1, D)),
                                                 "aux": _unit_rows(1, 1, DA),
                                                 "sp": [None], "mv": [None]}),
                      lambda e: e.upsert_points({"": _unit_rows(1, 2, D),
                                                 "aux": _unit_rows(1, 1, DA),
                                                 "sp": [None, None],
                                                 "mv": [None, None]})],
    "update_vectors": [lambda e: e.update_vectors([4, "r9"], _unit_rows(3, 2, D) * 3)],
    "update_vectors_named": [lambda e: e.update_vectors([2], _unit_rows(4, 1, DA),
                                                        using="aux")],
    "update_vectors_sparse": [lambda e: e.update_vectors(
        [5, 6], [{"indices": [1, 3], "values": [1.0, 2.0]}, None], using="sp")],
    "update_vectors_multi": [lambda e: e.update_vectors(
        [5, 6], [_unit_rows(9, 3, DM), None], using="mv")],
    "update_vectors_unknown": [lambda e: e.update_vectors(["nope"], _unit_rows(3, 1, D)),
                               lambda e: e.update_vectors([1, 2], _unit_rows(3, 1, D))],
    "delete_vectors_points": [lambda e: e.delete_vectors([3, "r40", 41])],
    "delete_vectors_filter_spaces": [lambda e: e.delete_vectors(
        spaces=["aux", "sp", "mv"], filter={"folder": 2})],
    "delete_vectors_resurrect": [lambda e: e.delete_vectors(list(range(0, 60, 3))),
                                 lambda e: e.update_vectors([3], _unit_rows(2, 1, D))],
    "delete_vectors_errors": [lambda e: e.delete_vectors([1], spaces="nope"),
                              lambda e: e.delete_vectors([1], spaces=[]),
                              lambda e: e.delete_vectors()],
    "update_batch_upsert_needs_every_space": [lambda e: e.update_batch([
        {"upsert": {"vectors": _unit_rows(11, 2, D), "payloads": None}}])],
    "update_batch": [lambda e: e.update_batch([
        {"set_payload": {"payload": {"b": 1}, "points": ["r3"], "filter": {"cls": "car"}}},
        {"delete": {"filter": {"folder": 4}}},
        {"update_vectors": {"points": ["r5"], "vectors": _unit_rows(12, 1, D)}},
        {"delete_vectors": {"points": ["r6"], "spaces": ["aux"]}},
        {"overwrite_payload": {"payload": {"c": 2}, "points": [1]}},
        {"delete_payload": {"keys": ["price"], "filter": "confidence>0.9"}},
        {"clear_payload": {"points": [2]}}])],
    "update_batch_invalid": [lambda e: e.update_batch([{"set_payload": {"points": [1]}}]),
                             lambda e: e.update_batch([{"nope": {}}]),
                             lambda e: e.update_batch([{"delete_vectors": {
                                 "points": [1], "spaces": []}}]),
                             lambda e: e.update_batch([])],
    "index_payload": [lambda e: e.index_payload(["cls", "folder"]),
                      lambda e: e.index_payload(["filename"], text=True),
                      lambda e: e.index_payload([])],
}


@pytest.mark.parametrize("case", list(CASES))
def test_mutations_match_jax(seed_store, tmp_path, case):
    jax_eng, port, roots, x, aux = _pair(seed_store, tmp_path)
    for n, op in enumerate(CASES[case]):
        js, ts = op(jax_eng), op(port)
        assert ts == js.replace(roots[0], roots[1]), (n, js, ts)
    _assert_same_stores(roots)
    same(_next_searches(jax_eng, x, aux), _next_searches(port, x, aux))


def test_one_space_store_upserts_match_jax(tmp_path):
    """A store with the default space only: upsert_points takes a plain
    array, and update_batch's upsert mixes with the other operations."""
    rng = np.random.default_rng(3)
    x = _unit_rows(3, 300, D)
    src = str(tmp_path / "seed")
    with VectorStore.create(src, "main", D) as s:
        s.append(x, [{"cls": ("a", "b")[i % 2], "region_id": f"r{i}"} for i in range(300)])
    roots = []
    for side in ("jax", "port"):
        roots.append(str(tmp_path / side))
        shutil.copytree(src, roots[-1])
    jax_eng, _ = engines(roots[0])
    _, port = engines(roots[1])
    rng_rows = [rng.standard_normal((4, D)), rng.standard_normal((2, D)),
                rng.standard_normal((3, D))]
    ops = [lambda e: e.upsert_points(rng_rows[0] * 2.0, [{"cls": "c"}] * 4),
           lambda e: e.upsert_points(rng_rows[1][0]),
           lambda e: e.update_batch([
               {"upsert": {"vectors": rng_rows[2], "payloads": [{"n": i} for i in range(3)]}},
               {"delete": {"points": ["r1", 2]}},
               {"update_vectors": {"points": ["r5"], "vectors": rng_rows[1][1]}},
               {"set_payload": {"payload": {"z": 1}, "filter": {"cls": "c"}}},
               {"delete_vectors": {"points": ["r7"]}}])]
    for e in (jax_eng, port):
        e.load_database("main")
    for op in ops:
        js, ts = op(jax_eng), op(port)
        assert ts == js and ts.startswith("✅"), (js, ts)
    for r in roots:
        with VectorStore.open(r, "main") as s:
            assert s.count == 300 + 4 + 1 + 3 - 2
    np.testing.assert_array_equal(*(np.array(VectorStore.open(r, "main").vectors())
                                    for r in roots))
    q = x[:4] + 0.05
    same(jax_eng.search_batch(q, 10), port.search_batch(q, 10))
    same(jax_eng.query_batch([{"query": q[0], "filter": {"z": 1}}]),
         port.query_batch([{"query": q[0], "filter": {"z": 1}}]))


def test_payload_mutation_keeps_the_device_index(seed_store, tmp_path):
    """A payload-only mutation keeps the index object across the
    writable swap ((count, vector_version) holds); a vector mutation
    rebuilds it."""
    _, port, _, x, _ = _pair(seed_store, tmp_path)
    port.search_batch(x[:1], 5)
    before = port._indexes[""][1]
    assert port.set_payload({"k": 1}, points=[1]).startswith("✅")
    assert port._indexes[""][1] is before
    port.search_batch(x[:1], 5)
    assert port._indexes[""][1] is before
    assert port.update_vectors([1], x[2:3]).startswith("✅")
    port.search_batch(x[:1], 5)
    assert port._indexes[""][1] is not before


def test_deleted_vectors_leave_every_surface(seed_store, tmp_path):
    """delete_vectors: the rows leave plain and filtered scans, the
    combines, search_matrix samples and random samples in both packages;
    a point id operand whose vector is gone raises the same error."""
    jax_eng, port, _, x, _ = _pair(seed_store, tmp_path)
    gone = list(range(0, N, 2))
    for e in (jax_eng, port):
        assert e.delete_vectors(gone).startswith("✅")
    calls = [lambda e: e.search_batch(x[:3], 10),
             lambda e: e.search_batch(x[:3], 10, filter={"cls": "car"}),
             lambda e: e.query({"recommend": {"positive": [1], "negative": [3],
                                              "strategy": "best_score"}}, k=10),
             lambda e: e.query({"context": [(1, 3)]}, k=10),
             lambda e: e.search_matrix(sample=32, limit=2, seed=4),
             lambda e: e.query({"sample": "random"}, k=20, seed=2),
             lambda e: e.retrieve([0, 1], with_vectors=True)]
    for fn in calls:
        same(fn(jax_eng), fn(port))
    ids = port.search_batch(x[:3], 10)[1]
    assert not (set(ids.ravel().tolist()) & set(gone))
    for e in (jax_eng, port):
        with pytest.raises(Exception, match="deleted via delete_vectors"):
            e.query(0, k=3)


def test_no_database_statuses_match_jax(tmp_path):
    jax_eng, port = engines(str(tmp_path))
    for fn in (lambda e: e.set_payload({"a": 1}, points=[1]),
               lambda e: e.delete_points({"a": 1}),
               lambda e: e.upsert_points(np.ones((1, D))),
               lambda e: e.update_vectors([1], np.ones((1, D))),
               lambda e: e.delete_vectors([1]),
               lambda e: e.update_batch([]),
               lambda e: e.index_payload(["a"])):
        assert fn(port) == fn(jax_eng)
