"""Universal-query surface: the qdrant query model over the engine core.

Mixin providing `Reverso`'s read-side query orchestration — the qdrant
Points-API surface (reference analog: the brute-force `vector_db.search`
at core_system.py:659-664, vastly exceeded here to match qdrant
query_points / query_points_groups / query_batch_points / recommend /
discover / scroll / retrieve / facet / search_matrix semantics):

  * `query` — universal query: plain/nearest, prefetch branches with
    RRF/DBSF fusion or exact rescore, recommend/discover/context/
    order_by operands, MMR diversification, formula rescoring, random
    sampling, named/sparse/multivector spaces, lookup_from;
  * `query_groups` / `query_batch` — grouped and batched variants;
  * `recommend` / `discover` — qdrant recommend & discover APIs;
  * `scroll` / `retrieve` / `facet` / `search_matrix` — points reads.

The mixin consumes a narrow engine interface implemented by `Reverso`
in engine.py: `_store`/`db_root`/`config`, `_get_index` /
`_get_sparse_index` / `_filter_mask` / `_presence_and` /
`_drop_deleted` / `_payload_columns` / `_payloads_with` /
`_render_hits` / `_attach_group_lookups` plus the searcher facade and
`text_embedder`. It holds no state of its own; everything lands on the
engine instance. The method bodies are the JAX package's; the index
searches return device tensors, fetched to the host with
`store.index.to_host`.
`query_batch` coalesces requests only under an exact key (a filter that
does not serialise to plain JSON runs per request).
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from .store import VectorStore, StoreError
from .store.index import to_host


def _fetch(result) -> tuple:
    """(scores, ids) of a search -> host arrays."""
    return tuple(to_host(a) for a in result)


def _exact_key(spec):
    """Grouping key of a filter spec for query_batch's coalescing: its
    canonical JSON, or None when it does not serialise to plain JSON
    (a numpy array, a Filter object). A `default=repr` key would join
    two filters whose reprs agree (numpy truncates long arrays with
    "..."), and the group would run under the first one's filter."""
    try:
        return json.dumps(spec, sort_keys=True)
    except (TypeError, ValueError):
        return None


def _unwrap_nearest(q):
    """qdrant NearestQuery: {"nearest": op} == the bare operand. Only
    the exact one-key wrapper unwraps — beside "mmr" the dict is the
    mmr spec, and multi-key dicts are other query types."""
    if isinstance(q, dict) and set(q) == {"nearest"}:
        return q["nearest"]
    return q


def _sample_rows(rng: np.random.Generator, n: int, count: int,
                 mask=None) -> np.ndarray:
    """Up to `n` distinct row ids drawn uniformly without replacement
    (unsorted). Shared by `Reverso.query`'s `{"sample": "random"}` and
    `Reverso.search_matrix`.

    When no filter narrows the population and n << count, rejection
    sampling avoids materializing a [count]-sized id array (numpy's
    `choice(replace=False)` permutes the whole population — 32 MB of
    ids per draw at 4M rows)."""
    if mask is not None:
        valid = np.nonzero(mask)[0]
        if len(valid) <= n:
            rows = valid.copy()
            rng.shuffle(rows)
            return rows
        return rng.choice(valid, size=n, replace=False)
    if count <= n:
        rows = np.arange(count)
        rng.shuffle(rows)
        return rows
    if n * 32 <= count:
        out: list = []
        seen: set = set()
        while len(out) < n:
            for v in rng.integers(0, count, size=2 * (n - len(out))):
                v = int(v)
                if v not in seen:
                    seen.add(v)
                    out.append(v)
                    if len(out) == n:
                        break
        return np.asarray(out, np.int64)
    return rng.choice(count, size=n, replace=False)



class UniversalQuery:
    """Query-surface mixin for `Reverso` (see module docstring)."""

    def _lookup_store(self, spec):
        """qdrant lookup_from: `{"collection": name, "vector": space?}`
        (or just the collection name) -> (read-only VectorStore,
        space). Point-id operands then resolve against THAT
        collection's vectors instead of the loaded one. Caller closes
        the store."""
        if isinstance(spec, str):
            spec = {"collection": spec}
        if not isinstance(spec, dict) or not spec.get("collection"):
            raise ValueError('lookup_from must be {"collection": name, '
                             '"vector": space?} or a collection name')
        from .store.persist import resolve_alias
        name = resolve_alias(self.db_root, str(spec["collection"]))
        store = VectorStore.open(self.db_root, name)
        space = str(spec.get("vector") or "")
        if space and space not in store.spaces():
            store.close()
            raise ValueError(f"lookup collection {name!r} has no vector "
                             f"space {space!r}")
        return store, space

    def _resolve_examples(self, examples, using: str = "",
                          lookup=None) -> Optional[np.ndarray]:
        """Recommend inputs -> [M, d] f32. Accepts stored point ids
        (ints), [d] vectors, [M, d] arrays, or a mixed list of those;
        point ids resolve in the `using` vector space — or, with
        `lookup=(store, space)` (qdrant lookup_from), in ANOTHER
        collection's space (dims must match the target space)."""
        if examples is None:
            return None
        if not isinstance(examples, (list, tuple)):
            examples = [examples]
        rows: list[np.ndarray] = []
        for e in examples:
            if isinstance(e, (int, np.integer)):
                store, space = ((self._store, using) if lookup is None
                                else lookup)
                if store is None:
                    raise StoreError("no database loaded")
                i = int(e)
                if not 0 <= i < store.count:
                    raise ValueError(
                        f"point id {i} out of range (store has "
                        f"{store.count} points)")
                rows.append(np.asarray(store.vectors(space)[i],
                                       np.float32))
            else:
                v = np.asarray(e, np.float32)
                if v.ndim == 1:
                    rows.append(v)
                elif v.ndim == 2:
                    rows.extend(v)
                else:
                    raise ValueError(f"bad example shape {v.shape}")
        if not rows:
            return None
        out = np.stack(rows)
        if lookup is not None and self._store is not None:
            expected = self._store.spaces().get(using)
            if expected and out.shape[1] != expected:
                raise ValueError(
                    f"lookup_from vectors are {out.shape[1]}-d but the "
                    f"target space {using or 'default'!r} is "
                    f"{expected}-d")
        return out

    def recommend(self, positive, negative=None,
                  max_results: Optional[int] = None,
                  similarity_threshold: Optional[float] = None, *,
                  strategy: str = "average", filter=None,
                  use_batcher: bool = False, using: str = "",
                  lookup_from=None):
        """Search by positive/negative example points — the role of
        qdrant's recommend API over the reference's store
        (core_system.py:659-664 is the search it feeds). Examples are
        stored point ids (row ids as returned in search results) or raw
        embedding vectors; `strategy` is "average" (ONE composed query
        through the fused kernel; works on every index incl. IVF),
        "sum_scores" (qdrant's summed-similarity strategy — also ONE
        composed query by dot linearity, scores are the summed sims;
        cosine/dot stores), or "best_score" (every row ranked against
        every example via qdrant's best-score combine; exact index
        only). Returns
        (text, items) like search_similar. Unlike search_similar there
        is no default score threshold (qdrant's recommend has none, and
        best_score values are not plain cosines once negatives bite).
        `lookup_from={"collection": name, "vector": space?}` resolves
        example point ids in ANOTHER collection (qdrant lookup_from);
        those ids then refer to that collection, so no example
        self-exclusion applies here.
        """
        from .ops.recommend import average_query, sum_scores_query

        store = self._store
        if store is None:
            return ("❌ No database loaded. Please create or load a database first.", [])
        k = self.config.search.top_k if max_results is None else int(max_results)
        threshold = (-np.inf if similarity_threshold is None
                     else float(similarity_threshold))
        # example points never recommend themselves (qdrant semantics);
        # over-fetch so exclusion cannot shrink the page below k.
        # Ids under lookup_from name points of the OTHER collection —
        # nothing to exclude locally.
        exclude = set()
        if lookup_from is None:
            for group in (positive, negative):
                if group is None:
                    continue
                for e in (group if isinstance(group, (list, tuple))
                          else [group]):
                    if isinstance(e, (int, np.integer)):
                        exclude.add(int(e))
        k_fetch = k + len(exclude)
        lstore = None
        try:
            lookup = None
            if lookup_from is not None:
                lstore, lspace = self._lookup_store(lookup_from)
                lookup = (lstore, lspace)
            pos = self._resolve_examples(positive, using, lookup=lookup)
            neg = self._resolve_examples(negative, using, lookup=lookup)
            if pos is None or not len(pos):
                return ("❌ Recommend needs at least one positive example.", [])
            mask = self._filter_mask(filter) if filter is not None else None
            if strategy in ("average", "sum_scores"):
                if strategy == "sum_scores":
                    # qdrant sum_scores composes to one UNnormalized
                    # query by dot linearity (ops.recommend); the
                    # returned scores are the summed similarities,
                    # which only a dot-family metric defines
                    if store.distance in ("euclid", "manhattan"):
                        return ("❌ strategy='sum_scores' sums dot "
                                "similarities — not defined on a "
                                f"{store.distance}-distance store.", [])
                    q = sum_scores_query(pos, neg)
                else:
                    q = average_query(pos, neg)
                if mask is None and use_batcher and k_fetch <= 128:
                    # coalesce with in-flight searches: the composed
                    # query is just one more row in the launch batch
                    scores, ids = self.searcher.search(q, k_fetch,
                                                       space=using)
                    scores, ids = scores[None], ids[None]
                else:
                    scores, ids = _fetch(
                        self._get_index(using).search(q[None], k_fetch,
                                                      row_mask=mask))
            elif strategy == "best_score":
                index = self._get_index(using)
                if not hasattr(index, "best_score"):
                    return ("❌ strategy='best_score' needs the exact index "
                            "(the IVF index only supports strategy='average').", [])
                scores, ids = _fetch(
                    index.best_score(pos, neg, k_fetch, row_mask=mask))
            else:
                return (f"❌ Unknown strategy '{strategy}' (use "
                        "'average', 'sum_scores', or 'best_score').", [])
        except (StoreError, ValueError) as e:
            return (f"❌ {e}", [])
        finally:
            if lstore is not None:
                lstore.close()
        hits = [(float(s), int(i)) for s, i in zip(scores[0], ids[0])
                if i >= 0 and s >= threshold and int(i) not in exclude][:k]
        if not hits:
            return ("❌ No recommendations found.", [])
        return self._render_hits(hits, store)

    def discover(self, target=None, context=None,
                 max_results: Optional[int] = None, *, filter=None,
                 using: str = "", lookup_from=None):
        """qdrant's discovery API role over the reference's store
        (core_system.py:659-664 is the search it feeds). `context` is a
        list of (positive, negative) example pairs — stored point ids or
        raw vectors; each pair votes per row (+1 when the row sides with
        the pair's positive), and rows rank by vote total with target
        similarity breaking ties (`ops.recommend.discover_topk`). With
        `target=None` this is a pure context search (rank by summed
        pair loss; 0 = inside every positive zone). Example point ids
        never return themselves. Scores in the items are the composite
        ranking keys, not cosines. Exact index only (like
        strategy='best_score')."""

        store = self._store
        if store is None:
            return ("❌ No database loaded. Please create or load a database first.", [])
        k = self.config.search.top_k if max_results is None else int(max_results)
        pairs = list(context) if context else []
        if target is None and not pairs:
            return ("❌ Discover needs a target and/or context pairs.", [])
        exclude = set()
        if lookup_from is None:
            for e in [target, *(x for p in pairs for x in p)]:
                if isinstance(e, (int, np.integer)):
                    exclude.add(int(e))
        k_fetch = k + len(exclude)
        lstore = None
        try:
            lookup = None
            if lookup_from is not None:
                lstore, lspace = self._lookup_store(lookup_from)
                lookup = (lstore, lspace)
            tgt = (self._resolve_examples(target, using, lookup=lookup)
                   if target is not None else None)
            if tgt is not None and len(tgt) != 1:
                raise ValueError("discover takes exactly one target")
            pos = neg = None
            if pairs:
                if not all(isinstance(p, (list, tuple)) and len(p) == 2
                           for p in pairs):
                    raise ValueError(
                        "context must be (positive, negative) pairs")
                pos = self._resolve_examples([p[0] for p in pairs],
                                             using, lookup=lookup)
                neg = self._resolve_examples([p[1] for p in pairs],
                                             using, lookup=lookup)
                if len(pos) != len(pairs) or len(neg) != len(pairs):
                    raise ValueError(
                        "each context pair needs exactly one positive and "
                        "one negative example")
            mask = self._filter_mask(filter) if filter is not None else None
            index = self._get_index(using)
            if not hasattr(index, "discover"):
                return ("❌ discover needs the exact index (not IVF).", [])
            if tgt is not None:
                scores, ids = _fetch(
                    index.discover(tgt[0], pos, neg, k_fetch, row_mask=mask))
            else:
                scores, ids = _fetch(
                    index.context(pos, neg, k_fetch, row_mask=mask))
        except (StoreError, ValueError) as e:
            return (f"❌ {e}", [])
        finally:
            if lstore is not None:
                lstore.close()
        hits = [(float(s), int(i)) for s, i in zip(scores[0], ids[0])
                if i >= 0 and int(i) not in exclude][:k]
        if not hits:
            return ("❌ No discovery results found.", [])
        return self._render_hits(hits, store)

    def _exact_scores(self, vecs: np.ndarray, qv: np.ndarray) -> np.ndarray:
        """Exact f32 similarity of rows against one query under the
        store's distance (distance metrics report -distance so
        higher-is-better holds everywhere)."""
        vecs = np.asarray(vecs, np.float32)
        if self._store.distance == "euclid":
            return -np.linalg.norm(vecs - qv[None, :], axis=1)
        if self._store.distance == "manhattan":
            return -np.abs(vecs - qv[None, :]).sum(axis=1)
        return vecs @ qv

    def _mmr_select(self, spec: dict, k: int, gmask, using: str,
                    cand=None) -> list:
        """Maximal Marginal Relevance result diversification — the
        qdrant 1.15 `mmr` query. Greedy: the first pick is the most
        relevant candidate; each later pick maximizes
        `(1 - diversity) * rel - diversity * max_sim_to_selected`
        (diversity 0 = plain top-k, 1 = pure diversity), ties to the
        lower point id. Returns [(relevance score, id)] in SELECTION
        order. `cand` (prefetch union) replaces the candidate scan;
        relevance is then the exact rescore against `nearest`.
        Candidate pool size is `candidates_limit` (default
        max(10*k, 100)) — MMR needs pairwise sims, so the pool is
        deliberately k-scale, qdrant's own shape."""

        store = self._store
        mmr = spec.get("mmr")
        if not isinstance(mmr, dict):
            raise ValueError('mmr must be an object: {"diversity": ..., '
                             '"candidates_limit": ...}')
        diversity = float(mmr.get("diversity", 0.5))
        if not 0.0 <= diversity <= 1.0:
            raise ValueError(f"mmr diversity must be in [0, 1], got "
                             f"{diversity}")
        climit = int(mmr.get("candidates_limit", max(10 * k, 100)))
        if climit < 1:
            raise ValueError("mmr candidates_limit must be >= 1")
        if "nearest" not in spec:
            raise ValueError('an mmr query needs a "nearest" operand: '
                             '{"nearest": <vector|id>, "mmr": {...}}')
        if using and (using in store.sparse or using in store.multi):
            raise StoreError("mmr needs a dense vector space (pairwise "
                             "similarities of the candidates)")
        qv = self._resolve_query_vector(spec["nearest"], using)
        if cand is None:
            kf = min(climit, max(store.count, 1))
            s, i = _fetch(
                self._get_index(using).search(qv[None], kf,
                                              row_mask=gmask))
            valid = i[0] >= 0
            cand = [int(x) for x in i[0][valid]]
            rel = np.asarray(s[0][valid], np.float64)
            vecs = np.asarray(store.vectors(using)[cand], np.float32)
        else:
            # the prefetch union may cross spaces: a candidate found in
            # another branch can have a deleted vector HERE — drop it
            # before computing relevance (stale on-disk bytes must not
            # enter the MMR pool)
            cand = self._drop_deleted(list(cand), using)
            if not cand:
                return []
            vecs = np.asarray(store.vectors(using)[cand], np.float32)
            rel = self._exact_scores(vecs, qv).astype(np.float64)
            if len(cand) > climit:
                keep = np.lexsort((np.asarray(cand), -rel))[:climit]
                keep.sort()
                cand = [cand[j] for j in keep]
                vecs, rel = vecs[keep], rel[keep]
        if not cand:
            return []
        ids = np.asarray(cand, np.int64)
        max_sim = np.full(len(cand), -np.inf)
        remaining = np.ones(len(cand), bool)
        out = []
        for step in range(min(k, len(cand))):
            obj = rel if step == 0 else \
                (1.0 - diversity) * rel - diversity * max_sim
            obj = np.where(remaining, obj, -np.inf)
            j = int(np.lexsort((ids, -obj))[0])
            if np.isneginf(obj[j]):
                break
            out.append((float(rel[j]), int(ids[j])))
            remaining[j] = False
            max_sim = np.maximum(max_sim,
                                 self._exact_scores(vecs, vecs[j]))
        return out

    def _resolve_query_vector(self, q, using: str = "") -> np.ndarray:
        """A query operand -> [d] fp32 vector: int row id, region_id
        string, `{"text": ...}` (CLIP/PE text tower), or an explicit
        vector. Point ids resolve (and explicit vectors validate)
        against the `using` vector space."""
        store = self._store
        if isinstance(q, dict) and "text" in q:
            if self.text_embedder is None:
                raise StoreError("no text encoder configured; load "
                                 "CLIP/PE text weights for text queries")
            emb = np.asarray(self.text_embedder.embed(str(q["text"])),
                             np.float32)
            return emb.reshape(-1)
        if isinstance(q, (int, np.integer)):
            if not 0 <= int(q) < store.count:
                raise StoreError(f"point id {int(q)} out of range "
                                 f"[0, {store.count})")
            if using in store.multi:
                return store.multivector_rows(using, [int(q)])[0]
            if using in store.spaces() \
                    and int(q) in store.deleted_rows(using):
                raise StoreError(
                    f"point {int(q)} has no vector in space {using!r} "
                    f"(deleted via delete_vectors)")
            return np.asarray(store.vectors(using)[int(q)], np.float32)
        if isinstance(q, str):
            pts = self.retrieve([q], with_payload=False, with_vectors=True,
                                using=using)
            if not pts:
                raise StoreError(f"no point with region_id {q!r}")
            if "vector" not in pts[0]:   # delete_vectors removed it
                raise StoreError(
                    f"point {q!r} has no vector in space {using!r} "
                    f"(deleted via delete_vectors)")
            return pts[0]["vector"]
        if using in store.multi:
            # multivector space: [d] or [Tq, d] query operands
            d = store.multi[using]
            v = np.asarray(q, np.float32)
            if v.ndim == 1:
                v = v[None]
            if v.ndim != 2 or v.shape[1] != d:
                raise StoreError(f"multivector query must be [*, {d}], "
                                 f"got {v.shape}")
            return v
        d = store.spaces().get(using)
        if d is None:
            raise StoreError(f"unknown vector space {using!r} "
                             f"(have {sorted(store.spaces())})")
        v = np.asarray(q, np.float32).reshape(-1)
        if v.shape != (d,):
            raise StoreError(f"query vector must be [{d}], "
                             f"got {v.shape}")
        return v

    def _resolve_sparse_query(self, q, space: str):
        """A query operand against a SPARSE space -> {"indices",
        "values"} dict (or pair): int row id / region_id string
        resolve to the stored sparse vector; explicit sparse dicts
        pass through (validated at search time)."""
        store = self._store
        if isinstance(q, (int, np.integer)):
            if not 0 <= int(q) < store.count:
                raise StoreError(f"point id {int(q)} out of range "
                                 f"[0, {store.count})")
            return store.sparse_rows(space, [int(q)])[0]
        if isinstance(q, str):
            pts = self.retrieve([q], with_payload=False)
            if not pts:
                raise StoreError(f"no point with region_id {q!r}")
            return store.sparse_rows(space, [pts[0]["id"]])[0]
        if isinstance(q, dict) and "text" in q:
            raise StoreError("text queries need a dense space (no "
                             "sparse text encoder is configured)")
        return q

    _COMBINE_KINDS = ("recommend", "discover", "context")

    @staticmethod
    def _is_combine(q) -> bool:
        """One of qdrant's example-combine universal-query operand
        types: {"recommend": ...} / {"discover": ...} /
        {"context": ...} (exactly one key, qdrant's wrapper shape)."""
        return (isinstance(q, dict) and len(q) == 1
                and next(iter(q)) in UniversalQuery._COMBINE_KINDS)

    @staticmethod
    def _is_order_by(q) -> bool:
        return isinstance(q, dict) and set(q) == {"order_by"}

    @staticmethod
    def _norm_pairs(context):
        """Context pairs in either accepted shape -> [(pos, neg), ...]:
        qdrant's [{"positive": p, "negative": n}, ...] or plain
        (p, n) 2-sequences."""
        if context is None:
            return []
        out = []
        for p in context:
            if isinstance(p, dict):
                if set(p) != {"positive", "negative"}:
                    raise ValueError(
                        'context pairs are {"positive": p, "negative":'
                        ' n} (or (p, n) tuples), got '
                        f'{sorted(p)!r}')
                out.append((p["positive"], p["negative"]))
            elif isinstance(p, (list, tuple)) and len(p) == 2:
                out.append((p[0], p[1]))
            else:
                raise ValueError(
                    "context must be (positive, negative) pairs, got "
                    f"{p!r}")
        return out

    def _combine_pairs(self, spec: dict, k: int, mask, using: str = ""):
        """qdrant's example-combine universal-query operand types —
        RecommendQuery / DiscoverQuery / ContextQuery inside
        query_points — as (score, id) pairs over `mask`. All three are
        masked index scans, so the SAME helper serves a standalone
        query, a prefetch branch, and a rescore of the candidate union
        (the caller passes the union as the mask). Example point ids
        never return themselves (their mask bits clear — exact, no
        over-fetch); ids pre-resolved to vectors by lookup_from are
        therefore NOT excluded, matching the other lookup paths."""

        from .ops.recommend import average_query, sum_scores_query

        store = self._store
        if using and (using in store.sparse or using in store.multi):
            raise ValueError(
                "recommend/discover/context operands need a dense "
                f"vector space ({using!r} is not one)")
        (kind, body), = spec.items()

        def ids_of(x):
            if x is None:
                return []
            xs = x if isinstance(x, (list, tuple)) else [x]
            return [int(e) for e in xs if isinstance(e, (int, np.integer))]

        index = self._get_index(using)
        exclude: set = set()
        if kind == "recommend":
            if not isinstance(body, dict) or body.get("positive") is None:
                raise ValueError(
                    'recommend operand must be {"positive": [...], '
                    '"negative": [...]?, "strategy": ...?}')
            strategy = str(body.get("strategy") or "average")
            if strategy == "average_vector":     # qdrant's name
                strategy = "average"
            pos = self._resolve_examples(body["positive"], using)
            neg = self._resolve_examples(body.get("negative"), using)
            if pos is None or not len(pos):
                raise ValueError(
                    "recommend needs at least one positive example")
            exclude.update(ids_of(body["positive"]))
            exclude.update(ids_of(body.get("negative")))
            if strategy in ("average", "sum_scores"):
                if strategy == "sum_scores" and store.distance in (
                        "euclid", "manhattan"):
                    raise ValueError(
                        "strategy='sum_scores' sums dot similarities — "
                        "not defined on a "
                        f"{store.distance}-distance store")
                q = (sum_scores_query(pos, neg) if strategy == "sum_scores"
                     else average_query(pos, neg))
                run = lambda m: index.search(q[None], k, row_mask=m)
            elif strategy == "best_score":
                if not hasattr(index, "best_score"):
                    raise ValueError(
                        "strategy='best_score' needs the exact index")
                run = lambda m: index.best_score(pos, neg, k, row_mask=m)
            else:
                raise ValueError(
                    f"unknown recommend strategy {strategy!r} (use "
                    "'average', 'sum_scores', or 'best_score')")
        elif kind == "discover":
            if not isinstance(body, dict) or (
                    body.get("target") is None
                    and not body.get("context")):
                raise ValueError(
                    'discover operand must be {"target": op?, '
                    '"context": [pairs]?} with at least one of them')
            tgt = (self._resolve_examples(body.get("target"), using)
                   if body.get("target") is not None else None)
            if tgt is not None and len(tgt) != 1:
                raise ValueError("discover takes exactly one target")
            pairs = self._norm_pairs(body.get("context"))
            pos = self._resolve_examples([p for p, _ in pairs], using)
            neg = self._resolve_examples([n for _, n in pairs], using)
            exclude.update(ids_of(body.get("target")))
            for p, n in pairs:
                exclude.update(ids_of(p) + ids_of(n))
            if not hasattr(index, "discover"):
                raise ValueError(
                    "discover needs the exact index (not IVF)")
            if tgt is not None:
                t0 = tgt[0]
                run = lambda m: index.discover(t0, pos, neg, k,
                                               row_mask=m)
            else:
                run = lambda m: index.context(pos, neg, k, row_mask=m)
        else:                                    # context
            pairs = self._norm_pairs(body)
            if not pairs:
                raise ValueError("context needs at least one "
                                 "(positive, negative) pair")
            pos = self._resolve_examples([p for p, _ in pairs], using)
            neg = self._resolve_examples([n for _, n in pairs], using)
            for p, n in pairs:
                exclude.update(ids_of(p) + ids_of(n))
            if not hasattr(index, "context"):
                raise ValueError(
                    "context needs the exact index (not IVF)")
            run = lambda m: index.context(pos, neg, k, row_mask=m)

        m = mask
        rows = [i for i in exclude if 0 <= i < store.count]
        if rows:
            m = (np.ones(store.count, bool) if mask is None
                 else np.asarray(mask, bool)[:store.count].copy())
            m[rows] = False
        scores, ids = _fetch(run(m))
        return [(float(s), int(i)) for s, i in zip(scores[0], ids[0])
                if i >= 0]

    def _order_by_pairs(self, body, k: int, mask):
        """qdrant's order_by universal-query operand: points sorted by
        a numeric/datetime payload key (the ordered-scroll semantics —
        missing/unordered rows drop, ties to the lower id). The
        returned "score" is the ordering value (qdrant returns null
        scores; the value is strictly more informative)."""
        from .store.filter import _parse_datetime

        if isinstance(body, str) and body:
            key, direction, start = body, "asc", None
        elif isinstance(body, dict) and body.get("key"):
            key = str(body["key"])
            direction = str(body.get("direction") or "asc")
            start = body.get("start_from")
        else:
            raise ValueError(
                'order_by operand must be a payload key or {"key": K, '
                '"direction": "asc"|"desc"?, "start_from": v?}, got '
                f"{body!r}")
        if direction not in ("asc", "desc"):
            raise ValueError(
                f"direction must be asc|desc, got {direction!r}")
        cols = self._payload_columns()
        view = cols.view(key)
        vals_all = view.num
        if len(view.uniq):          # datetime strings order too
            dt_rows, _ = cols.datetime_num(key)
            vals_all = np.where(np.isnan(vals_all), dt_rows, vals_all)
        keep = ~np.isnan(vals_all)
        if mask is not None:
            keep &= np.asarray(mask, bool)[:len(vals_all)]
        ids = np.nonzero(keep)[0]
        vals = vals_all[ids]
        sign = 1.0 if direction == "asc" else -1.0
        if start is not None:
            s0 = (float(start) if isinstance(start, (int, float))
                  and not isinstance(start, bool)
                  else _parse_datetime(start, what="start_from"))
            ok = sign * vals >= sign * s0
            ids, vals = ids[ok], vals[ok]
        order = np.lexsort((ids, sign * vals))[:k]
        return [(float(vals[j]), int(ids[j])) for j in order]

    def query(self, query=None, *, prefetch=None,
              fusion: Optional[str] = None, k: Optional[int] = None,
              filter=None, with_payload: bool = True, seed=None,
              use_batcher: bool = False, using: str = "",
              lookup_from=None, _branch_results=None):
        """Universal query API — the role of qdrant's query_points
        with prefetch + fusion / multi-stage rescoring (the modern
        face of the store the reference drove via plain `search`,
        core_system.py:659-664).

        Three shapes:
          * `query` alone — plain top-k search (vector, row id, or
            region_id string). `{"sample": "random"}` instead returns
            k uniformly sampled (filtered) points, score 0.0 — qdrant's
            random-sampling query; `seed` makes the draw reproducible.
            Random branches are legal in prefetch too (e.g. a random
            candidate pool feeding an exact rescore). The remaining
            qdrant query types work here AND as prefetch branches AND
            as the rescoring query: `{"recommend": {"positive": [...],
            "negative": [...]?, "strategy": "average"|"sum_scores"|
            "best_score"?}}`, `{"discover": {"target": op?, "context":
            [pairs]?}}`, `{"context": [pairs]}` (pairs as qdrant
            {"positive","negative"} dicts or (p, n) tuples; example
            point ids never return themselves), and `{"order_by": key
            | {"key", "direction"?, "start_from"?}}` (points in
            payload order, the value as the score).
          * `prefetch=[...]` + `fusion` ("rrf" default, or "dbsf") —
            each branch is a sub-search (`{"query": ..., "filter": ...,
            "limit": n}`, or just the query operand); branch result
            lists fuse by reciprocal rank (RRF, k=60) or by
            distribution-normalized score sum (DBSF: each branch's
            scores min-max scaled inside mean±3σ before summing).
          * `prefetch=[...]` + `query` — multi-stage: the union of
            branch candidates is rescored EXACTLY (fp32 dot, ties to
            the lower row id) against `query`; e.g. a cheap IVF/int8
            prefetch feeding an exact rerank. A `query` of
            `{"formula": <expr>, "defaults": {...}}` instead rescores
            the union with a qdrant score-boosting FORMULA over
            prefetch scores, payload values, filter conditions, geo
            distance and decay functions (grammar: store/formula.py).
            A `query` of `{"nearest": <operand>, "mmr": {"diversity":
            0..1, "candidates_limit": n}}` returns a DIVERSIFIED
            top-k (qdrant 1.15 MMR): greedy max of `(1-diversity)*rel
            - diversity*max_sim_to_selected` over the candidate pool
            (the prefetch union, or a plain scan when standalone),
            results in selection order with relevance scores.

        A top-level `filter` applies inside every branch scan (so
        branches return their full limit of valid candidates), exactly
        like qdrant's global filter. `use_batcher` routes a plain
        unfiltered query through the serving micro-batcher (same knob
        as search_similar/recommend): concurrent callers coalesce into
        one launch at the batcher's (bucket, k_pad) shapes.

        `using` selects the vector space of the top-level query (and
        of point-id resolution); each prefetch branch may carry its
        OWN `"using"` — qdrant's hybrid-search shape, e.g. a text-space
        branch and an image-space branch fused by RRF, or a named-space
        prefetch rescored exactly in the default space. Returns a list
        of {"id", "score", "payload"} dicts, best first.

        `with_payload` also accepts qdrant's selector forms — a key
        string/list (include shorthand) or {"include"|"exclude":
        [payload paths]} — applied per hit (see
        store.filter.compile_payload_selector); same on query_batch,
        scroll, and retrieve."""

        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        if prefetch is not None:
            prefetch = list(prefetch) or None  # empty = plain search
        k = self.config.search.top_k if k is None else int(k)
        store.refresh()
        gmask = self._filter_mask(filter) if filter is not None else None

        if lookup_from is not None:
            # qdrant lookup_from: point-id operands (top-level query,
            # mmr "nearest", prefetch branch queries) resolve against
            # ANOTHER collection's vectors. Resolved up front so the
            # lookup store closes before any scan runs.
            lstore, lspace = self._lookup_store(lookup_from)
            try:
                rid_rows: dict = {}

                def _rid_map() -> dict:
                    # region_id -> row of the LOOKUP collection, built
                    # once per call (string ids must not fall through
                    # to the local collection — they name the lookup
                    # one, like every other id under lookup_from)
                    if not rid_rows:
                        pays = lstore.payloads(list(range(lstore.count)))
                        for r, p in enumerate(pays):
                            rid = (p or {}).get("region_id")
                            if isinstance(rid, str) \
                                    and rid not in rid_rows:
                                rid_rows[rid] = r
                    return rid_rows

                def _lk_row(row: int) -> np.ndarray:
                    # same deleted-vector guard as the local-collection
                    # path (_resolve_query_vector): a point whose
                    # lspace vector was removed via delete_vectors must
                    # not silently operand with stale on-disk bytes
                    if lspace in lstore.spaces() \
                            and row in lstore.deleted_rows(lspace):
                        raise StoreError(
                            f"lookup point {row} has no vector in "
                            f"space {lspace!r} (deleted via "
                            f"delete_vectors)")
                    return np.asarray(lstore.vectors(lspace)[row],
                                      np.float32)

                def _lk(op):
                    if isinstance(op, (int, np.integer)):
                        i = int(op)
                        if not 0 <= i < lstore.count:
                            raise StoreError(
                                f"lookup point id {i} out of range "
                                f"[0, {lstore.count})")
                        return _lk_row(i)
                    if isinstance(op, str):
                        row = _rid_map().get(op)
                        if row is None:
                            raise StoreError(
                                f"no point with region_id {op!r} in "
                                f"the lookup collection")
                        return _lk_row(row)
                    return op
                def _lk_list(x):
                    return ([_lk(e) for e in x]
                            if isinstance(x, (list, tuple)) else _lk(x))

                def _lk_q(qq):
                    # resolve point-id operands INSIDE the qdrant query
                    # wrappers too (recommend examples, discover
                    # target/pairs, context pairs) — all against the
                    # lookup collection, so no local self-exclusion
                    if not isinstance(qq, dict):
                        return _lk(qq)
                    if "nearest" in qq:
                        return {**qq, "nearest": _lk(qq["nearest"])}
                    if set(qq) == {"recommend"} and isinstance(
                            qq["recommend"], dict):
                        body = dict(qq["recommend"])
                        for side in ("positive", "negative"):
                            if body.get(side) is not None:
                                body[side] = _lk_list(body[side])
                        return {"recommend": body}
                    if set(qq) == {"discover"} and isinstance(
                            qq["discover"], dict):
                        body = dict(qq["discover"])
                        if body.get("target") is not None:
                            body["target"] = _lk(body["target"])
                        if body.get("context"):
                            body["context"] = [
                                (_lk(p), _lk(n)) for p, n in
                                self._norm_pairs(body["context"])]
                        return {"discover": body}
                    if set(qq) == {"context"}:
                        return {"context": [
                            (_lk(p), _lk(n)) for p, n in
                            self._norm_pairs(qq["context"])]}
                    return qq       # sample / formula / order_by
                query = _lk_q(query)
                if prefetch is not None:
                    prefetch = [
                        {**spec, "query": _lk_q(spec["query"])}
                        if isinstance(spec, dict) and "query" in spec
                        else _lk_q(spec)
                        for spec in prefetch]
            finally:
                lstore.close()

        formula = None
        if isinstance(query, dict) and "formula" in query:
            # qdrant formula query (score boosting): validate the
            # expression BEFORE any scan so malformed specs fail fast
            from .store.formula import parse_formula
            if "mmr" in query:
                raise ValueError("pass either a formula or an mmr "
                                 "query, not both")
            formula = parse_formula(query["formula"])
            if prefetch is None:
                raise ValueError("formula queries rescore prefetch "
                                 "candidates — provide prefetch "
                                 "branches (qdrant requires this too)")
        is_mmr = isinstance(query, dict) and "mmr" in query
        # qdrant's NearestQuery wrapper: {"nearest": op} alone is the
        # plain top-k shape (with "mmr" beside it the wrapper stays —
        # _mmr_select reads both keys)
        query = _unwrap_nearest(query) if not is_mmr else query

        def hits_out(pairs):
            ids = [pid for _, pid in pairs]
            payloads = self._payloads_with(store, ids, with_payload)
            return [{"id": pid, "score": float(sc), "payload": p}
                    for (sc, pid), p in zip(pairs, payloads)]

        def is_random(q) -> bool:
            return isinstance(q, dict) and q.get("sample") == "random"

        # one stream per query() call: with a fixed seed, two random
        # branches draw DIFFERENT (but reproducible) samples
        rng = np.random.default_rng(seed)

        def random_rows(n: int, bmask, space: str = "") -> list[int]:
            bmask = self._presence_and(bmask, space)
            return [int(r)
                    for r in _sample_rows(rng, n, store.count, bmask)]

        if prefetch is None:
            if query is None:
                raise ValueError("query() needs a query operand and/or "
                                 "prefetch branches")
            if is_random(query):
                return hits_out([(0.0, r)
                                 for r in random_rows(k, gmask, using)])
            if self._is_combine(query):
                # qdrant's example-combine query types ride the same
                # masked scans as Reverso.recommend/discover
                return hits_out(self._combine_pairs(query, k, gmask,
                                                    using))
            if self._is_order_by(query):
                return hits_out(self._order_by_pairs(query["order_by"],
                                                     k, gmask))
            if is_mmr:
                # qdrant mmr query: diversified top-k over the
                # candidate scan (selection order, relevance scores)
                return hits_out(self._mmr_select(query, k, gmask, using))
            if using and using in store.sparse:
                sq = self._resolve_sparse_query(query, using)
                s1, i1 = self._get_sparse_index(using).search(
                    sq, k, row_mask=gmask)
                return hits_out([(float(sv), int(iv))
                                 for sv, iv in zip(s1, i1) if iv >= 0])
            qv = self._resolve_query_vector(query, using)
            if gmask is None and use_batcher and k <= 128 \
                    and using not in store.multi:
                # coalesce with in-flight searches at the batcher's
                # (bucket, k_pad) shapes; k > 128 exceeds the batcher's
                # k cap — direct index search instead
                # (multivector queries are [Tq, d] and score through
                # their own MaxSim launch)
                s1, i1 = self.searcher.search(qv, k, space=using)
                return hits_out([(float(sv), int(iv))
                                 for sv, iv in zip(s1, i1) if iv >= 0])
            s, i = _fetch(
                self._get_index(using).search(qv[None], k,
                                              row_mask=gmask))
            return hits_out([(float(sv), int(iv))
                             for sv, iv in zip(s[0], i[0]) if iv >= 0])
        if query is not None and fusion is not None:
            raise ValueError("pass either a rescoring query or fusion, "
                             "not both")
        if is_random(query):
            raise ValueError("random sampling cannot rescore prefetch "
                             "branches (use it standalone or as a "
                             "branch)")

        branches = []
        for bi, spec in enumerate(prefetch):
            if (_branch_results is not None
                    and bi < len(_branch_results)
                    and _branch_results[bi] is not None):
                # query_batch precomputed this plain dense branch in a
                # coalesced cross-request launch (same space/filter/
                # limit requests share one device scan) — the pairs
                # are exactly what the scan below would produce
                branches.append(_branch_results[bi])
                continue
            if isinstance(spec, dict) and (
                    "query" in spec or "filter" in spec or "limit" in spec
                    or "using" in spec):
                bq = spec.get("query")
                bf = spec.get("filter")
                bl = int(spec.get("limit", max(2 * k, 20)))
                bu = str(spec.get("using") or "")
            else:
                bq, bf, bl, bu = spec, None, max(2 * k, 20), ""
            if bq is None:
                raise ValueError("every prefetch branch needs a query")
            if not (isinstance(bq, dict) and "mmr" in bq):
                bq = _unwrap_nearest(bq)
            bmask = self._filter_mask(bf) if bf is not None else None
            if gmask is not None:
                bmask = gmask if bmask is None else (bmask & gmask)
            if is_random(bq):
                rows = random_rows(bl, bmask, bu)
                branches.append((rows, [0.0] * len(rows)))
                continue
            if self._is_combine(bq):
                prs = self._combine_pairs(bq, bl, bmask, bu)
                branches.append(([p for _, p in prs],
                                 [s for s, _ in prs]))
                continue
            if self._is_order_by(bq):
                # a payload-ordered candidate pool (e.g. newest-first
                # feeding an exact rescore)
                prs = self._order_by_pairs(bq["order_by"], bl, bmask)
                branches.append(([p for _, p in prs],
                                 [s for s, _ in prs]))
                continue
            if bu and bu in store.sparse:
                # hybrid search: a sparse branch beside dense ones,
                # fused by RRF/DBSF or rescored exactly downstream
                sq = self._resolve_sparse_query(bq, bu)
                s1, i1 = self._get_sparse_index(bu).search(
                    sq, bl, row_mask=bmask)
                valid = i1 >= 0
                branches.append(([int(x) for x in i1[valid]],
                                 [float(x) for x in s1[valid]]))
                continue
            qv = self._resolve_query_vector(bq, bu)
            s, i = _fetch(
                self._get_index(bu).search(qv[None], bl, row_mask=bmask))
            valid = i[0] >= 0
            branches.append(([int(x) for x in i[0][valid]],
                             [float(x) for x in s[0][valid]]))

        if query is None:
            fusion = fusion or "rrf"
            fused: dict[int, float] = {}
            if fusion == "rrf":
                for ids, _ in branches:
                    for r, pid in enumerate(ids):
                        fused[pid] = fused.get(pid, 0.0) + 1.0 / (60.0 + r + 1)
            elif fusion == "dbsf":
                for ids, scores in branches:
                    if not ids:
                        continue
                    a = np.asarray(scores, np.float64)
                    lo = a.mean() - 3.0 * a.std()
                    hi = a.mean() + 3.0 * a.std()
                    norm = ((a - lo) / (hi - lo) if hi > lo
                            else np.ones_like(a))
                    for pid, ns in zip(ids, norm):
                        fused[pid] = fused.get(pid, 0.0) + float(ns)
            else:
                raise ValueError(f"unknown fusion {fusion!r} "
                                 f"(expected rrf|dbsf)")
            top = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
            return hits_out([(sc, pid) for pid, sc in top])

        # multi-stage: exact rescore of the candidate union, in the
        # top-level query's vector space
        cand = sorted({pid for ids, _ in branches for pid in ids})
        if not cand:
            return []
        if self._is_combine(query) or self._is_order_by(query):
            # rescore the union under a combine objective / payload
            # order: the union IS the scan mask, so the same masked
            # scans serve this stage too
            cmask = np.zeros(store.count, bool)
            cmask[cand] = True
            if self._is_order_by(query):
                return hits_out(self._order_by_pairs(query["order_by"],
                                                     k, cmask))
            return hits_out(self._combine_pairs(query, k, cmask, using))
        if is_mmr:
            # diversified rerank of the prefetch union: relevance is
            # the exact rescore against the mmr "nearest" operand
            return hits_out(self._mmr_select(query, k, gmask, using,
                                             cand=cand))
        if formula is not None:
            # formula rescore (qdrant score boosting): host-side
            # expression over prefetch scores / payload values /
            # conditions — see store/formula.py for the grammar
            from .store.formula import FormulaContext, eval_formula
            ctx = FormulaContext(
                cand,
                [dict(zip(ids, scores)) for ids, scores in branches],
                payloads_of=store.payloads,
                condition_mask=self._filter_mask,
                defaults=query.get("defaults"))
            scores = eval_formula(formula, ctx)
            order = np.lexsort((np.asarray(cand), -scores))[:k]
            return hits_out([(float(scores[j]), int(cand[j]))
                             for j in order])
        if using and using in store.sparse:
            # sparse rescore: candidates with no overlapping term drop
            # (sparse semantics — no shared dimension means no score)
            sq = self._resolve_sparse_query(query, using)
            cmask = np.zeros(store.count, bool)
            cmask[cand] = True
            s1, i1 = self._get_sparse_index(using).search(
                sq, k, row_mask=cmask)
            return hits_out([(float(sv), int(iv))
                             for sv, iv in zip(s1, i1) if iv >= 0])
        qv = self._resolve_query_vector(query, using)
        if using and using in store.multi:
            # MaxSim rescore of the candidates (points with no
            # sub-vectors drop — they have no similarity)
            from .ops.multivec import maxsim_score_rows
            scores = maxsim_score_rows(
                store.multivector_rows(using, cand), qv)
            order = np.lexsort((np.asarray(cand), -scores))[:k]
            return hits_out([(float(scores[j]), int(cand[j]))
                             for j in order if np.isfinite(scores[j])])
        # cross-space prefetch union: a candidate whose vector was
        # deleted in THIS space has no score here (qdrant skips it) —
        # drop it before reading the stale on-disk bytes
        cand = self._drop_deleted(cand, using)
        if not cand:
            return []
        vecs = np.asarray(store.vectors(using)[cand], np.float32)
        scores = self._exact_scores(vecs, qv)
        order = np.lexsort((np.asarray(cand), -scores))[:k]
        return hits_out([(float(scores[j]), int(cand[j])) for j in order])

    def query_groups(self, query=None, *, group_by: str,
                     prefetch=None, fusion: Optional[str] = None,
                     group_size: int = 3, limit: Optional[int] = None,
                     filter=None, with_payload=True, seed=None,
                     using: str = "", lookup_from=None,
                     with_lookup=None):
        """Grouped universal query — qdrant's query_points_groups:
        any query() shape (plain/nearest, prefetch + RRF/DBSF fusion,
        exact/formula/MMR rescore, random sampling, named/sparse
        spaces, lookup_from) bucketed by a payload field, each bucket
        reporting its top `group_size` hits. Replaces the reference's
        one-image-floods-the-page search results
        (core_system.py:659-664) at the universal-query surface the
        way search_groups does for the plain engine search.

        Groups are ranked by their best hit (first appearance in the
        underlying result order — for MMR that is selection order);
        hits within a group keep result order. Rows without the
        `group_by` key are skipped (qdrant semantics); list/dict keys
        group by their canonical JSON (the search_groups convention).
        The scan deepens (doubling the internal limit, scaling
        explicit prefetch branch limits with it) until every selected
        group is full or the candidate pool is exhausted — exact for
        plain queries; for prefetch shapes the pool is the fused/
        rescored union, so deepening is best-effort exactly as in
        qdrant. Returns a list of {"key", "hits"} dicts, best group
        first; `with_lookup` joins each group key against a point of
        another collection (see search_groups)."""
        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        if not group_by or not isinstance(group_by, str):
            raise ValueError("query_groups needs a group_by payload "
                             "key (qdrant requires one too)")
        limit = self.config.search.top_k if limit is None else int(limit)
        group_size = max(1, int(group_size))
        store.refresh()
        cols = self._payload_columns()
        key_col = cols.column(group_by)
        has_key = cols.present(group_by)

        def scaled(factor: int):
            # deepen explicit branch limits alongside the top-level k
            # (implicit limits already scale: query() defaults them
            # from k); non-dict branches keep their implicit limit
            if prefetch is None or factor == 1:
                return prefetch
            out = []
            for spec in prefetch:
                if isinstance(spec, dict) and "limit" in spec:
                    spec = {**spec,
                            "limit": int(spec["limit"]) * factor}
                out.append(spec)
            return out

        k0 = min(store.count, max(limit * group_size, 32))
        k = k0
        while True:
            hits = self.query(query, prefetch=scaled(max(1, k // k0)),
                              fusion=fusion, k=k, filter=filter,
                              with_payload=False, seed=seed,
                              using=using, lookup_from=lookup_from)
            sel: dict = {}
            complete = False
            for h in hits:
                i = h["id"]
                if not has_key[i]:
                    continue
                kv = key_col[i]
                if not isinstance(kv, (str, int, float, bool)):
                    kv = json.dumps(kv, sort_keys=True)
                got = sel.get(kv)
                if got is None:
                    if len(sel) >= limit:
                        continue
                    sel[kv] = [h]
                elif len(got) < group_size:
                    got.append(h)
                if (len(sel) == limit
                        and all(len(v) >= group_size
                                for v in sel.values())):
                    complete = True
                    break
            if complete or len(hits) < k or k >= store.count:
                break
            k = min(store.count, k * 2)

        ids = [h["id"] for hits in sel.values() for h in hits]
        pays = dict(zip(ids, self._payloads_with(store, ids,
                                                 with_payload)))
        groups = []
        for kv, hits in sel.items():
            for h in hits:
                h["payload"] = pays.get(h["id"])
            groups.append({"key": kv, "hits": hits})
        if with_lookup is not None:
            self._attach_group_lookups(groups, with_lookup)
        return groups

    def _plan_hybrid_branches(self, r: dict):
        """query_batch coalescing plan for one universal request with
        prefetch branches: per branch either ((space, limit,
        branch-filter-key, global-filter-key), qv, branch-filter) when
        the branch is a PLAIN dense vector scan — the shape that
        dominates hybrid/multi-stage load — or None (random/combine/
        order_by/sparse/multivector branches run inside query() as
        usual). Returns None when the request can't participate at all
        (no prefetch, lookup_from rewrites branch operands, or a
        branch operand fails to resolve — the sequential path then
        raises the real error). Mirrors query()'s branch-spec parsing
        exactly; tests pin batched == sequential."""
        store = self._store
        if r.get("lookup_from") is not None:
            return None
        prefetch = r.get("prefetch")
        if not prefetch or not isinstance(prefetch, (list, tuple)):
            return None
        k = (self.config.search.top_k if r.get("k") is None
             else int(r["k"]))
        gkey = _exact_key(r.get("filter"))
        if gkey is None:
            return None
        out: list = []
        any_eligible = False
        for spec in prefetch:
            if isinstance(spec, dict) and (
                    "query" in spec or "filter" in spec
                    or "limit" in spec or "using" in spec):
                bq = spec.get("query")
                bf = spec.get("filter")
                bl = int(spec.get("limit", max(2 * k, 20)))
                bu = str(spec.get("using") or "")
            else:
                bq, bf, bl, bu = spec, None, max(2 * k, 20), ""
            bq = _unwrap_nearest(bq)
            if (bq is None or isinstance(bq, dict)
                    or bu in store.sparse or bu in store.multi):
                out.append(None)
                continue
            try:
                qv = self._resolve_query_vector(bq, bu)
            except Exception:
                return None
            if qv.ndim != 1:
                out.append(None)
                continue
            bkey = _exact_key(bf)
            if bkey is None:
                out.append(None)
                continue
            out.append(((bu, bl, bkey, gkey), qv, bf))
            any_eligible = True
        return out if any_eligible else None

    def query_batch(self, requests, *, with_payload: bool = True):
        """Run several universal queries in ONE call — qdrant's
        query_batch_points role: plain vector requests sharing a space
        and a filter coalesce into one batched kernel launch (the
        per-query cost of the streaming scan is tiny next to the
        database read, so B plain queries cost about one); requests
        with prefetch/fusion/random sampling fall back to query() per
        request. Each request is a dict of query() kwargs; returns a
        list of result lists in request order."""
        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        store.refresh()
        reqs = [dict(r) for r in requests]
        allowed = {"query", "prefetch", "fusion", "k", "filter",
                   "with_payload", "seed", "using", "lookup_from"}
        for r in reqs:
            bad = set(r) - allowed
            if bad:
                raise ValueError(f"unknown request keys {sorted(bad)} "
                                 f"(allowed: {sorted(allowed)})")
        results: list = [None] * len(reqs)
        groups: dict[tuple, list[int]] = {}
        hybrid: list[tuple] = []     # (request idx, branch plan)
        for n, r in enumerate(reqs):
            q = r.get("query")
            if isinstance(q, dict) and set(q) == {"nearest"}:
                q = r["query"] = q["nearest"]   # qdrant NearestQuery
            plain = (not r.get("prefetch") and r.get("fusion") is None
                     and q is not None
                     and not (isinstance(q, dict)
                              and ("sample" in q or "formula" in q
                                   or "mmr" in q or "order_by" in q
                                   or set(q) & {"recommend", "discover",
                                                "context"}))
                     # lookup_from ids resolve in another collection —
                     # the per-request query() path handles the open
                     and r.get("lookup_from") is None
                     # sparse spaces score host-side per request (no
                     # device launch to coalesce); multivector queries
                     # are ragged [Tq, d] operands with their own
                     # MaxSim launch — both fall back to query()
                     and str(r.get("using") or "") not in store.sparse
                     and str(r.get("using") or "") not in store.multi)
            if not plain:
                # carry the batch-level payload default into the
                # fallback call (per-request with_payload still wins)
                r.setdefault("with_payload", with_payload)
                # hybrid/universal requests with plain dense prefetch
                # branches coalesce those branch scans across the
                # batch; everything else runs per request
                plan = (self._plan_hybrid_branches(r)
                        if r.get("prefetch") else None)
                if plan is None:
                    results[n] = self.query(**r)
                else:
                    hybrid.append((n, plan))
                continue
            fkey = _exact_key(r.get("filter"))
            if fkey is None:
                # no exact key: the request runs alone
                r.setdefault("with_payload", with_payload)
                results[n] = self.query(**r)
                continue
            # same-space requests coalesce; spaces differ in dim/index
            groups.setdefault((str(r.get("using") or ""), fkey),
                              []).append(n)
        for (space, _), idxs in groups.items():
            vecs = np.stack(
                [self._resolve_query_vector(reqs[n]["query"], space)
                 for n in idxs])
            fspec = reqs[idxs[0]].get("filter")
            mask = self._filter_mask(fspec) if fspec is not None else None
            ks = [self.config.search.top_k if reqs[n].get("k") is None
                  else int(reqs[n]["k"]) for n in idxs]
            s, i = _fetch(
                self._get_index(space).search(vecs, max(ks),
                                              row_mask=mask))
            for row, (n, kk) in enumerate(zip(idxs, ks)):
                pairs = [(float(sv), int(iv))
                         for sv, iv in zip(s[row][:kk], i[row][:kk])
                         if iv >= 0]
                ids = [pid for _, pid in pairs]
                wp = reqs[n].get("with_payload", with_payload)
                payloads = self._payloads_with(store, ids, wp)
                results[n] = [{"id": pid, "score": sc, "payload": p}
                              for (sc, pid), p in zip(pairs, payloads)]

        if hybrid:
            # one stacked launch per (space, limit, branch-filter,
            # global-filter) across ALL hybrid requests: R two-branch
            # hybrid queries cost ~2 device scans instead of 2R
            scan_groups: dict[tuple, list[tuple]] = {}
            for hi, (n, plan) in enumerate(hybrid):
                for bi, ent in enumerate(plan):
                    if ent is not None:
                        scan_groups.setdefault(ent[0], []).append(
                            (hi, bi, ent[1]))
            branch_res = [[None] * len(plan) for _, plan in hybrid]
            for key, members in scan_groups.items():
                bu, bl, _, _ = key
                hi0, bi0, _ = members[0]
                n0, plan0 = hybrid[hi0]
                bf = plan0[bi0][2]
                gf = reqs[n0].get("filter")
                bmask = (self._filter_mask(bf) if bf is not None
                         else None)
                if gf is not None:
                    gm = self._filter_mask(gf)
                    bmask = gm if bmask is None else (bmask & gm)
                vecs = np.stack([qv for _, _, qv in members])
                s, i = _fetch(
                    self._get_index(bu).search(vecs, bl,
                                               row_mask=bmask))
                for row, (hi, bi, _) in enumerate(members):
                    valid = i[row] >= 0
                    branch_res[hi][bi] = (
                        [int(x) for x in i[row][valid]],
                        [float(x) for x in s[row][valid]])
            for hi, (n, _) in enumerate(hybrid):
                results[n] = self.query(**reqs[n],
                                        _branch_results=branch_res[hi])
        return results

    def scroll(self, filter=None, *, offset=0, limit: int = 100,
               with_payload: bool = True, order_by: Optional[str] = None,
               direction: str = "asc", with_vectors: bool = False,
               using: str = ""):
        """Page through stored points (ids + payloads), optionally
        filtered — the role of qdrant's scroll API. Returns
        (points, next_offset): `points` is a list of {"id", "payload"}
        dicts (plus "vector" from the `using` space under
        `with_vectors=True`, qdrant's scroll selector); `next_offset`
        is the token to pass as `offset` for the next page, or None
        when exhausted.

        Default order is by row id; `offset` is then a row id, so pages
        stay stable under concurrent appends. With `order_by=<payload
        key>` points come sorted by that key's value — numbers by
        magnitude, RFC 3339 / ISO 8601 strings by timestamp (epoch
        seconds; a key mixing both interleaves on that shared numeric
        axis). Missing / unordered rows are excluded — qdrant's
        order_by is likewise integer/float/datetime only. Ties break
        by row id ascending; `offset` is then the opaque `(value, id)`
        token the previous page returned (pass 0/None to start)."""
        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        limit = max(0, int(limit))
        mask = self._filter_mask(filter) if filter is not None else None
        store.refresh()
        if order_by is not None:
            if direction not in ("asc", "desc"):
                raise ValueError(f"direction must be asc|desc, got "
                                 f"{direction!r}")
            cols = self._payload_columns()
            view = cols.view(str(order_by))
            vals_all = view.num
            if len(view.uniq):        # datetime strings order too
                dt_rows, _ = cols.datetime_num(str(order_by))
                vals_all = np.where(np.isnan(vals_all), dt_rows,
                                    vals_all)
            keep = ~np.isnan(vals_all)
            if mask is not None:
                keep &= mask[:len(vals_all)]
            ids = np.nonzero(keep)[0]
            vals = vals_all[ids]
            sign = 1.0 if direction == "asc" else -1.0
            order = np.lexsort((ids, sign * vals))
            ids, vals = ids[order], vals[order]
            if offset not in (None, 0):
                try:
                    o_val, o_id = offset
                    o_val, o_id = float(o_val), int(o_id)
                except (TypeError, ValueError):
                    raise ValueError(
                        "with order_by, offset is the (value, id) "
                        f"token the previous page returned, got "
                        f"{offset!r}")
                after = (sign * vals > sign * o_val) | (
                    (vals == o_val) & (ids >= o_id))
                ids, vals = ids[after], vals[after]
            next_offset = ((float(vals[limit]), int(ids[limit]))
                           if len(ids) > limit else None)
            ids = ids[:limit + 1]
        elif mask is None:
            ids = np.arange(max(0, int(offset)),
                            min(store.count, max(0, int(offset)) + limit + 1))
            next_offset = int(ids[limit]) if len(ids) > limit else None
        else:
            ids = np.nonzero(mask)[0]
            ids = ids[ids >= int(offset)][:limit + 1]
            next_offset = int(ids[limit]) if len(ids) > limit else None
        page = [int(i) for i in ids[:limit]]
        payloads = self._payloads_with(store, page, with_payload)
        points = [{"id": i, "payload": p} for i, p in zip(page, payloads)]
        if with_vectors and page:
            vecs = np.asarray(store.vectors(using)[page], np.float32)
            gone = set(store.deleted_rows(using).tolist())
            for pt, v in zip(points, vecs):
                if pt["id"] not in gone:   # delete_vectors: absent
                    pt["vector"] = v.tolist()
        return points, next_offset

    def retrieve(self, ids, *, with_payload: bool = True,
                 with_vectors: bool = False, using: str = ""):
        """Fetch specific points — qdrant's retrieve API role. `ids`
        mixes integer row ids and `region_id` payload strings (the
        reference's per-point UUIDs, core_system.py:608-609). Unknown
        ids are silently skipped (qdrant semantics). Returns a list of
        {"id", "payload"[, "vector"]} dicts in request order;
        `with_vectors` reads the `using` vector space ('' = default)."""
        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        store.refresh()
        rows: list[int] = []
        str_ids = [i for i in ids if isinstance(i, str)]
        by_region: dict[str, int] = {}
        if str_ids:
            cols = self._payload_columns()
            view = cols.view("region_id")
            col = cols.column("region_id")
            want = [c for c in (view.uindex.get(s, -2) for s in str_ids)
                    if c >= 0]
            hits = np.nonzero(np.isin(view.codes, want))[0]
            # keep-first on duplicate region_ids (store is append-only)
            for r in hits.tolist():
                by_region.setdefault(col[r], r)
        for i in ids:
            if isinstance(i, str):
                r = by_region.get(i)
                if r is not None:
                    rows.append(r)
            elif 0 <= int(i) < store.count:
                rows.append(int(i))
        payloads = self._payloads_with(store, rows, with_payload)
        points = [{"id": r, "payload": p} for r, p in zip(rows, payloads)]
        if with_vectors and rows:
            if using and using in store.sparse:
                for pt, sv in zip(points, store.sparse_rows(using, rows)):
                    pt["vector"] = sv
            elif using and using in store.multi:
                for pt, mv in zip(points,
                                  store.multivector_rows(using, rows)):
                    pt["vector"] = mv
            else:
                vecs = np.asarray(store.vectors(using)[rows], np.float32)
                gone = set(store.deleted_rows(using).tolist())
                for pt, v in zip(points, vecs):
                    if pt["id"] not in gone:   # delete_vectors: absent
                        pt["vector"] = v
        return points

    def facet(self, key: str, filter=None, *, limit: int = 10):
        """Value histogram of one payload key over (optionally
        filtered) points — qdrant's facet API role. Returns a list of
        {"value", "count"} dicts, count-descending (ties by value).
        Only hashable scalar values (str/int/float/bool) are counted;
        rows missing the key or holding lists/objects are skipped."""
        from collections import Counter

        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        store.refresh()
        cols = self._payload_columns()
        col = cols.column(str(key))
        keep = cols.present(str(key))
        mask = self._filter_mask(filter) if filter is not None else None
        if mask is not None:
            keep = keep & mask[:len(col)]
        counts = Counter(
            v for v in col[keep].tolist()
            if isinstance(v, (str, int, float, bool)))
        top = sorted(counts.items(), key=lambda kv: (-kv[1], str(kv[0])))
        return [{"value": v, "count": int(n)}
                for v, n in top[:max(0, int(limit))]]

    def search_matrix(self, *, sample: int = 10, limit: int = 3,
                      filter=None, seed=None, offsets: bool = False,
                      using: str = ""):
        """Pairwise similarity matrix over a random sample of stored
        points — qdrant's search_matrix_pairs / search_matrix_offsets
        role (the clustering/dedup view of the store the reference
        drove via plain search, core_system.py:659-664).

        Samples up to `sample` points (without replacement, uniformly
        over the rows matching `filter`; `seed` makes the draw
        reproducible) and scores every sampled point against every
        other in ONE [S, S] fp32 product. Each point reports its
        `limit` most-similar OTHER sampled points, (-score, idx) ties.

        Returns pairs format (default): a list of {"id_a", "id_b",
        "score"} dicts grouped by id_a ascending, best-first within a
        group — or, with offsets=True, qdrant's offsets format:
        {"ids", "offsets_row", "offsets_col", "scores"} where row/col
        are positions in the sorted `ids` list. The sample axis is
        padded to a power-of-two bucket (the JAX package's shapes)."""

        from .ops.recommend import matrix_topk

        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        if store.distance in ("euclid", "manhattan"):
            raise StoreError("search_matrix scores by dot product — "
                             f"not supported on a {store.distance}-"
                             "distance store")
        sample, limit = int(sample), int(limit)
        if sample < 2:
            raise ValueError("sample must be >= 2 (a pair needs two points)")
        if sample > 8192:
            raise ValueError("sample is capped at 8192 (the [S, S] score "
                             "block is materialized)")
        if limit < 1:
            raise ValueError("limit must be >= 1")
        store.refresh()
        mask = self._filter_mask(filter) if filter is not None else None
        mask = self._presence_and(mask, using)   # delete_vectors rows out
        pop = int(np.count_nonzero(mask)) if mask is not None \
            else store.count
        empty = ({"ids": [], "offsets_row": [], "offsets_col": [],
                  "scores": []} if offsets else [])
        if pop < 2:
            return empty
        rng = np.random.default_rng(seed)
        ids = np.sort(_sample_rows(rng, sample, store.count, mask))
        vecs = np.asarray(store.vectors(using)[ids], np.float32)
        s_pad = max(8, 1 << (len(ids) - 1).bit_length())
        if s_pad > len(ids):
            vecs = np.concatenate(
                [vecs, np.zeros((s_pad - len(ids), vecs.shape[1]),
                                np.float32)])
        lim = min(limit, len(ids) - 1)
        scores, cols = _fetch(
            matrix_topk(torch.from_numpy(vecs).to(self.device), lim,
                        n_valid=len(ids)))
        scores, cols = scores[:len(ids)], cols[:len(ids)]
        if offsets:
            out = {"ids": [int(i) for i in ids], "offsets_row": [],
                   "offsets_col": [], "scores": []}
            for r in range(len(ids)):
                for sc, c in zip(scores[r], cols[r]):
                    if c >= 0:
                        out["offsets_row"].append(r)
                        out["offsets_col"].append(int(c))
                        out["scores"].append(float(sc))
            return out
        return [{"id_a": int(ids[r]), "id_b": int(ids[c]),
                 "score": float(sc)}
                for r in range(len(ids))
                for sc, c in zip(scores[r], cols[r]) if c >= 0]

