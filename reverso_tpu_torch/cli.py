"""Command-line interface of the PyTorch port: `reverso-torch`, or
`python -m reverso_tpu_torch.cli`.

The reference is launched only through its Gradio UI (`python main.py`,
reference main.py:23-40); this CLI exposes the same capabilities headless
(build / search / list / delete / unlock / serve) for scripted and
production use. It takes every subcommand and option of the JAX
package's `reverso` command, plus `--device` (default `cuda`; `--device
cpu` runs on the CPU). Asking for CUDA where there is none raises: no
path falls back to the CPU. `train` fine-tunes the vision tower on a mesh
of data x `--tp` model shards; `bench` is not ported yet and exits
non-zero, naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from .config import EngineConfig, MODEL_PRESETS, default_config


def _device(args):
    """The torch device `--device` names; CUDA where there is none raises,
    naming the option that runs on the CPU."""
    from .models.pe import resolve_device
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e}; on the command line: --device cpu") from None


def _make_config(args):
    """EngineConfig from CLI flags (shared by engine-building commands
    and `tune`, which needs no encoder)."""
    cfg = default_config()
    if args.model:
        cfg = dataclasses.replace(cfg, model=MODEL_PRESETS[args.model])
    if args.db_root:
        cfg = dataclasses.replace(
            cfg, store=dataclasses.replace(cfg.store, root_dir=args.db_root))
    if getattr(args, "detector_dtype", None):
        cfg = dataclasses.replace(
            cfg, detector=dataclasses.replace(cfg.detector,
                                              dtype=args.detector_dtype))
    if getattr(args, "embed_quant", None):
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           quant=args.embed_quant))
    if getattr(args, "index_dtype", None):
        cfg = dataclasses.replace(
            cfg, store=dataclasses.replace(cfg.store,
                                           dtype=args.index_dtype))
    scfg = cfg.search
    if getattr(args, "index", None):
        scfg = dataclasses.replace(scfg, index=args.index)
    if getattr(args, "ivf_nprobe", None) is not None:
        scfg = dataclasses.replace(scfg, ivf_nprobe=args.ivf_nprobe)
    if getattr(args, "ivf_spill", None) is not None:
        scfg = dataclasses.replace(scfg, ivf_spill=args.ivf_spill)
    if getattr(args, "ivf_balance", None) is not None:
        scfg = dataclasses.replace(scfg, ivf_balance=args.ivf_balance)
    if getattr(args, "ivf_impl", None):
        scfg = dataclasses.replace(scfg, ivf_impl=args.ivf_impl)
    if getattr(args, "binary_oversampling", None) is not None:
        scfg = dataclasses.replace(
            scfg, binary_oversampling=args.binary_oversampling)
    if getattr(args, "int8_quantile", None) is not None:
        scfg = dataclasses.replace(scfg, int8_quantile=args.int8_quantile)
    if getattr(args, "pq_m", None) is not None:
        scfg = dataclasses.replace(scfg, pq_m=args.pq_m)
    if getattr(args, "pq_oversampling", None) is not None:
        scfg = dataclasses.replace(
            scfg, pq_oversampling=args.pq_oversampling)
    if scfg is not cfg.search:
        cfg = dataclasses.replace(cfg, search=scfg)
    if getattr(args, "ingest_backend", None):
        cfg = dataclasses.replace(
            cfg, ingest=dataclasses.replace(cfg.ingest,
                                            decode_backend=args.ingest_backend))
    return cfg


def _make_engine(args, *, need_detector: bool = False):
    from .engine import Reverso
    from .models.pe import PerceptionEncoder

    device = _device(args)
    cfg = _make_config(args)
    import os as _os
    pe_ckpt = _os.environ.get("REVERSO_PE_CKPT")
    if pe_ckpt and pe_ckpt.endswith(".msgpack"):
        # converted real weights (scripts/fetch_weights.py); the sidecar
        # meta carries the architecture, overriding the preset
        encoder = PerceptionEncoder.from_checkpoint(pe_ckpt, device=device)
        cfg = dataclasses.replace(cfg, model=encoder.cfg)
    elif pe_ckpt:
        encoder = PerceptionEncoder.from_torch(pe_ckpt, cfg.model,
                                               device=device)
    else:
        # None -> the engine builds it lazily on first embed; store-only
        # commands (recommend by ids, points) never pay the model init
        encoder = None
    text_embedder = None
    tckpt = _os.environ.get("REVERSO_CLIP_TEXT_CKPT")
    tvocab = _os.environ.get("REVERSO_CLIP_VOCAB")
    tmerges = _os.environ.get("REVERSO_CLIP_MERGES")
    if tckpt and tvocab and tmerges:
        from .models.cliptext import TextEmbedder
        text_embedder = TextEmbedder.from_pretrained(tckpt, tvocab, tmerges,
                                                     device=device)
    detector = None
    if need_detector:
        import os
        dino = os.environ.get("REVERSO_DINO_CKPT")
        sam = os.environ.get("REVERSO_SAM_CKPT")
        vocab = os.environ.get("REVERSO_BERT_VOCAB")
        if dino and sam and vocab:
            from .detect import load_grounded_sam
            detector = load_grounded_sam(dino, sam, vocab,
                                         cfg=cfg.detector, device=device)
        else:
            # no checkpoints configured: deterministic stub (CI / smoke).
            # Set REVERSO_DINO_CKPT / REVERSO_SAM_CKPT / REVERSO_BERT_VOCAB
            # to local GroundingDINO + SAM checkpoints for real detection.
            from .detect import StubDetector
            detector = StubDetector(cfg.detector)
    return Reverso(cfg, encoder=encoder, detector=detector,
                   text_embedder=text_embedder, device=device)


def cmd_build(args) -> int:
    from .utils.profiling import trace
    engine = _make_engine(args, need_detector=not args.direct_pe)
    with trace(args.trace_dir):
        transcript = engine.create_database(
            args.folder, args.name, text_prompt=args.prompt,
            use_direct_pe=args.direct_pe,
            resume_from_checkpoint=args.resume,
            include_subfolders=args.subfolders)  # StatusLog echoes to stderr
    print(transcript.splitlines()[-1] if transcript else "")
    return 0 if "ready for searching" in transcript or "complete" in transcript else 1


def cmd_search(args) -> int:
    from .utils.profiling import trace
    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    if len(args.image) > 1:
        if args.group_by:
            print("❌ --group-by works with a single query image",
                  file=sys.stderr)
            return 1
        return _search_bulk(engine, args)
    with trace(args.trace_dir):
        engine.process_image_direct_pe(args.image[0])
        if args.group_by:
            text, groups = engine.search_groups(
                args.threshold, args.top_k, group_by=args.group_by,
                group_size=args.group_size, filter=args.filter or None,
                with_lookup=getattr(args, "with_lookup", None) or None)
            if args.json:
                print(json.dumps([
                    {"key": g["key"],
                     "hits": [{"id": it["id"], "filename": it["filename"],
                               "score": it["score"], "bbox": it["bbox"]}
                              for it in g["hits"]],
                     **({"lookup": g.get("lookup")}
                        if "lookup" in g else {})}
                    for g in groups], indent=2))
            else:
                print(text)
            return 0 if groups else 2
        text, items = engine.search_similar(args.threshold, args.top_k,
                                            filter=args.filter or None)
    if args.json:
        print(json.dumps([
            {"filename": it["filename"], "score": it["score"],
             "bbox": it["bbox"], "source": it["payload"].get("image_source")}
            for it in items], indent=2))
    else:
        print(text)
    return 0 if items else 2


def _search_bulk(engine, args) -> int:
    """Many query images -> ONE batched embed + ONE search launch
    (`Reverso.search_batch`); prints one result block per query."""
    import numpy as np

    px = np.concatenate([engine._preprocess(p)[0] for p in args.image])
    embs = np.asarray(engine.encoder.encode_image(px))
    k = args.top_k or engine.config.search.top_k
    scores, ids = engine.search_batch(embs, k, filter=args.filter or None)
    thr = (engine.config.search.score_threshold
           if args.threshold is None else args.threshold)
    blocks = []
    for qi, path in enumerate(args.image):
        hits = [(float(s), int(i)) for s, i in zip(scores[qi], ids[qi])
                if i >= 0 and s >= thr]
        payloads = engine._store.payloads([i for _, i in hits])
        blocks.append({
            "query": path,
            "results": [{"filename": (p or {}).get("filename", "?"),
                         "score": s,
                         "bbox": (p or {}).get("bbox"),
                         "source": (p or {}).get("image_source")}
                        for (s, _), p in zip(hits, payloads)],
        })
    if args.json:
        print(json.dumps(blocks, indent=2))
    else:
        for b in blocks:
            print(f"🔎 {b['query']}")
            for r, it in enumerate(b["results"]):
                print(f"  {r + 1}. {it['filename']} "
                      f"(Similarity: {it['score']:.3f})")
            if not b["results"]:
                print(f"  ❌ no hits above threshold {thr}")
    return 0 if any(b["results"] for b in blocks) else 2


def cmd_search_text(args) -> int:
    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    text, items = engine.search_by_text(args.text, args.threshold,
                                        args.top_k,
                                        filter=args.filter or None)
    if args.json:
        print(json.dumps([
            {"filename": it["filename"], "score": it["score"],
             "bbox": it["bbox"], "source": it["payload"].get("image_source")}
            for it in items], indent=2))
    else:
        print(text)
    return 0 if items else 2


def _lookup_from_arg(text):
    """--lookup-from COLLECTION[:SPACE] -> qdrant lookup_from dict."""
    if not text:
        return None
    coll, _, space = text.partition(":")
    return {"collection": coll, "vector": space or None}

def cmd_recommend(args) -> int:
    """Search by positive/negative example point ids (qdrant's recommend
    API role). Point ids are the row ids search results report; no
    model load — only the store and the device index."""
    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    text, items = engine.recommend(
        args.positive, args.negative or None, args.top_k, args.threshold,
        strategy=args.strategy, filter=args.filter or None,
        lookup_from=_lookup_from_arg(getattr(args, "lookup_from", None)))
    if args.json:
        print(json.dumps([
            {"id": it["id"], "filename": it["filename"], "score": it["score"],
             "bbox": it["bbox"], "source": it["payload"].get("image_source")}
            for it in items], indent=2))
    else:
        print(text)
    return 0 if items else 2


def cmd_discover(args) -> int:
    """Discovery search: a target point steered by (positive, negative)
    context pairs (qdrant's discovery API role). No model load."""
    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    pairs = []
    for spec in args.pair or []:
        try:
            p, n = spec.split(":", 1)
            pairs.append((int(p), int(n)))
        except ValueError:
            print(f"❌ bad --pair '{spec}' (expected POS_ID:NEG_ID)",
                  file=sys.stderr)
            return 1
    text, items = engine.discover(args.target, pairs or None, args.top_k,
                                  filter=args.filter or None)
    if args.json:
        print(json.dumps([
            {"id": it["id"], "filename": it["filename"], "score": it["score"],
             "bbox": it["bbox"], "source": it["payload"].get("image_source")}
            for it in items], indent=2))
    else:
        print(text)
    return 0 if items else 2


def cmd_query(args) -> int:
    """Universal query (qdrant query_points role): prefetch branches
    fused by RRF/DBSF, or exact rescoring of their candidate union
    against --target. No model load."""
    from .store import StoreError
    from .store.filter import FilterError

    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    prefetch = []
    for spec in args.prefetch or []:
        try:
            prefetch.append(json.loads(spec))
        except ValueError:
            prefetch.append(spec)          # region_id string operand
    target = None
    if sum(x is not None and x is not False
           for x in (args.target, args.text or None, args.random or None)) > 1:
        print("❌ pass only one of --target / --text / --random",
              file=sys.stderr)
        return 1
    if args.target is not None:
        if args.target.lstrip("-").isdigit():
            target = int(args.target)
        else:
            try:          # explicit vector operands: a JSON [..] dense
                          # vector or {"indices","values"} sparse dict
                target = json.loads(args.target)
            except ValueError:
                target = args.target       # region_id string operand
    elif args.text:
        target = {"text": args.text}
    elif args.random:
        target = {"sample": "random"}
    kw = dict(prefetch=prefetch or None, fusion=args.fusion,
              filter=args.filter or None, seed=args.seed,
              using=getattr(args, "using", "") or "",
              lookup_from=_lookup_from_arg(
                  getattr(args, "lookup_from", None)))
    try:
        if args.group_by:
            # qdrant query_points_groups: bucket the universal query
            # by a payload key
            groups = engine.query_groups(
                target, group_by=args.group_by,
                group_size=args.group_size, limit=args.top_k, **kw)
            if args.json:
                print(json.dumps({"groups": groups}, indent=2))
            else:
                for g in groups:
                    print(f"{args.group_by}={g['key']}")
                    for h in g["hits"]:
                        print(f"  {h['id']}\t{h['score']:.6f}\t"
                              f"{json.dumps(h['payload'])}")
            return 0 if groups else 2
        hits = engine.query(target, k=args.top_k, **kw)
    except (StoreError, FilterError, ValueError) as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({"hits": hits}, indent=2))
    else:
        for h in hits:
            print(f"{h['id']}\t{h['score']:.6f}\t"
                  f"{json.dumps(h['payload'])}")
    return 0 if hits else 2


def cmd_matrix(args) -> int:
    """Pairwise similarity over a random sample of stored points —
    qdrant's search_matrix_pairs/offsets role (cluster/dedup view).
    No model load."""
    from .store import StoreError
    from .store.filter import FilterError

    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    try:
        out = engine.search_matrix(
            sample=args.sample, limit=args.limit,
            filter=args.filter or None, seed=args.seed,
            offsets=args.offsets)
    except (StoreError, FilterError, ValueError) as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    if args.offsets or args.json:
        print(json.dumps(out if args.offsets else {"pairs": out},
                         indent=2))
    else:
        for p in out:
            print(f"{p['id_a']}\t{p['id_b']}\t{p['score']:.6f}")
    # the offsets dict is always truthy — test the ids list instead so
    # "no results" exits 2 in both output modes
    return 0 if (out["ids"] if args.offsets else out) else 2


def cmd_points(args) -> int:
    """Page through stored points (ids + payloads), optionally filtered
    and/or ordered by a numeric payload key — qdrant's scroll API role.
    No model load."""
    from .store import StoreError
    from .store.filter import FilterError

    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    offset = 0
    if args.offset:
        if args.order_by:
            try:
                v, i = args.offset.rsplit(":", 1)
                offset = (float(v), int(i))
            except ValueError:
                print(f"❌ with --order-by, --offset is the printed "
                      f"VALUE:ID token, got '{args.offset}'",
                      file=sys.stderr)
                return 1
        else:
            offset = int(args.offset)
    try:
        points, next_offset = engine.scroll(
            args.filter or None, offset=offset, limit=args.limit,
            order_by=args.order_by,
            direction="desc" if args.desc else "asc",
            with_vectors=getattr(args, "vectors", False),
            using=getattr(args, "space", "") or "")
    except (StoreError, FilterError, ValueError) as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    next_tok = (None if next_offset is None
                else (f"{next_offset[0]!r}:{next_offset[1]}"
                      if args.order_by else next_offset))
    if args.json:
        print(json.dumps({"points": points, "next_offset": next_tok},
                         indent=2))
    else:
        for pt in points:
            print(f"{pt['id']}\t{json.dumps(pt['payload'])}")
        if next_tok is not None:
            print(f"… next: --offset {next_tok}", file=sys.stderr)
    return 0


def cmd_facet(args) -> int:
    """Value histogram of one payload key (qdrant facet API role).
    No model load."""
    from .store import StoreError
    from .store.filter import FilterError

    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    try:
        rows = engine.facet(args.key, args.filter or None,
                            limit=args.limit)
    except (StoreError, FilterError) as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({"key": args.key, "facets": rows}, indent=2))
    else:
        for r in rows:
            print(f"{r['count']:>8}  {r['value']}")
    return 0


def cmd_get(args) -> int:
    """Fetch points by row id or region_id (qdrant retrieve API role).
    No model load."""
    from .store import StoreError

    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    ids = [int(i) if i.lstrip("-").isdigit() else i for i in args.ids]
    try:
        points = engine.retrieve(ids, with_vectors=args.vectors)
    except StoreError as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    for pt in points:
        if "vector" in pt:
            pt["vector"] = [round(float(x), 6) for x in pt["vector"]]
    if args.json:
        print(json.dumps({"points": points}, indent=2))
    else:
        for pt in points:
            line = f"{pt['id']}\t{json.dumps(pt['payload'])}"
            if "vector" in pt:
                line += f"\t{json.dumps(pt['vector'])}"
            print(line)
    return 0 if points else 2


def cmd_payload(args) -> int:
    """Mutate point payloads in place (qdrant set_payload /
    overwrite / delete_payload / clear_payload). Vectors and the
    device index are untouched. No model load."""
    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    points = [int(i) if i.lstrip("-").isdigit() else i
              for i in (args.points or [])]
    filt = args.filter or None
    if args.action in ("set", "overwrite"):
        patch = {}
        for kv in args.kv or []:
            if "=" not in kv:
                print(f"❌ bad --kv '{kv}' (expected KEY=VALUE)",
                      file=sys.stderr)
                return 1
            k, v = kv.split("=", 1)
            try:
                patch[k] = json.loads(v)
            except ValueError:
                patch[k] = v
        if not patch:
            print("❌ set/overwrite need at least one --kv KEY=VALUE",
                  file=sys.stderr)
            return 1
        fn = (engine.set_payload if args.action == "set"
              else engine.overwrite_payload)
        msg = fn(patch, points=points, filter=filt)
    elif args.action == "delete":
        if not args.keys:
            print("❌ delete needs --keys", file=sys.stderr)
            return 1
        msg = engine.delete_payload(args.keys, points=points, filter=filt)
    else:
        msg = engine.clear_payload(points=points, filter=filt)
    out = sys.stdout if msg.startswith("✅") else sys.stderr
    print(msg, file=out)
    return 0 if msg.startswith("✅") else 1


def cmd_batch(args) -> int:
    """Apply an ordered list of point mutations from a JSON file in
    ONE writable session (qdrant's batch_update_points role). The file
    holds a JSON list of one-key operation dicts (or {"operations":
    [...]}); see `Reverso.update_batch` for the op shapes. Bulk vector
    appends belong in `upsert` (npz); this is the admin-edit path."""
    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    try:
        with open(args.file) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"❌ cannot read {args.file}: {e}", file=sys.stderr)
        return 1
    ops = doc.get("operations") if isinstance(doc, dict) else doc
    if not isinstance(ops, list):
        print('❌ expected a JSON list of operations or '
              '{"operations": [...]}', file=sys.stderr)
        return 1
    msg = engine.update_batch(ops)
    out = sys.stdout if msg.startswith("✅") else sys.stderr
    print(msg, file=out)
    return 0 if msg.startswith("✅") else 1


def cmd_upsert(args) -> int:
    """Append externally computed points: vectors from an .npz
    (`vectors` [m, d], optional `payloads` as JSON strings, optional
    NAMED vector spaces as extra `vectors_<name>` members — qdrant
    named vectors — SPARSE spaces as CSR triples
    `sparse_<name>_indices` / `_values` / `_indptr`, and MULTIVECTOR
    spaces as `multi_<name>_vectors` [sum T, d] + `multi_<name>_indptr`
    [m+1]), payloads alternatively from a JSONL sidecar (qdrant upsert
    role). Creates the database when missing (named/sparse/multivector
    spaces and their dims come from the npz members). No model load."""
    import numpy as np

    from .store import StoreError, VectorStore

    cfg = _make_config(args)
    named = {}
    sparse = {}
    multi = {}
    try:
        with np.load(args.npz, allow_pickle=False) as z:
            vecs = np.asarray(z["vectors"], np.float32)
            pls = ([json.loads(s) for s in z["payloads"].tolist()]
                   if "payloads" in z.files else None)
            for member in z.files:
                if member.startswith("sparse_") and \
                        member.endswith("_indices"):
                    sp = member[len("sparse_"):-len("_indices")]
                    si = np.asarray(z[member], np.int64)
                    sv = np.asarray(z[f"sparse_{sp}_values"], np.float32)
                    ptr = np.asarray(z[f"sparse_{sp}_indptr"], np.int64)
                    sparse[sp] = [
                        {"indices": si[ptr[r]:ptr[r + 1]],
                         "values": sv[ptr[r]:ptr[r + 1]]}
                        for r in range(len(ptr) - 1)]
                elif member.startswith("multi_") and \
                        member.endswith("_vectors"):
                    sp = member[len("multi_"):-len("_vectors")]
                    mv = np.asarray(z[member], np.float32)
                    ptr = np.asarray(z[f"multi_{sp}_indptr"], np.int64)
                    multi[sp] = [mv[ptr[r]:ptr[r + 1]]
                                 for r in range(len(ptr) - 1)]
                elif member.startswith("vectors_"):
                    named[member[len("vectors_"):]] = np.asarray(
                        z[member], np.float32)
    except (OSError, KeyError, ValueError, IndexError) as e:
        print(f"❌ Cannot read {args.npz}: {e}", file=sys.stderr)
        return 1
    if args.payloads:
        try:
            with open(args.payloads) as f:
                pls = [json.loads(line) for line in f if line.strip()]
        except (OSError, ValueError) as e:
            print(f"❌ Cannot read {args.payloads}: {e}", file=sys.stderr)
            return 1
    root = cfg.store.root_dir
    import os as _os
    from .store import resolve_alias
    # resolve BEFORE the create-on-missing check: upserting into an
    # alias must append to its target, not create a shadow db whose
    # real directory would win over the alias forever after
    name = resolve_alias(root, args.name)
    if not _os.path.isdir(_os.path.join(root, name)):
        if vecs.ndim != 2 or len(vecs) == 0:
            print("❌ Need [m, d] vectors to create a database",
                  file=sys.stderr)
            return 1
        try:
            VectorStore.create(
                root, name, int(vecs.shape[1]),
                named={n: int(a.shape[1]) for n, a in named.items()}
                      or None,
                sparse={n: {} for n in sparse} or None,
                multi={n: int(rows[0].shape[1])
                       for n, rows in multi.items() if rows}
                      or None,
                distance=getattr(args, "distance", "") or
                         "cosine").close()
        except StoreError as e:
            print(f"❌ {e}", file=sys.stderr)
            return 1
    engine = _make_engine(args)
    msg = engine.load_database(name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    msg = engine.upsert_points(
        {"": vecs, **named, **sparse, **multi}
        if (named or sparse or multi) else vecs,
        pls)
    out = sys.stdout if msg.startswith("✅") else sys.stderr
    print(msg, file=out)
    return 0 if msg.startswith("✅") else 1


def cmd_update_vectors(args) -> int:
    """Overwrite stored vectors by id from an .npz file with `ids`
    (ints and/or region_id strings) and `vectors` [m, d] — or, for a
    SPARSE --space, CSR members `indices`/`values`/`indptr` ([m+1])
    (qdrant update_vectors role). No model load."""
    import numpy as np

    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    try:
        with np.load(args.npz, allow_pickle=False) as z:
            ids_raw = z["ids"]
            if "indptr" in z.files and "indices" in z.files:
                # sparse rows, CSR layout
                si = np.asarray(z["indices"], np.int64)
                sv = np.asarray(z["values"], np.float32)
                ptr = np.asarray(z["indptr"], np.int64)
                vecs = [{"indices": si[ptr[r]:ptr[r + 1]],
                         "values": sv[ptr[r]:ptr[r + 1]]}
                        for r in range(len(ptr) - 1)]
            elif "indptr" in z.files:
                # multivector rows: flat [sum T, d] + indptr [m+1]
                mv = np.asarray(z["vectors"], np.float32)
                ptr = np.asarray(z["indptr"], np.int64)
                vecs = [mv[ptr[r]:ptr[r + 1]]
                        for r in range(len(ptr) - 1)]
            else:
                vecs = np.asarray(z["vectors"], np.float32)
    except (OSError, KeyError, ValueError, IndexError) as e:
        print(f"❌ Cannot read {args.npz}: {e}", file=sys.stderr)
        return 1
    ids = [i if isinstance(i, str) else int(i)
           for i in ids_raw.tolist()]
    msg = engine.update_vectors(ids, vecs,
                                using=getattr(args, "space", "") or "")
    out = sys.stdout if msg.startswith("✅") else sys.stderr
    print(msg, file=out)
    return 0 if msg.startswith("✅") else 1


def cmd_index_payload(args) -> int:
    """Persist typed payload-column views (qdrant create_payload_index
    role): later processes skip the JSONL stream for these keys. No
    model load."""
    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    msg = engine.index_payload(args.keys,
                               text=getattr(args, "text", False))
    out = sys.stdout if msg.startswith("✅") else sys.stderr
    print(msg, file=out)
    return 0 if msg.startswith("✅") else 1


def cmd_alias(args) -> int:
    """Manage database aliases (qdrant collection-aliases role):
    point a stable name at a database, flip it atomically after a
    rebuild."""
    from .store import StoreError, delete_alias, list_aliases, set_alias

    cfg = _make_config(args)
    root = cfg.store.root_dir
    if args.action != "list" and not args.alias:
        print(f"❌ alias {args.action} needs an alias name",
              file=sys.stderr)
        return 1
    try:
        if args.action == "set":
            if not args.db:
                print("❌ alias set needs ALIAS DB", file=sys.stderr)
                return 1
            set_alias(root, args.alias, args.db)
            print(f"✅ Alias {args.alias} -> {args.db}")
        elif args.action == "delete":
            if delete_alias(root, args.alias):
                print(f"✅ Deleted alias {args.alias}")
            else:
                print(f"ℹ️ No alias named {args.alias}")
        else:
            for a, n in sorted(list_aliases(root).items()):
                print(f"{a}\t{n}")
    except StoreError as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    return 0


def cmd_list(args) -> int:
    engine = _make_engine(args)
    for name in engine.list_databases():
        print(name)
    return 0


def cmd_delete(args) -> int:
    engine = _make_engine(args)
    msg = engine.delete_database(args.name)
    print(msg)
    return 0 if msg.startswith("✅") else 1


def cmd_unlock(args) -> int:
    engine = _make_engine(args)
    msg = engine.unlock_database(args.name)
    print(msg)
    return 0 if not msg.startswith("❌") else 1


def cmd_delete_vectors(args) -> int:
    """Remove named vectors from points WITHOUT deleting the points
    (qdrant delete_vectors role: payloads and other spaces stay; the
    rows drop out of that space's searches and has_vector). No model
    load."""
    engine = _make_engine(args)
    msg = engine.load_database(args.name)
    if msg.startswith("❌"):
        print(msg, file=sys.stderr)
        return 1
    ids = [int(raw) if raw.lstrip("-").isdigit() else raw
           for raw in (args.ids or [])]
    msg = engine.delete_vectors(ids or None, args.spaces or [""],
                                filter=args.filter or None)
    out = sys.stdout if msg.startswith("✅") else sys.stderr
    print(msg, file=out)
    return 0 if msg.startswith("✅") else 1


def cmd_prune(args) -> int:
    """Delete rows matching a payload filter and/or explicit point ids
    (store compaction; no model load). --dry-run reports the match
    count and changes nothing."""
    import numpy as np
    from .store import VectorStore, StoreError, StoreLockedError, payload_mask

    cfg = _make_config(args)
    from .store.filter import parse_filter

    def drop_mask(store) -> "np.ndarray":
        drop = np.zeros(store.count, bool)
        if args.filter:
            drop |= payload_mask(store, args.filter)
        for raw in (args.ids or []):
            if raw.lstrip("-").isdigit():
                r = int(raw)
                if 0 <= r < store.count:
                    drop[r] = True
            else:  # region_id string: mark every row carrying it
                from .store.filter import PayloadColumns
                view = PayloadColumns(store).view("region_id")
                code = view.uindex.get(raw, -2)
                if code >= 0:
                    drop |= view.codes == code
        return drop

    try:
        if args.filter and parse_filter(args.filter).is_empty():
            print("❌ Refusing to prune with an empty filter "
                  "(use `delete` to drop the whole database)",
                  file=sys.stderr)
            return 1
        if not args.filter and not args.ids:
            print("❌ Pass --filter and/or --ids "
                  "(use `delete` to drop the whole database)",
                  file=sys.stderr)
            return 1
        if args.dry_run:
            store = VectorStore.open(cfg.store.root_dir, args.name)
            n = int(drop_mask(store).sum())
            print(f"🔎 {n} of {store.count} rows match (dry run; nothing deleted)")
            return 0
        with VectorStore.open(cfg.store.root_dir, args.name,
                              writable=True) as w:
            removed = w.compact(~drop_mask(w))
            remaining = w.count
    except StoreLockedError as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    except StoreError as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    print(f"✅ Deleted {removed} rows from {args.name} ({remaining} remain)")
    return 0


def cmd_info(args) -> int:
    """Database stats without loading a model."""
    from .store import VectorStore, StoreError
    from .store.persist import LOCK_FILE

    cfg = _make_config(args)
    try:
        store = VectorStore.open(cfg.store.root_dir, args.name)
    except StoreError as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    root = os.path.join(cfg.store.root_dir, args.name)
    size = sum(os.path.getsize(os.path.join(root, f))
               for f in os.listdir(root)
               if os.path.isfile(os.path.join(root, f)))
    locked = os.path.exists(os.path.join(root, LOCK_FILE))
    info = {"name": store.name, "collection": store.collection,
            "rows": store.count, "dim": store.dim,
            "disk_bytes": size, "locked": locked,
            "data_version": store.data_version}
    if store.named:
        info["named_vectors"] = dict(store.named)
    if store.sparse:
        info["sparse_vectors"] = sorted(store.sparse)
    if store.multi:
        info["multivectors"] = dict(store.multi)
    if store.distance != "cosine":
        info["distance"] = store.distance
    if args.filter:
        # filtered point count (qdrant count API role), no model load
        from .store.filter import FilterError, parse_filter, payload_mask
        try:
            spec = parse_filter(args.filter)
            info["matching"] = (store.count if spec.is_empty() else
                                int(payload_mask(store, args.filter).sum()))
        except FilterError as e:
            print(f"❌ {e}", file=sys.stderr)
            return 1
    if args.classes and store.count:
        from collections import Counter
        hist = Counter()
        for p in store.payloads():
            hist[p.get("detected_class", "?")] += 1
        info["classes"] = dict(hist.most_common())
    if args.json:
        print(json.dumps(info, indent=2))
    else:
        for k, v in info.items():
            print(f"{k}: {v}")
    return 0


def cmd_export(args) -> int:
    """Snapshot a database to a single portable file (no model load)."""
    from .store import VectorStore, StoreError

    cfg = _make_config(args)
    try:
        store = VectorStore.open(cfg.store.root_dir, args.name)
        out = store.export_snapshot(args.output)
    except StoreError as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    print(f"✅ Exported {args.name} ({store.count} rows, dim {store.dim}) "
          f"to {out}")
    return 0


def cmd_import(args) -> int:
    """Restore a snapshot as a (new) database (no model load)."""
    from .store import VectorStore, StoreError, StoreLockedError

    cfg = _make_config(args)
    try:
        store = VectorStore.import_snapshot(
            cfg.store.root_dir, args.name, args.snapshot,
            overwrite=args.overwrite)
    except (StoreError, StoreLockedError, OSError) as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    print(f"✅ Imported {args.name}: {store.count} rows, dim {store.dim}")
    return 0


def cmd_serve(args) -> int:
    from .ui.server import serve
    engine = _make_engine(args, need_detector=True)
    if args.name:
        msg = engine.load_database(args.name)
        print(msg, file=sys.stderr)
        if msg.startswith("❌"):
            return 1
    if args.warmup:
        print("🔥 Warming the search and embed paths (the first call "
              "builds the CUDA kernels)...", file=sys.stderr)
        print(engine.warmup(include_detector=engine.detector is not None),
              file=sys.stderr)
    serve(engine, host=args.host, port=args.port)
    return 0


def cmd_bench(args) -> int:
    """Not ported: `bench.py` drives the JAX package, and the port's
    benchmark is ROADMAP queue 1 item 8."""
    print("❌ the port has no benchmark yet (ROADMAP queue 1 item 8); "
          "`bench.py` drives the JAX package", file=sys.stderr)
    return 1


def cmd_tune(args) -> int:
    """Pick the smallest IVF nprobe meeting --target-recall on a store.

    Ground truth is the index's OWN full probe (nprobe == n_clusters),
    which by the IVF contract reproduces the exact scan over the
    stored representation. That isolates exactly what the knob being
    tuned costs — probe misses — and is immune to storage-dtype
    rounding: on near-duplicate-heavy corpora a fp32 host-scan truth
    diverges from bf16-stored scoring on ties and recall saturates
    below 1.0 at every nprobe, making the target unreachable. Builds
    (or reloads) the SAME persisted k-means cache serving uses, so a
    tune run also warms the index for the first real search."""
    import time

    import numpy as np
    from .engine import load_or_build_ivf
    from .store import VectorStore

    device = _device(args)
    cfg = _make_config(args)
    try:
        store = VectorStore.open(cfg.store.root_dir, args.name)
    except Exception as e:
        print(f"❌ {e}", file=sys.stderr)
        return 1
    space = getattr(args, "space", "") or ""
    if space and space not in store.spaces():
        print(f"❌ unknown vector space {space!r} "
              f"(have {sorted(store.spaces())})", file=sys.stderr)
        return 1
    if store.distance not in ("cosine", "dot"):
        # serving's IVF gate only engages for these metrics — a tuned
        # cache on a euclid/manhattan store would never be used
        print(f"❌ IVF indexes cosine/dot stores only (this store's "
              f"distance is {store.distance})", file=sys.stderr)
        return 1
    vecs = np.ascontiguousarray(np.asarray(store.vectors(space)),
                                np.float32)
    n = len(vecs)
    if n == 0:
        print("❌ store is empty", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    qn = min(args.queries, n)
    q = vecs[rng.choice(n, qn, replace=False)]
    k = min(args.k, n)

    print(f"store '{args.name}': {n} vectors x {vecs.shape[1]}, "
          f"{qn} sampled queries, recall@{k} target "
          f"{args.target_recall}", file=sys.stderr)
    note = None
    if n <= cfg.search.ivf_clusters * 4:
        # the engine only engages IVF past clusters*4 rows — below
        # that serving takes the exact scan regardless, so the sweep
        # describes a path serving won't use
        note = (f"store has {n} rows <= 4x ivf_clusters "
                f"({cfg.search.ivf_clusters}): serving uses the EXACT "
                f"scan for this config; tune is informational only")
        print(f"⚠️ {note}", file=sys.stderr)
    ivf = load_or_build_ivf(store, vecs, cfg.search, cfg.store.dtype,
                            space=space, device=device)
    true_i = ivf.search(q, k, nprobe=ivf.n_clusters)[1].cpu().numpy()

    def recall_at(nprobe):
        ivf.search(q, k, nprobe=nprobe)[1].cpu()
        # second run: the first pays the kernels' build at first use
        t0 = time.perf_counter()
        ids = ivf.search(q, k, nprobe=nprobe)[1].cpu().numpy()
        dt = time.perf_counter() - t0
        hits = 0
        total = 0
        for got, want in zip(np.asarray(ids), true_i):
            w = set(int(x) for x in want if x >= 0)
            hits += len(set(int(x) for x in got if x >= 0) & w)
            total += len(w)
        return hits / max(total, 1), dt

    rows = []
    pick = None
    nprobe = 1
    while nprobe <= ivf.n_clusters:
        r, dt = recall_at(nprobe)
        rows.append((nprobe, r, dt))
        print(f"  nprobe {nprobe:5d}  recall {r:.4f}  "
              f"{dt * 1e3:8.2f} ms / {qn} queries", file=sys.stderr)
        if r >= args.target_recall:
            pick = nprobe
            break
        # pow2 ladder, clamped so the full probe (exact) is measured
        nprobe = min(nprobe * 2, ivf.n_clusters) \
            if nprobe < ivf.n_clusters else ivf.n_clusters + 1
    if pick is not None and pick > 1:
        # refine inside (last-failing, first-passing]: the ladder's
        # pick can be up to 2x the true smallest nprobe
        lo = rows[-2][0] if len(rows) > 1 else 0
        hi = pick
        while hi - lo > 1:
            mid = (lo + hi) // 2
            r, dt = recall_at(mid)
            rows.append((mid, r, dt))
            print(f"  nprobe {mid:5d}  recall {r:.4f}  "
                  f"{dt * 1e3:8.2f} ms / {qn} queries  (refine)",
                  file=sys.stderr)
            if r >= args.target_recall:
                hi = mid
            else:
                lo = mid
        pick = hi
    if pick is None:
        pick = ivf.n_clusters     # full probe reproduces the exact scan
        print(f"⚠️ target {args.target_recall} not reached below full "
              f"probe; recommending nprobe={pick} (exact)",
              file=sys.stderr)
    out = {
        "database": args.name, "count": n, "dim": int(vecs.shape[1]),
        "clusters": ivf.n_clusters, "k": k,
        "target_recall": args.target_recall,
        "recommended_nprobe": pick,
        "sweep": [{"nprobe": p_, "recall": round(r_, 4),
                   "ms_per_batch": round(dt_ * 1e3, 2)}
                  for p_, r_, dt_ in sorted(rows)],
        "flag": f"--index ivf --ivf-nprobe {pick}",
    }
    if note:
        out["note"] = note
    print(json.dumps(out, indent=2))
    return 0


def cmd_video_local(args) -> int:
    from .ingest.video import process_local_videos_with_progress
    msg = process_local_videos_with_progress(
        args.input_folder, args.output_folder, args.fps, args.threshold)
    print(msg)
    return 0 if msg.startswith("✅") else 1


def cmd_train(args) -> int:
    """SigLIP contrastive fine-tuning on two augmented views per image, on
    the JAX command's mesh, `MeshConfig(axis_sizes=(-1, --tp))`: over every
    visible card for `--device cuda`, over the named device repeated
    `--tp` times (one data shard) for a device with an index or the CPU."""
    import numpy as np
    from .config import MeshConfig
    from .ingest.images import scan_images, iter_batches
    from .parallel import local_devices, make_mesh
    from .train import ClipTrainer
    from .train.checkpoint import save_train_state, restore_train_state

    cfg = MODEL_PRESETS[args.model or "PE-Core-L14-336"]
    device = _device(args)
    devices = local_devices() if str(device) == "cuda" else [device] * args.tp
    try:
        mesh = make_mesh(MeshConfig(axis_sizes=(-1, args.tp)), devices=devices)
        trainer = ClipTrainer(cfg, mesh, learning_rate=args.lr)
    except ValueError as e:
        print(f"❌ --tp {args.tp}: {e}", file=sys.stderr)
        return 1
    if args.resume and args.checkpoint:
        trainer.state = restore_train_state(args.checkpoint, trainer.state, mesh=mesh)
        print(f"resumed at step {int(trainer.step)}", file=sys.stderr)

    files = scan_images(args.folder)
    if not files:
        print(f"no images in {args.folder}", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    step = 0
    loss = float("nan")        # --steps 0: nothing trained, no NameError
    while step < args.steps:
        for batch in iter_batches(files, cfg.image_size, args.batch_size):
            if step >= args.steps or not len(batch.paths):
                break
            a = batch.pixels
            # light augmentation: horizontal flip + pixel noise as view b
            b = a[:, :, ::-1, :] + 0.02 * rng.standard_normal(
                a.shape).astype(np.float32)
            loss = trainer.train_step(a, b)
            step += 1
            if step % 10 == 0 or step == args.steps:
                print(f"step {step}/{args.steps} loss {loss:.4f}",
                      file=sys.stderr)
            if args.checkpoint and step % 100 == 0:
                save_train_state(args.checkpoint, trainer.state)
    if args.checkpoint:
        save_train_state(args.checkpoint, trainer.state)
        print(f"saved checkpoint to {args.checkpoint}", file=sys.stderr)
    print(f"final loss {loss:.4f}")
    return 0


def cmd_video_urls(args) -> int:
    from .ingest.video import extract_frames_with_progress
    msg = extract_frames_with_progress(
        args.urls, args.output_folder, fps=args.fps, thresh=args.threshold,
        qual=args.quality)
    print(msg)
    return 0 if msg.startswith("✅") else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="reverso-torch",
                                description="visual investigation engine "
                                            "(PyTorch port, CUDA)")
    p.add_argument("--device", default="cuda",
                   help="torch device every model and index runs on "
                        "(default cuda; cpu runs on the CPU, the kernels' "
                        "plain PyTorch versions)")
    p.add_argument("--model", choices=sorted(MODEL_PRESETS), default=None,
                   help="model preset (default PE-Core-L14-336)")
    p.add_argument("--db-root", default=None, help="database root directory")
    p.add_argument("--trace-dir", default=None,
                   help="capture a torch.profiler trace of the command "
                        "into this directory (trace.json: the card's "
                        "activity and the program's spans; open with "
                        "Perfetto or chrome://tracing) and print device "
                        "idle by span")
    p.add_argument("--embed-quant", choices=["none", "int8"], default=None,
                   help="int8: the embed tower's MLPs on the int8 kernel "
                        "(dynamic int8 activations), with measured "
                        "embedding noise; default exact bf16")
    p.add_argument("--detector-dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="GroundingDINO+SAM activation dtype: float32 "
                        "(default; SAM's rel-pos bias attention takes "
                        "bf16 operands on the card, as the reference's "
                        "kernel does) or bfloat16")
    p.add_argument("--index-dtype",
                   choices=["float32", "bfloat16", "int8", "binary", "pq"],
                   default=None,
                   help="on-device search-index dtype (disk stays fp32): "
                        "bfloat16 (default) / int8 (2x capacity, same scan "
                        "speed, exact w.r.t. the int8 copy) / float32 "
                        "(strict parity mode) / binary (16x capacity "
                        "sign-packed candidate scan + exact rescore of "
                        "the top --binary-oversampling*k — approximate; "
                        "qdrant binary quantization) / pq (product "
                        "quantization: --pq-m byte codes + learned "
                        "codebooks, same rescore split — approximate; "
                        "qdrant ProductQuantization)")
    p.add_argument("--binary-oversampling", type=float, default=None,
                   help="binary index: candidate fetch multiple before "
                        "the exact rescore (recall knob, default 3.0)")
    p.add_argument("--int8-quantile", type=float, default=None,
                   help="int8 index: abs-value quantile setting the "
                        "quantization scale (qdrant ScalarQuantization "
                        "quantile; e.g. 0.99 clips the outlier tail to "
                        "+-127 and resolves the bulk more finely; "
                        "0/default = exact abs-max, nothing clips)")
    p.add_argument("--pq-m", type=int, default=None,
                   help="pq index: subspace count = bytes per row in "
                        "HBM (0 = d/8, binary's footprint)")
    p.add_argument("--pq-oversampling", type=float, default=None,
                   help="pq index: candidate fetch multiple before the "
                        "exact rescore (recall knob, default 3.0)")
    p.add_argument("--index", choices=["exact", "ivf", "host"], default=None,
                   help="search index: exact fused scan (default), IVF "
                        "k-means coarse quantizer for very large corpora, "
                        "or the native C++ host scan (no accelerator)")
    p.add_argument("--ivf-nprobe", type=int, default=None,
                   help="IVF clusters probed per query (recall knob)")
    p.add_argument("--ivf-spill", type=float, default=None,
                   help="IVF: fraction of rows duplicated into their "
                        "runner-up cluster (SOAR-lite; raises recall at "
                        "fixed nprobe for ~spill x storage overhead)")
    p.add_argument("--ivf-impl", choices=["auto", "xla", "pallas"],
                   default=None,
                   help="the JAX package's IVF implementation choice, "
                        "accepted so its command lines run unchanged: a "
                        "CUDA index always launches the probed-scan "
                        "kernel")
    p.add_argument("--ingest-backend", choices=["pil", "cv2"], default=None,
                   help="host image decode/resize backend for builds: pil "
                        "(reference transform family, default) or cv2 "
                        "(OpenCV SIMD, ~2-4x faster per host core; resize-"
                        "kernel pixel deltas ~1.3/255 vs PIL)")
    p.add_argument("--ivf-balance", type=float, default=None,
                   help="IVF: cluster-size cap as a multiple of the mean "
                        "(>= 1.0; 0/off default). Oversized clusters are "
                        "split into child centroids, bounding per-probe "
                        "scan cost on skewed data")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build a searchable database from a folder")
    b.add_argument("folder")
    b.add_argument("--name", required=True)
    b.add_argument("--prompt", default="person . car . building")
    b.add_argument("--direct-pe", action="store_true",
                   help="whole-image embeddings, no detection")
    b.add_argument("--resume", action="store_true")
    b.add_argument("--subfolders", action="store_true")
    b.set_defaults(fn=cmd_build)

    s = sub.add_parser("search",
                       help="search a database with query image(s); several "
                            "images batch into one embed + one search launch")
    s.add_argument("image", nargs="+")
    s.add_argument("--name", required=True)
    s.add_argument("--threshold", type=float, default=None)
    s.add_argument("--top-k", type=int, default=None)
    s.add_argument("--json", action="store_true")
    s.add_argument("--filter", action="append", default=[],
                   help="payload filter clause(s): key=value, key!=value, "
                        "key>=N, key<=N (repeatable; all must hold), or a "
                        "JSON object with must/should/must_not")
    s.add_argument("--group-by", default=None, metavar="KEY",
                   help="group results by a payload key (qdrant "
                        "search_groups): --top-k counts groups, each "
                        "reporting its best --group-size hits")
    s.add_argument("--group-size", type=int, default=3)
    s.add_argument("--with-lookup", default=None, metavar="COLL",
                   help="join each group key against a point of "
                        "ANOTHER collection (qdrant with_lookup): int "
                        "keys are row ids there, string keys match "
                        "region_id")
    s.set_defaults(fn=cmd_search)

    st = sub.add_parser("search-text",
                        help="search a database with a text description")
    st.add_argument("text")
    st.add_argument("--name", required=True)
    st.add_argument("--threshold", type=float, default=None)
    st.add_argument("--top-k", type=int, default=None)
    st.add_argument("--json", action="store_true")
    st.add_argument("--filter", action="append", default=[],
                    help="payload filter clause(s), as in `search`")
    st.set_defaults(fn=cmd_search_text)

    rc = sub.add_parser("recommend",
                        help="search by positive/negative example point ids "
                             "(qdrant recommend)")
    rc.add_argument("--name", required=True)
    rc.add_argument("--positive", action="append", type=int, required=True,
                    help="example point id to move toward (repeatable)")
    rc.add_argument("--negative", action="append", type=int, default=[],
                    help="example point id to move away from (repeatable)")
    rc.add_argument("--strategy",
                    choices=("average", "sum_scores", "best_score"),
                    default="average")
    rc.add_argument("--threshold", type=float, default=None)
    rc.add_argument("--top-k", type=int, default=None)
    rc.add_argument("--json", action="store_true")
    rc.add_argument("--filter", action="append", default=[],
                    help="payload filter clause(s), as in `search`")
    rc.add_argument("--lookup-from", default=None, metavar="COLL[:SPACE]",
                    help="resolve example point ids in ANOTHER "
                         "collection's vector space (qdrant "
                         "lookup_from)")
    rc.set_defaults(fn=cmd_recommend)

    dc = sub.add_parser("discover",
                        help="discovery search: target point id steered "
                             "by positive:negative context pairs "
                             "(qdrant discover)")
    dc.add_argument("--name", required=True)
    dc.add_argument("--target", type=int, default=None,
                    help="target point id (omit for pure context search)")
    dc.add_argument("--pair", action="append", default=[],
                    metavar="POS_ID:NEG_ID",
                    help="context pair of point ids (repeatable)")
    dc.add_argument("--top-k", type=int, default=None)
    dc.add_argument("--json", action="store_true")
    dc.add_argument("--filter", action="append", default=[],
                    help="payload filter clause(s), as in `search`")
    dc.set_defaults(fn=cmd_discover)

    qr = sub.add_parser("query",
                        help="universal query: prefetch + RRF/DBSF "
                             "fusion or exact rescore (qdrant "
                             "query_points)")
    qr.add_argument("name")
    qr.add_argument("--prefetch", action="append", default=[],
                    metavar="SPEC",
                    help="branch: a point id, a region_id, or a JSON "
                         "object {\"query\": id, \"limit\": n, "
                         "\"filter\": ...}; repeatable")
    qr.add_argument("--target", default=None,
                    help="rescoring query point (row id or region_id); "
                         "mutually exclusive with --fusion")
    qr.add_argument("--text", default=None,
                    help="rescoring query as natural language (needs "
                         "the CLIP/PE text tower configured)")
    qr.add_argument("--fusion", choices=["rrf", "dbsf"], default=None)
    qr.add_argument("--random", action="store_true",
                    help="return top-k uniformly sampled (filtered) "
                         "points instead of a similarity search "
                         "(qdrant random sampling)")
    qr.add_argument("--seed", type=int, default=None,
                    help="make --random reproducible")
    qr.add_argument("--using", default="",
                    help="named vector space for the top-level query "
                         "(branches may carry their own \"using\")")
    qr.add_argument("--top-k", type=int, default=None)
    qr.add_argument("--filter", action="append", default=[],
                    help="global payload filter, applied inside every "
                         "branch")
    qr.add_argument("--json", action="store_true")
    qr.add_argument("--lookup-from", default=None, metavar="COLL[:SPACE]",
                    help="resolve point-id operands (target, prefetch "
                         "branches) in ANOTHER collection (qdrant "
                         "lookup_from)")
    qr.add_argument("--group-by", default=None, metavar="KEY",
                    help="bucket results by a payload key (qdrant "
                         "query_points_groups); --top-k becomes the "
                         "group count")
    qr.add_argument("--group-size", type=int, default=3,
                    help="hits per group with --group-by")
    qr.set_defaults(fn=cmd_query)

    mx = sub.add_parser("matrix",
                        help="pairwise similarity over a random sample "
                             "of stored points (qdrant search_matrix)")
    mx.add_argument("name")
    mx.add_argument("--sample", type=int, default=10,
                    help="points to sample (without replacement; "
                         "default 10, cap 8192)")
    mx.add_argument("--limit", type=int, default=3,
                    help="nearest neighbors reported per sampled point")
    mx.add_argument("--filter", action="append", default=[],
                    help="sample only points matching this payload "
                         "filter")
    mx.add_argument("--seed", type=int, default=None,
                    help="make the sample reproducible")
    mx.add_argument("--offsets", action="store_true",
                    help="emit qdrant's offsets format (ids + row/col "
                         "offset arrays) instead of pairs")
    mx.add_argument("--json", action="store_true")
    mx.set_defaults(fn=cmd_matrix)

    pt = sub.add_parser("points",
                        help="page through stored points (ids + payloads), "
                             "optionally filtered (qdrant scroll)")
    pt.add_argument("name")
    pt.add_argument("--filter", action="append", default=[],
                    help="payload filter clause(s), as in `search`")
    pt.add_argument("--offset", default="",
                    help="row id to start from, or the printed VALUE:ID "
                         "token when using --order-by")
    pt.add_argument("--limit", type=int, default=50)
    pt.add_argument("--order-by", default=None, metavar="KEY",
                    help="sort by a numeric or RFC 3339 datetime payload "
                         "key instead of row id (qdrant order_by; "
                         "unordered rows excluded)")
    pt.add_argument("--desc", action="store_true",
                    help="descending order (with --order-by)")
    pt.add_argument("--vectors", action="store_true",
                    help="include each point's stored vector (qdrant "
                         "with_vectors)")
    pt.add_argument("--space", default="",
                    help="vector space --vectors reads ('' = default)")
    pt.add_argument("--json", action="store_true")
    pt.set_defaults(fn=cmd_points)

    fc = sub.add_parser("facet",
                        help="value histogram of one payload key "
                             "(qdrant facet API)")
    fc.add_argument("name")
    fc.add_argument("key", help="payload key to count values of")
    fc.add_argument("--filter", action="append", default=[],
                    help="payload filter clause(s), as in `search`")
    fc.add_argument("--limit", type=int, default=10)
    fc.add_argument("--json", action="store_true")
    fc.set_defaults(fn=cmd_facet)

    gt = sub.add_parser("get",
                        help="fetch points by row id or region_id "
                             "(qdrant retrieve API)")
    gt.add_argument("name")
    gt.add_argument("ids", nargs="+",
                    help="row ids (ints) and/or region_id strings")
    gt.add_argument("--vectors", action="store_true",
                    help="include the stored vectors")
    gt.add_argument("--json", action="store_true")
    gt.set_defaults(fn=cmd_get)

    py = sub.add_parser("payload",
                        help="mutate point payloads in place (qdrant "
                             "set/overwrite/delete/clear payload)")
    py.add_argument("name")
    py.add_argument("action", choices=["set", "overwrite", "delete",
                                       "clear"])
    py.add_argument("--kv", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="payload entry for set/overwrite (VALUE parsed "
                         "as JSON, else string); repeatable")
    py.add_argument("--keys", nargs="+", default=[],
                    help="payload keys to remove (delete)")
    py.add_argument("--points", nargs="+", default=[],
                    help="row ids (ints) and/or region_id strings")
    py.add_argument("--filter", action="append", default=[],
                    help="payload filter clause(s), as in `search`")
    py.set_defaults(fn=cmd_payload)

    bt = sub.add_parser("batch",
                        help="apply ordered point mutations from a JSON "
                             "file in one session (qdrant batch update)")
    bt.add_argument("name")
    bt.add_argument("file", help="JSON list of one-key operation dicts "
                                 '(or {"operations": [...]})')
    bt.set_defaults(fn=cmd_batch)

    up = sub.add_parser("upsert",
                        help="append externally computed points "
                             "(vectors + payloads; qdrant upsert)")
    up.add_argument("name")
    up.add_argument("npz", help=".npz with `vectors` [m, d] and "
                                "optionally `payloads` (JSON strings)")
    up.add_argument("--payloads", default=None,
                    help="JSONL file of payloads (overrides the npz's)")
    up.add_argument("--distance", default="",
                    choices=["", "cosine", "dot", "euclid", "manhattan"],
                    help="distance metric when CREATING the database "
                         "(qdrant Distance config; cosine normalizes "
                         "rows, the others store raw magnitudes — "
                         "euclid/manhattan scores are -distance). "
                         "Ignored for an existing database.")
    up.set_defaults(fn=cmd_upsert)

    uv = sub.add_parser("update-vectors",
                        help="overwrite stored vectors by id from an "
                             ".npz (ids + vectors; qdrant "
                             "update_vectors)")
    uv.add_argument("name")
    uv.add_argument("npz", help=".npz with `ids` [m] and `vectors` "
                                "[m, d] (normalized here)")
    uv.add_argument("--space", default="",
                    help="named vector space to overwrite ('' = default)")
    uv.set_defaults(fn=cmd_update_vectors)

    dv = sub.add_parser("delete-vectors",
                        help="remove named vectors from points without "
                             "deleting the points (qdrant "
                             "delete_vectors)")
    dv.add_argument("name")
    dv.add_argument("--ids", nargs="+",
                    help="row ids and/or region_id strings")
    dv.add_argument("--filter", action="append",
                    help="payload filter clause(s), as in `search`")
    dv.add_argument("--spaces", nargs="+", default=None,
                    help="vector spaces to clear (default: the "
                         "default dense space)")
    dv.set_defaults(fn=cmd_delete_vectors)

    ip = sub.add_parser("index-payload",
                        help="persist typed payload-column views for "
                             "instant cold filters (qdrant "
                             "create_payload_index)")
    ip.add_argument("name")
    ip.add_argument("keys", nargs="+", help="payload keys to index")
    ip.add_argument("--text", action="store_true",
                    help="also build + persist the full-text inverted "
                         "index for these keys (qdrant text index)")
    ip.set_defaults(fn=cmd_index_payload)

    al = sub.add_parser("alias",
                        help="manage database aliases (qdrant "
                             "collection aliases)")
    al.add_argument("action", choices=["set", "delete", "list"])
    al.add_argument("alias", nargs="?", default=None)
    al.add_argument("db", nargs="?", default=None)
    al.set_defaults(fn=cmd_alias)

    l = sub.add_parser("list", help="list databases")
    l.set_defaults(fn=cmd_list)

    d = sub.add_parser("delete", help="delete a database")
    d.add_argument("name")
    d.set_defaults(fn=cmd_delete)

    u = sub.add_parser("unlock", help="remove a stale database lock")
    u.add_argument("name")
    u.set_defaults(fn=cmd_unlock)

    pr = sub.add_parser("prune",
                        help="delete rows matching a payload filter "
                             "(crash-safe compaction)")
    pr.add_argument("name")
    pr.add_argument("--filter", action="append",
                    help="payload filter clause(s), as in `search`")
    pr.add_argument("--ids", nargs="+",
                    help="row ids and/or region_id strings to delete")
    pr.add_argument("--dry-run", action="store_true")
    pr.set_defaults(fn=cmd_prune)

    inf = sub.add_parser("info", help="database stats (rows, dim, size)")
    inf.add_argument("name")
    inf.add_argument("--classes", action="store_true",
                     help="include a detected_class histogram (reads "
                          "all payloads)")
    inf.add_argument("--filter", action="append", default=[],
                     help="also report the count of points matching "
                          "these payload clause(s) (qdrant count)")
    inf.add_argument("--json", action="store_true")
    inf.set_defaults(fn=cmd_info)

    ex = sub.add_parser("export",
                        help="snapshot a database to one portable file")
    ex.add_argument("name")
    ex.add_argument("output")
    ex.set_defaults(fn=cmd_export)

    im = sub.add_parser("import",
                        help="restore a database from a snapshot file")
    im.add_argument("snapshot")
    im.add_argument("--name", required=True)
    im.add_argument("--overwrite", action="store_true")
    im.set_defaults(fn=cmd_import)

    v = sub.add_parser("serve", help="start the web UI")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=7860)
    v.add_argument("--name", default=None,
                   help="database to load before serving")
    v.add_argument("--warmup", action="store_true",
                   help="pre-compile the embed/search/detector jits so "
                        "the first request is fast")
    v.set_defaults(fn=cmd_serve)

    be = sub.add_parser("bench", help="the port's benchmark (not ported "
                                      "yet: ROADMAP item 8)")
    be.set_defaults(fn=cmd_bench)

    tu = sub.add_parser("tune",
                        help="pick the smallest IVF nprobe meeting a "
                             "target recall on a store")
    tu.add_argument("--name", required=True)
    tu.add_argument("--target-recall", type=float, default=0.95)
    tu.add_argument("--queries", type=int, default=256,
                    help="self-queries sampled from the store")
    tu.add_argument("--k", type=int, default=10)
    tu.add_argument("--seed", type=int, default=0)
    tu.add_argument("--space", default="",
                    help="named vector space to tune (default: the "
                         "default space)")
    tu.set_defaults(fn=cmd_tune)

    vid = sub.add_parser("video", help="extract keyframes from videos")
    vid_sub = vid.add_subparsers(dest="video_cmd", required=True)
    vl = vid_sub.add_parser("local", help="process videos in a folder")
    vl.add_argument("input_folder")
    vl.add_argument("output_folder")
    vl.add_argument("--fps", type=float, default=2,
                    help="frames per scene/second")
    vl.add_argument("--threshold", type=float, default=30.0,
                    help="scene-cut sensitivity (lower = more scenes)")
    vl.set_defaults(fn=cmd_video_local)
    vu = vid_sub.add_parser("urls", help="download + process video URLs")
    vu.add_argument("urls", help="comma/newline separated URLs")
    vu.add_argument("output_folder")
    vu.add_argument("--fps", type=float, default=2)
    vu.add_argument("--threshold", type=float, default=30.0)
    vu.add_argument("--quality", default="720p")
    vu.set_defaults(fn=cmd_video_urls)

    t = sub.add_parser("train", help="contrastive fine-tune of the vision tower")
    t.add_argument("folder", help="training image folder")
    t.add_argument("--steps", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--tp", type=int, default=1, help="tensor-parallel axis size")
    t.add_argument("--checkpoint", default=None,
                   help="checkpoint file (this package's format, not orbax's)")
    t.add_argument("--resume", action="store_true")
    t.set_defaults(fn=cmd_train)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
