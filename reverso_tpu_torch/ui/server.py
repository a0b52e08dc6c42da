"""Web UI: stdlib HTTP server + single-page app.

The reference serves a 5-tab Gradio Blocks app (reference ui.py:235-408,
main.py:30-40). Gradio is not a dependency here; this module provides the
same five surfaces (video frame extraction, database build with
stop/resume, detect+search, database management, about) as a dependency-
free JSON API + embedded single-page app.

Concurrency model: the reference mutates a global engine from every
callback and races across sessions (SURVEY.md §5.2: search_database_ui
temporarily swaps the singleton's region_embeddings). Here:

  * detect/process responses carry a session token; the captured query
    state (regions, embeddings, metadata) is stored server-side keyed
    by that token, so two browser tabs can never search with each
    other's regions;
  * searches with a token are stateless engine calls routed through the
    micro-batching searcher (`serve.BatchingSearcher`) — concurrent
    searches COALESCE into one device launch instead of serializing;
  * mutating calls (build, db load/delete) still serialize on one lock,
    with fast 409s while a build runs.

This is the PyTorch port's copy of the JAX package's server: the same page
and endpoints over the port's engine; /api/about reports the engine's
torch device ("cuda" or "cpu") as its backend.
"""
from __future__ import annotations

import base64
import io
import json
import threading
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import urlparse

from ..serve import OverloadedError
from ..store import StoreError
from ..store.filter import FilterError
from ..utils.logging import get_logger

log = get_logger("ui")


class BuildJob:
    def __init__(self):
        self.transcript = ""
        self.progress = 0.0
        self.done = False
        self.error: Optional[str] = None
        self.thread: Optional[threading.Thread] = None


class EngineBusyError(RuntimeError):
    """Engine is occupied by a long-running build (HTTP 409)."""


class QuerySession:
    """Immutable-after-capture query state for one detect/search flow."""
    __slots__ = ("regions", "embeddings", "metadata")

    def __init__(self, regions, embeddings, metadata):
        self.regions = regions
        self.embeddings = embeddings
        self.metadata = metadata


_MAX_SESSIONS = 64


class UIState:
    def __init__(self, engine):
        self.engine = engine
        self.lock = threading.Lock()       # serializes engine access
        self.build: Optional[BuildJob] = None
        # admission control for /api/build: the running-build check and
        # the state.build assignment must be atomic, or two concurrent
        # POSTs both pass the check and the second build orphans the
        # first job's status (and can overwrite its output)
        self.build_admission = threading.Lock()
        self.sessions: "OrderedDict[str, QuerySession]" = OrderedDict()
        self._sessions_lock = threading.Lock()

    def put_session(self, sess: QuerySession) -> str:
        token = uuid.uuid4().hex
        with self._sessions_lock:
            self.sessions[token] = sess
            while len(self.sessions) > _MAX_SESSIONS:   # LRU eviction
                self.sessions.popitem(last=False)
        return token

    def get_session(self, token) -> Optional[QuerySession]:
        if not token:
            return None
        with self._sessions_lock:
            sess = self.sessions.get(token)
            if sess is not None:
                self.sessions.move_to_end(token)
            return sess

    def build_running(self) -> bool:
        job = self.build
        return job is not None and not job.done

    def check_no_build_overlap(self, fn):
        """Run `fn` with the build-overlap TOCTOU closed.

        Lock-free search paths replace the engine lock with a
        build_running() check; a build STARTING just after that check
        could mutate the store mid-search, silently answering from a
        partially built index. `state.build` is published before the
        build thread starts (so build_running() is True before any
        store mutation), hence checking again AFTER the search proves
        no build overlapped it — builds run for seconds-to-minutes
        while a search is milliseconds, so a build cannot start and
        finish inside the window."""
        if self.build_running():
            raise EngineBusyError("build in progress")
        out = fn()
        if self.build_running():
            raise EngineBusyError(
                "build started during the search; retry")
        return out

    @contextmanager
    def engine_guard(self):
        """Short-lived engine serialization for request handlers.

        The build worker holds `lock` for the whole (possibly minutes-
        long) build; request handlers must not block behind it — they
        fail fast with 409 'build in progress' instead, keeping the UI
        responsive (round-1 advisor finding: every endpoint used to hang
        for the duration of a build)."""
        if self.build_running():
            raise EngineBusyError("build in progress")
        if not self.lock.acquire(timeout=5):
            # distinct message: no build is running — another request
            # (e.g. a first, un-warmed detect paying its jit compile)
            # holds the engine
            raise EngineBusyError(
                "engine busy with another request; retry shortly")
        try:
            yield
        finally:
            self.lock.release()


def _seed_of(body: dict):
    """Validated `seed` field: an int or absent. A float/string seed
    would raise TypeError inside np.random.default_rng — a 500 — when
    it is a caller error (400)."""
    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool)
                             or not isinstance(seed, int)):
        raise ValueError("seed must be an integer")
    return seed


def _img_to_b64(pil_img) -> Optional[str]:
    if pil_img is None:
        return None
    buf = io.BytesIO()
    pil_img.save(buf, format="JPEG", quality=85)
    return base64.b64encode(buf.getvalue()).decode()


def _result_json(items) -> list:
    """Engine result items -> the JSON shape every search endpoint
    returns. `id` is the stored point id — the SPA feeds it back into
    /api/query/recommend ("more like this")."""
    return [{
        "id": it.get("id"), "filename": it["filename"],
        "score": it["score"], "bbox": it["bbox"],
        "image": _img_to_b64(it["image"]),
    } for it in items]


def _b64_to_pil(data: str):
    from PIL import Image
    return Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")


def make_handler(state: UIState):
    engine = state.engine

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            log.debug(fmt % args)

        # -- plumbing ---------------------------------------------------
        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj: Any, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            return json.loads(self.rfile.read(n))

        # -- routes ------------------------------------------------------
        def do_GET(self):
            path = urlparse(self.path).path
            if path in ("/", "/index.html"):
                self._send(200, INDEX_HTML.encode(), "text/html; charset=utf-8")
            elif path == "/api/databases":
                # lock-free: pure directory listing + attribute read, and
                # the SPA fetches this on load — it must answer even while
                # a build holds the engine lock for minutes.
                self._json({"databases": engine.list_databases(),
                            "current": engine.current_database})
            elif path == "/api/build/status":
                job = state.build
                if job is None:
                    self._json({"state": "idle"})
                else:
                    self._json({
                        "state": "error" if job.error else
                                 ("done" if job.done else "running"),
                        "progress": job.progress,
                        "transcript": job.transcript,
                        "error": job.error,
                    })
            elif path == "/api/stats":
                # serving telemetry; never instantiates a searcher just
                # to report on one (None until the first batched search)
                searcher = engine._searcher
                self._json({
                    "search": searcher.stats() if searcher else None,
                    "build_running": state.build_running(),
                    "database": engine.current_database,
                })
            elif path == "/api/about":
                self._json({"name": "Reverso-TPU",
                            "model": engine.config.model.name,
                            "backend": _backend_name(engine)})
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            path = urlparse(self.path).path
            try:
                body = self._read_json()
            except Exception as e:
                self._json({"error": f"bad json: {e}"}, 400)
                return
            try:
                handler = {
                    "/api/build": self._build,
                    "/api/build/stop": self._stop,
                    "/api/db/load": self._db_load,
                    "/api/db/delete": self._db_delete,
                    "/api/db/unlock": self._db_unlock,
                    "/api/query/detect": self._detect,
                    "/api/query/visualize": self._visualize,
                    "/api/query/search": self._search,
                    "/api/query/search_text": self._search_text,
                    "/api/query/recommend": self._recommend,
                    "/api/query/discover": self._discover,
                    "/api/query/search_groups": self._search_groups,
                    "/api/points": self._points,
                    "/api/query/universal": self._query,
                    "/api/query/groups": self._query_groups,
                    "/api/query/batch": self._query_batch,
                    "/api/query/matrix": self._matrix,
                    "/api/points/facet": self._facet,
                    "/api/points/get": self._retrieve,
                    "/api/video/local": self._video_local,
                    "/api/video/urls": self._video_urls,
                }.get(path)
                if handler is None:
                    self._json({"error": "not found"}, 404)
                    return
                handler(body)
            except EngineBusyError as e:
                self._json({"error": str(e)}, 409)
            except FilterError as e:
                # malformed payload-filter spec: caller error, not a bug
                self._json({"error": f"bad filter: {e}"}, 400)
            except StoreError as e:
                # e.g. scroll/recommend before any database is loaded
                self._json({"error": str(e)}, 400)
            except ValueError as e:
                # malformed query shape (bad fusion name, query+fusion
                # together, empty query): caller error, not a bug
                self._json({"error": str(e)}, 400)
            except OverloadedError as e:
                # the batcher's explicit load-shed signal: a retryable
                # 429, NOT a server bug — no stack trace in the log
                self._json({"error": str(e), "retry": True}, 429)
            except Exception as e:
                log.exception("request failed")
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        # -- build -------------------------------------------------------
        def _build(self, body: dict) -> None:
            with state.build_admission:
                if state.build is not None and not state.build.done \
                        and state.build.error is None:
                    self._json({"error": "a build is already running"}, 409)
                    return
                job = BuildJob()
                state.build = job

            def progress_cb(msg, p):
                if p is not None:
                    job.progress = float(p)

            def run():
                try:
                    with state.lock:
                        job.transcript = engine.create_database(
                            body["folder"], body["name"],
                            text_prompt=body.get("prompt", "person . car . building"),
                            use_direct_pe=bool(body.get("direct_pe", False)),
                            resume_from_checkpoint=bool(body.get("resume", False)),
                            include_subfolders=bool(body.get("subfolders", False)),
                            progress_callback=progress_cb)
                except Exception as e:
                    job.error = f"{type(e).__name__}: {e}"
                finally:
                    job.done = True

            job.thread = threading.Thread(target=run, daemon=True)
            job.thread.start()
            self._json({"started": True})

        def _stop(self, body: dict) -> None:
            engine.request_stop()
            self._json({"stopping": True})

        # -- db management ----------------------------------------------
        def _db_load(self, body: dict) -> None:
            with state.engine_guard():
                self._json({"message": engine.load_database(body.get("name", ""))})

        def _db_delete(self, body: dict) -> None:
            with state.engine_guard():
                self._json({"message": engine.delete_database(body.get("name", ""))})

        def _db_unlock(self, body: dict) -> None:
            with state.engine_guard():
                self._json({"message": engine.unlock_database(body.get("name", ""))})

        # -- query -------------------------------------------------------
        def _detect(self, body: dict) -> None:
            img = _b64_to_pil(body["image"])
            with state.engine_guard():
                if body.get("direct_pe", False):
                    _, metas = engine.process_image_direct_pe(img)
                    regions = []
                else:
                    n = engine.detect_regions(img, body.get("prompt") or None)
                    _, metas = engine.extract_embeddings(img)
                    regions = [
                        {"index": i,
                         "label": f"Region {i + 1}: {m['detected_class']} "
                                  f"({m['confidence']:.2f})"}
                        for i, m in enumerate(metas)]
                viz = engine.visualize_detections(img)
                # capture this request's query state; searches present the
                # token instead of relying on the shared engine singleton
                token = state.put_session(QuerySession(
                    engine.detected_regions, engine.region_embeddings,
                    engine.region_metadata_list))
            self._json({"num_regions": len(metas), "regions": regions,
                        "token": token,
                        "visualization": _img_to_b64(viz)})

        def _visualize(self, body: dict) -> None:
            """Re-render detections highlighting the selected region
            (reference ui.py:216-232 update_region_visualization_ui)."""
            img = _b64_to_pil(body["image"])
            sel = body.get("region_index")
            sel = None if sel is None else int(sel)

            def to_detection_index(metas):
                # the UI select is indexed over METAS (empty-mask
                # detections are skipped there), but the visualizer
                # indexes the full detection set — map through the
                # payload's detection_index so the highlighted region
                # is the one actually searched
                if sel is None or not metas or not 0 <= sel < len(metas):
                    return sel
                return int(metas[sel].get("detection_index", sel))

            sess = state.get_session(body.get("token"))
            if sess is not None:
                # pure host-side drawing on session state; no engine lock
                viz = engine.visualize_detections(
                    img, to_detection_index(sess.metadata),
                    regions=sess.regions)
            else:
                with state.engine_guard():
                    viz = engine.visualize_detections(
                        img, to_detection_index(engine.region_metadata_list))
            self._json({"visualization": _img_to_b64(viz)})

        def _search(self, body: dict) -> None:
            sess = state.get_session(body.get("token"))
            if sess is not None:
                # stateless + coalescing: concurrent searches share device
                # launches via the batching searcher; builds still 409
                # (checked before AND after — see check_no_build_overlap)
                text, items = state.check_no_build_overlap(
                    lambda: engine.search_similar(
                        body.get("threshold"), body.get("max_results"),
                        query_index=int(body.get("region_index", 0)),
                        embeddings=sess.embeddings, use_batcher=True,
                        filter=body.get("filter") or None))
            else:
                with state.engine_guard():
                    text, items = engine.search_similar(
                        body.get("threshold"), body.get("max_results"),
                        query_index=int(body.get("region_index", 0)),
                        filter=body.get("filter") or None)
            self._json({"summary": text, "results": _result_json(items)})

        def _recommend(self, body: dict) -> None:
            """Search by stored point ids (qdrant recommend). Stateless
            read over store + index; the average strategy coalesces with
            in-flight searches via the batcher."""
            pos = [int(i) for i in body.get("positive") or []]
            neg = [int(i) for i in body.get("negative") or []]
            text, items = state.check_no_build_overlap(
                lambda: engine.recommend(
                    pos, neg or None, body.get("max_results"),
                    body.get("threshold"),
                    strategy=body.get("strategy") or "average",
                    filter=body.get("filter") or None,
                    use_batcher=True))
            self._json({"summary": text, "results": _result_json(items)})

        def _discover(self, body: dict) -> None:
            """Discovery search: a target point steered by (positive,
            negative) context pairs (qdrant discover). Stateless read
            over store + index."""
            target = body.get("target")
            if target is not None:
                target = int(target)
            pairs = [(int(p), int(n)) for p, n in body.get("pairs") or []]
            text, items = state.check_no_build_overlap(
                lambda: engine.discover(
                    target, pairs or None, body.get("max_results"),
                    filter=body.get("filter") or None))
            self._json({"summary": text, "results": _result_json(items)})

        def _search_groups(self, body: dict) -> None:
            """Grouped similarity search (qdrant search_groups): results
            bucketed by a payload key, each bucket reporting its best
            few hits."""
            sess = state.get_session(body.get("token"))
            kwargs = dict(
                group_by=body.get("group_by") or "filename",
                group_size=int(body.get("group_size") or 3),
                filter=body.get("filter") or None)
            if sess is not None:
                text, groups = state.check_no_build_overlap(
                    lambda: engine.search_groups(
                        body.get("threshold"), body.get("max_results"),
                        query_index=int(body.get("region_index", 0)),
                        embeddings=sess.embeddings, **kwargs))
            else:
                with state.engine_guard():
                    text, groups = engine.search_groups(
                        body.get("threshold"), body.get("max_results"),
                        query_index=int(body.get("region_index", 0)),
                        **kwargs)
            self._json({"summary": text,
                        "groups": [{"key": g["key"],
                                    "results": _result_json(g["hits"])}
                                   for g in groups]})

        def _points(self, body: dict) -> None:
            """Page through the loaded database's points (qdrant scroll).
            With `order_by`, `offset`/`next_offset` are [value, id]
            tokens instead of row ids."""
            order_by = body.get("order_by") or None
            offset = body.get("offset") or 0
            if order_by and offset:
                if not isinstance(offset, (list, tuple)) or \
                        len(offset) != 2:
                    raise ValueError(
                        "with order_by, offset is the [value, id] "
                        "token the previous page returned")
                offset = (float(offset[0]), int(offset[1]))
            elif not order_by:
                offset = int(offset)
            points, next_offset = state.check_no_build_overlap(
                lambda: engine.scroll(
                    body.get("filter") or None,
                    offset=offset,
                    limit=int(body.get("limit") or 50),
                    order_by=order_by,
                    direction=body.get("direction") or "asc"))
            if order_by and next_offset is not None:
                next_offset = list(next_offset)
            self._json({"points": points, "next_offset": next_offset})

        def _query(self, body: dict) -> None:
            """Universal query: prefetch + fusion / exact rescore
            (qdrant query_points role)."""
            target = body.get("target")
            if isinstance(target, float):
                target = int(target)
            hits = state.check_no_build_overlap(
                lambda: engine.query(
                    target, prefetch=body.get("prefetch") or None,
                    fusion=body.get("fusion") or None,
                    k=body.get("max_results"),
                    filter=body.get("filter") or None,
                    seed=_seed_of(body),
                    using=str(body.get("using") or ""),
                    lookup_from=body.get("lookup_from") or None,
                    use_batcher=True))
            self._json({"hits": hits})

        def _query_groups(self, body: dict) -> None:
            """Grouped universal query (qdrant query_points_groups):
            any universal-query shape bucketed by a payload key."""
            target = body.get("target")
            if isinstance(target, float):
                target = int(target)
            groups = state.check_no_build_overlap(
                lambda: engine.query_groups(
                    target, group_by=str(body.get("group_by") or ""),
                    prefetch=body.get("prefetch") or None,
                    fusion=body.get("fusion") or None,
                    group_size=int(body.get("group_size") or 3),
                    limit=body.get("max_results"),
                    filter=body.get("filter") or None,
                    seed=_seed_of(body),
                    using=str(body.get("using") or ""),
                    lookup_from=body.get("lookup_from") or None,
                    with_lookup=body.get("with_lookup") or None))
            self._json({"groups": groups})

        def _query_batch(self, body: dict) -> None:
            """Several universal queries in one call (qdrant
            query_batch_points role); plain same-filter requests share
            one device launch."""
            results = state.check_no_build_overlap(
                lambda: engine.query_batch(body.get("requests") or []))
            self._json({"results": results})

        def _matrix(self, body: dict) -> None:
            """Pairwise similarity over a random sample of points
            (qdrant search_matrix_pairs / offsets role)."""
            offsets = bool(body.get("offsets"))
            # explicit None checks: `or default` would silently remap
            # sample=0 / limit=0 to the defaults instead of the 400 the
            # engine's range validation produces
            sample = body.get("sample")
            limit = body.get("limit")
            out = state.check_no_build_overlap(
                lambda: engine.search_matrix(
                    sample=10 if sample is None else int(sample),
                    limit=3 if limit is None else int(limit),
                    filter=body.get("filter") or None,
                    seed=_seed_of(body),
                    offsets=offsets))
            self._json(out if offsets else {"pairs": out})

        def _facet(self, body: dict) -> None:
            """Value histogram of one payload key (qdrant facet API)."""
            rows = state.check_no_build_overlap(
                lambda: engine.facet(
                    body.get("key", ""), body.get("filter") or None,
                    limit=int(body.get("limit") or 10)))
            self._json({"key": body.get("key", ""), "facets": rows})

        def _retrieve(self, body: dict) -> None:
            """Fetch points by row id / region_id (qdrant retrieve)."""
            ids = [int(i) if isinstance(i, (int, float)) else str(i)
                   for i in (body.get("ids") or [])]
            points = state.check_no_build_overlap(
                lambda: engine.retrieve(ids))
            self._json({"points": points})

        def _search_text(self, body: dict) -> None:
            # stateless: never clobbers another session's query state;
            # the device launch coalesces with concurrent searches
            text, items = state.check_no_build_overlap(
                lambda: engine.search_by_text(
                    body.get("text", ""), body.get("threshold"),
                    body.get("max_results"), stateless=True,
                    use_batcher=True,
                    filter=body.get("filter") or None))
            self._json({"summary": text, "results": _result_json(items)})

        # -- video -------------------------------------------------------
        def _video_local(self, body: dict) -> None:
            from ..ingest.video import process_local_videos_with_progress
            msg = process_local_videos_with_progress(
                body.get("input_folder", ""), body.get("output_folder", ""),
                float(body.get("fps", 2)), float(body.get("threshold", 30)))
            self._json({"message": msg})

        def _video_urls(self, body: dict) -> None:
            from ..ingest.video import extract_frames_with_progress
            msg = extract_frames_with_progress(
                body.get("urls", ""), body.get("output_folder", ""),
                fps=float(body.get("fps", 2)),
                thresh=float(body.get("threshold", 30)),
                qual=body.get("quality", "720p"))
            self._json({"message": msg})

    return Handler


def _backend_name(engine) -> str:
    """The engine's torch device type ("cuda" or "cpu"), read off the
    engine itself."""
    device = getattr(engine, "device", None)
    return getattr(device, "type", None) or "unknown"


def create_server(engine, host: str = "127.0.0.1", port: int = 7860) -> ThreadingHTTPServer:
    state = UIState(engine)
    return ThreadingHTTPServer((host, port), make_handler(state))


def serve(engine, host: str = "127.0.0.1", port: int = 7860) -> None:
    server = create_server(engine, host, port)
    log.info(f"Reverso-TPU UI at http://{host}:{server.server_address[1]}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


# ---------------------------------------------------------------------------
# Single-page app (the reference's 5 tabs, ui.py:245-408)
# ---------------------------------------------------------------------------

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Revers-o TPU</title>
<style>
body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1a202c}
header{background:#1a202c;color:#fff;padding:14px 24px;font-size:20px}
nav{display:flex;gap:4px;background:#fff;border-bottom:1px solid #e2e8f0;padding:0 16px}
nav button{border:0;background:none;padding:12px 16px;cursor:pointer;font-size:14px;border-bottom:2px solid transparent}
nav button.active{border-color:#3182ce;color:#3182ce;font-weight:600}
main{padding:24px;max-width:980px;margin:0 auto}
.tab{display:none}.tab.active{display:block}
label{display:block;margin:10px 0 4px;font-size:13px;color:#4a5568}
input[type=text],textarea,select{width:100%;padding:8px;border:1px solid #cbd5e0;border-radius:6px;box-sizing:border-box}
button.primary{background:#3182ce;color:#fff;border:0;border-radius:6px;padding:10px 18px;margin-top:12px;cursor:pointer}
button.danger{background:#e53e3e;color:#fff;border:0;border-radius:6px;padding:10px 18px;margin-top:12px;cursor:pointer}
pre{background:#1a202c;color:#e2e8f0;padding:12px;border-radius:6px;white-space:pre-wrap;max-height:320px;overflow:auto}
.row{display:flex;gap:16px}.row>*{flex:1}
.grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(180px,1fr));gap:12px;margin-top:12px}
.grid img{width:100%;border-radius:6px;border:1px solid #e2e8f0}
progress{width:100%;height:10px}
img.viz{max-width:100%;border-radius:6px;margin-top:12px}
</style></head><body>
<header>🔍 Revers-o TPU — Visual Investigation Engine</header>
<nav>
<button data-tab="video" class="active">🎬 Extract Video Frames</button>
<button data-tab="build">🗃️ Create Database</button>
<button data-tab="search">🔎 Search Similar</button>
<button data-tab="manage">⚙️ Database Management</button>
<button data-tab="about">ℹ️ About</button>
</nav>
<main>

<div class="tab active" id="tab-video">
<h2>Extract Frames from Videos</h2>
<div class="row"><div>
<h3>🔗 From URLs</h3>
<label>Video URLs (comma or newline separated)</label><textarea id="v-urls" rows="3"></textarea>
<label>Output Folder</label><input type="text" id="v-url-out">
<div class="row">
<div><label>Frames per Scene</label><input type="text" id="v-url-fps" value="2"></div>
<div><label>Scene Threshold</label><input type="text" id="v-url-thresh" value="30"></div>
<div><label>Max Quality</label><select id="v-url-qual"><option>360p</option><option>480p</option><option selected>720p</option><option>1080p</option><option>best</option></select></div>
</div>
<button class="primary" onclick="videoUrls()">🎬 Extract from URLs</button>
</div><div>
<h3>📁 From Local Files</h3>
<label>Video Folder Path</label><input type="text" id="v-local-in">
<label>Output Folder</label><input type="text" id="v-local-out">
<div class="row">
<div><label>Frames per Scene</label><input type="text" id="v-local-fps" value="2"></div>
<div><label>Scene Threshold</label><input type="text" id="v-local-thresh" value="30"></div>
</div>
<button class="primary" onclick="videoLocal()">🎬 Extract from Local Videos</button>
</div></div>
<pre id="v-status">Ready.</pre>
</div>

<div class="tab" id="tab-build">
<h2>Build a searchable database from your images</h2>
<label>📁 Image Folder Path</label><input type="text" id="b-folder">
<label>🏷️ Database Name</label><input type="text" id="b-name">
<label>🎯 Detection Prompts (period-separated, e.g. 'car . building')</label>
<input type="text" id="b-prompt" value="person . car . building">
<div class="row">
<div><label><input type="checkbox" id="b-direct"> 🔍 Direct PE (no detection, faster)</label></div>
<div><label><input type="checkbox" id="b-resume"> 🔄 Resume from checkpoint</label></div>
<div><label><input type="checkbox" id="b-sub"> 📂 Include subfolders</label></div>
</div>
<button class="primary" onclick="buildDb()">🚀 Build Database</button>
<button class="danger" onclick="stopBuild()">⏸️ Stop Processing</button>
<progress id="b-progress" value="0" max="1"></progress>
<pre id="b-status">Idle.</pre>
</div>

<div class="tab" id="tab-search">
<h2>Search for similar regions in your database</h2>
<label>Upload Query Image</label><input type="file" id="s-file" accept="image/*">
<label>Detection Prompt</label><input type="text" id="s-prompt" value="person . car . building">
<label><input type="checkbox" id="s-direct"> Use Direct PE for Query Image</label>
<button class="primary" onclick="detectQuery()">🔎 Detect Regions / Process Query</button>
<img id="s-viz" class="viz" style="display:none">
<label>Select Query Region</label><select id="s-region"></select>
<div class="row">
<div><label>🎚️ Similarity Threshold</label><input type="text" id="s-thresh" value="0.7"></div>
<div><label>📊 Max Results</label><select id="s-max"><option>3</option><option selected>5</option><option>10</option><option>20</option><option>50</option></select></div>
</div>
<label>🧮 Payload filter (optional: key=value, key!=value, key&gt;=N — comma-separated)</label>
<input type="text" id="s-filter" placeholder="detected_class=person, confidence>=0.5">
<div class="row">
<div><label>🗂️ Group by payload key (optional — max results counts groups)</label><input type="text" id="s-group" placeholder="filename"></div>
<div><label>Hits per group</label><select id="s-group-size"><option>1</option><option>2</option><option selected>3</option><option>5</option></select></div>
</div>
<button class="primary" onclick="searchDb()">🎯 Search Database</button>
<h3>…or search by description</h3>
<label>📝 Text query (needs the CLIP/PE text tower configured)</label>
<input type="text" id="s-text" placeholder="a red car at night">
<div><label>🎚️ Text Threshold (text-image scores peak ~0.2-0.35)</label>
<input type="text" id="s-text-thresh" value=""></div>
<button class="primary" onclick="searchByText()">🔤 Search by Text</button>
<h3>…or recommend by stored point ids</h3>
<div class="row">
<div><label>➕ Positive ids (comma-separated)</label><input type="text" id="s-rec-pos" placeholder="12, 40"></div>
<div><label>➖ Negative ids (optional)</label><input type="text" id="s-rec-neg" placeholder="7"></div>
<div><label>Strategy</label><select id="s-rec-strat"><option selected>average</option><option>best_score</option></select></div>
</div>
<button class="primary" onclick="recommendByIds()">✨ Recommend</button>
<h3>…or discover with context pairs</h3>
<div class="row">
<div><label>🎯 Target point id (optional)</label><input type="text" id="s-disc-target" placeholder="12"></div>
<div><label>↔️ Context pairs pos:neg (comma-separated)</label><input type="text" id="s-disc-pairs" placeholder="40:7, 3:9"></div>
</div>
<button class="primary" onclick="discoverByIds()">🧭 Discover</button>
<pre id="s-summary">No search yet.</pre>
<div class="grid" id="s-results"></div>
</div>

<div class="tab" id="tab-manage">
<h2>Manage your databases</h2>
<label>Select Database</label><select id="m-db"></select>
<button class="primary" onclick="dbOp('load')">📂 Load</button>
<button class="danger" onclick="dbOp('delete')">🗑️ Delete</button>
<button class="primary" onclick="dbOp('unlock')">🔓 Unlock</button>
<button class="primary" onclick="reloadDbs()">🔄 Reload List</button>
<pre id="m-status">-</pre>
<h3>Browse points (loaded database)</h3>
<div class="row">
<div><label>🧮 Payload filter (optional)</label><input type="text" id="m-pts-filter" placeholder="detected_class=person"></div>
<div><label>Page size</label><select id="m-pts-limit"><option>10</option><option selected>25</option><option>50</option><option>100</option></select></div>
<div><label>↕️ Order by (numeric key, optional)</label><input type="text" id="m-pts-order" placeholder="confidence"></div>
<div><label>Direction</label><select id="m-pts-dir"><option value="asc" selected>asc</option><option value="desc">desc</option></select></div>
</div>
<button class="primary" onclick="browsePoints(0)">📋 Browse</button>
<button class="primary" id="m-pts-next" style="display:none" onclick="browsePoints(nextPointsOffset)">⏭️ Next page</button>
<pre id="m-points">-</pre>
<h3>Facet (payload value counts)</h3>
<div class="row">
<div><label>Payload key</label><input type="text" id="m-facet-key" placeholder="detected_class"></div>
<div><label>🧮 Filter (optional)</label><input type="text" id="m-facet-filter" placeholder="confidence>=0.5"></div>
</div>
<button class="primary" onclick="loadFacet()">📊 Count values</button>
<pre id="m-facet">-</pre>
</div>

<div class="tab" id="tab-about">
<h2>About</h2>
<pre id="a-info">loading…</pre>
<h3>Serving stats</h3>
<button class="primary" onclick="loadStats()">🔄 Refresh stats</button>
<pre id="a-stats">-</pre>
<p>TPU-native rebuild of the Revers-o visual investigation tool:
prompt-conditioned region detection, Perception-Encoder embeddings, and a
sharded on-device exact cosine search engine (JAX / XLA / Pallas).</p>
</div>

</main>
<script>
const $=id=>document.getElementById(id);
document.querySelectorAll('nav button').forEach(b=>b.onclick=()=>{
  document.querySelectorAll('nav button').forEach(x=>x.classList.remove('active'));
  document.querySelectorAll('.tab').forEach(x=>x.classList.remove('active'));
  b.classList.add('active'); $('tab-'+b.dataset.tab).classList.add('active');
});
async function api(path, body){
  const r = await fetch(path, body===undefined?{}:{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
  return r.json();
}
async function videoUrls(){
  $('v-status').textContent='Working…';
  const r = await api('/api/video/urls',{urls:$('v-urls').value,output_folder:$('v-url-out').value,fps:+$('v-url-fps').value,threshold:+$('v-url-thresh').value,quality:$('v-url-qual').value});
  $('v-status').textContent=r.message||JSON.stringify(r);
}
async function videoLocal(){
  $('v-status').textContent='Working…';
  const r = await api('/api/video/local',{input_folder:$('v-local-in').value,output_folder:$('v-local-out').value,fps:+$('v-local-fps').value,threshold:+$('v-local-thresh').value});
  $('v-status').textContent=r.message||JSON.stringify(r);
}
let pollTimer=null;
async function buildDb(){
  const r = await api('/api/build',{folder:$('b-folder').value,name:$('b-name').value,prompt:$('b-prompt').value,direct_pe:$('b-direct').checked,resume:$('b-resume').checked,subfolders:$('b-sub').checked});
  if(r.error){$('b-status').textContent=r.error;return;}
  pollTimer=setInterval(async()=>{
    const s = await api('/api/build/status');
    $('b-progress').value=s.progress||0;
    $('b-status').textContent=s.transcript||s.state;
    if(s.state==='done'||s.state==='error'){clearInterval(pollTimer);reloadDbs();}
  },1000);
}
async function stopBuild(){await api('/api/build/stop',{});}
let queryReady=false;
function fileToB64(f){return new Promise(res=>{const r=new FileReader();r.onload=()=>res(r.result.split(',')[1]);r.readAsDataURL(f);});}
let lastQueryB64=null;
let queryToken=null;
async function detectQuery(){
  const f=$('s-file').files[0]; if(!f){alert('choose an image');return;}
  const img=await fileToB64(f);
  lastQueryB64=img;
  const r=await api('/api/query/detect',{image:img,prompt:$('s-prompt').value,direct_pe:$('s-direct').checked});
  if(r.error){$('s-summary').textContent=r.error;return;}
  queryReady=true;
  queryToken=r.token||null;
  if(r.visualization){$('s-viz').src='data:image/jpeg;base64,'+r.visualization;$('s-viz').style.display='block';}
  const sel=$('s-region');sel.innerHTML='';
  (r.regions.length?r.regions:[{index:0,label:'Full image'}]).forEach(o=>{
    const e=document.createElement('option');e.value=o.index;e.textContent=o.label;sel.appendChild(e);});
  $('s-summary').textContent='Found '+r.num_regions+' region(s). Ready to search.';
}
$('s-region').onchange=async()=>{
  if(!lastQueryB64)return;
  const r=await api('/api/query/visualize',{image:lastQueryB64,token:queryToken,region_index:+$('s-region').value||0});
  if(r.visualization){$('s-viz').src='data:image/jpeg;base64,'+r.visualization;$('s-viz').style.display='block';}
};
function renderResults(r){
  if(r.error){$('s-summary').textContent=r.error;return;}
  $('s-summary').textContent=r.summary;
  const g=$('s-results');g.innerHTML='';
  (r.groups||[]).forEach(grp=>{
    const h=document.createElement('div');
    h.style.cssText='grid-column:1/-1;font-weight:bold;margin-top:8px';
    h.textContent='🗂️ '+grp.key;
    g.appendChild(h);
    renderHits(g, grp.results);
  });
  renderHits(g, r.results);
}
function renderHits(g, items){
  (items||[]).forEach(it=>{
    const d=document.createElement('div');
    if(it.image){const i=document.createElement('img');i.src='data:image/jpeg;base64,'+it.image;d.appendChild(i);}
    const c=document.createElement('div');
    c.textContent=(it.id!=null?'#'+it.id+' ':'')+it.filename+' — '+it.score.toFixed(3);
    d.appendChild(c);
    if(it.id!=null){
      const m=document.createElement('button');
      m.textContent='✨ more like this';
      m.style.cssText='margin-top:4px;font-size:12px;cursor:pointer';
      m.onclick=()=>{$('s-rec-pos').value=String(it.id);recommendByIds();};
      d.appendChild(m);
    }
    g.appendChild(d);});
}
async function searchDb(){
  if(!queryReady){alert('detect/process a query image first');return;}
  const base={token:queryToken,threshold:+$('s-thresh').value,max_results:+$('s-max').value,region_index:+$('s-region').value||0,filter:$('s-filter').value.trim()};
  const grp=$('s-group').value.trim();
  if(grp){renderResults(await api('/api/query/search_groups',{...base,group_by:grp,group_size:+$('s-group-size').value}));return;}
  renderResults(await api('/api/query/search',base));
}
async function searchByText(){
  const txt=$('s-text').value;
  if(!txt){alert('enter a description');return;}
  const tt=$('s-text-thresh').value.trim();
  renderResults(await api('/api/query/search_text',{text:txt,threshold:tt?+tt:null,max_results:+$('s-max').value,filter:$('s-filter').value.trim()}));
}
function parseIds(s){return s.split(/[\\s,]+/).filter(x=>x).map(Number).filter(Number.isInteger);}
async function recommendByIds(){
  const pos=parseIds($('s-rec-pos').value);
  if(!pos.length){alert('enter at least one positive point id');return;}
  renderResults(await api('/api/query/recommend',{positive:pos,negative:parseIds($('s-rec-neg').value),strategy:$('s-rec-strat').value,max_results:+$('s-max').value,filter:$('s-filter').value.trim()}));
}
async function discoverByIds(){
  const t=$('s-disc-target').value.trim();
  const pairs=$('s-disc-pairs').value.split(',').map(s=>s.trim()).filter(s=>s)
    .map(s=>s.split(':').map(Number)).filter(p=>p.length===2&&p.every(Number.isInteger));
  if(!t&&!pairs.length){alert('enter a target id and/or pos:neg pairs');return;}
  renderResults(await api('/api/query/discover',{target:t?+t:null,pairs:pairs,max_results:+$('s-max').value,filter:$('s-filter').value.trim()}));
}
async function reloadDbs(){
  const r=await api('/api/databases');
  const sel=$('m-db');sel.innerHTML='';
  r.databases.forEach(n=>{const e=document.createElement('option');e.value=n;e.textContent=n+(n===r.current?' (loaded)':'');sel.appendChild(e);});
}
async function dbOp(op){
  const r=await api('/api/db/'+op,{name:$('m-db').value});
  $('m-status').textContent=r.message||JSON.stringify(r);
  reloadDbs();
}
let nextPointsOffset=0;
async function browsePoints(offset){
  const order=$('m-pts-order').value.trim();
  const body={filter:$('m-pts-filter').value.trim(),offset:offset||0,limit:+$('m-pts-limit').value};
  if(order){body.order_by=order;body.direction=$('m-pts-dir').value;}
  const r=await api('/api/points',body);
  if(r.error){$('m-points').textContent=r.error;return;}
  $('m-points').textContent=(r.points||[]).map(p=>'#'+p.id+'  '+JSON.stringify(p.payload)).join('\\n')||'(no points)';
  nextPointsOffset=r.next_offset;
  $('m-pts-next').style.display=r.next_offset==null?'none':'inline-block';
}
async function loadFacet(){
  const r=await api('/api/points/facet',{key:$('m-facet-key').value.trim(),filter:$('m-facet-filter').value.trim(),limit:50});
  if(r.error){$('m-facet').textContent=r.error;return;}
  $('m-facet').textContent=(r.facets||[]).map(f=>f.count+'\\t'+f.value).join('\\n')||'(no values)';
}
async function loadStats(){
  const r=await api('/api/stats');
  $('a-stats').textContent=JSON.stringify(r,null,2);
}
api('/api/about').then(r=>$('a-info').textContent=JSON.stringify(r,null,2));
reloadDbs();
</script>
</body></html>
"""
