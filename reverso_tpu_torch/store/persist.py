"""Host-side persistence for embedding databases.

Replaces the reference's embedded qdrant-client local mode
(reference core_system.py:100,521,600-622): one directory per database
under a root, holding

    <root>/<name>/
        meta.json       collection metadata (name, dim, count, dtype,
                        named vector spaces)
        vectors.bin     raw little-endian fp32 [N, d], append-only
        vectors_<s>.bin one per NAMED vector space `s` (qdrant named
                        vectors): same row count, own dim
        payloads.jsonl  one JSON payload per row, append-only
        .lock           advisory lock (reference `unlock_database`,
                        core_system.py:137-154)

The append-only binary layout supports cheap resume (truncate to a row
count), zero-copy memmap reads, and a future C++ loader. Collection
naming keeps the reference convention `simple_reverso_<name>` with the
legacy bare-name fallback (core_system.py:95-107).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional, Sequence

import numpy as np

META_FILE = "meta.json"
VEC_FILE = "vectors.bin"
# extra NAMED vector spaces (qdrant named vectors): one sibling file
# per space, same row count as the default space, own dim
VEC_NAMED_FMT = "vectors_{}.bin"
# RAGGED vector spaces — per space, an append-only entry log of
# fixed-size records plus an int64 indptr sidecar (entry i = cumulative
# record count at the END of row i, appended in lockstep — the
# payloads.idx pattern). Row r's records are [indptr[r-1], indptr[r])
# in the log; rows may be empty. Two kinds share this layout:
#   SPARSE (qdrant sparse vectors): record = (u32 index, f32 value)
#   MULTI  (qdrant multivectors):   record = one [d] f32 sub-vector
SPARSE_FMT = "sparse_{}.bin"
SPARSE_IDX_FMT = "sparse_{}.idx"
SPARSE_ENTRY = np.dtype([("i", "<u4"), ("v", "<f4")])
MULTI_FMT = "multi_{}.bin"
MULTI_IDX_FMT = "multi_{}.idx"
PAYLOAD_FILE = "payloads.jsonl"
# Sidecar of int64-LE byte offsets, entry i = start of payload line i in
# payloads.jsonl, appended in lockstep with it. Makes the first-query
# payload join O(k) seeks with a COLD cache (the offset table is a
# memmap read, not an O(N) scan of the whole JSONL — which at 100M rows
# costs tens of seconds per process). Legacy stores without one are
# scanned once and upgraded in place.
PAYLOAD_IDX_FILE = "payloads.idx"
COMPACT_MARKER = "compact.commit"
VEC_PATCH = "vectors.patch"
# per-point DENSE vector deletions (qdrant delete_vectors): {space:
# [row ids]} — dense rows are fixed-width so the bytes stay in place
# and this small mask file marks them absent (searches exclude them,
# has_vector reports False). Sparse/multivector deletions need no mask:
# their ragged rows are rewritten empty. Always rewritten atomically
# (tmp+fsync+rename); ids are clipped to [0, count) on read so
# truncate/compact never leave it pointing at ghost rows.
DELETED_FILE = "deleted_vectors.json"
LOCK_FILE = ".lock"
COLLECTION_PREFIX = "simple_reverso_"   # reference core_system.py:101,597


class StoreError(RuntimeError):
    pass


class StoreLockedError(StoreError):
    pass


_SPACE_RE = re.compile(r"^[A-Za-z0-9_\-]{1,64}$")


def vec_file(space: str = "") -> str:
    """On-disk file for a vector space: the default (unnamed) space is
    vectors.bin; each named space is a sibling vectors_<name>.bin."""
    return VEC_FILE if not space else VEC_NAMED_FMT.format(space)


def _check_spaces(named: dict) -> dict:
    out = {}
    for n, d in (named or {}).items():
        if not isinstance(n, str) or not _SPACE_RE.match(n):
            raise StoreError(f"bad vector space name: {n!r} "
                             f"(letters/digits/_/- only)")
        d = int(d)
        if d <= 0:
            raise StoreError(f"bad dim for vector space {n!r}: {d}")
        out[n] = d
    return out


def _check_sparse_spaces(sparse, taken) -> dict:
    """Validate sparse space declarations -> {name: params dict}.
    Accepts a {name: params} dict or an iterable of names; params are
    an open bag (reserved for modifiers like idf), kept in meta."""
    out = {}
    if sparse is None:
        return out
    items = (sparse.items() if isinstance(sparse, dict)
             else [(n, {}) for n in sparse])
    for n, params in items:
        if not isinstance(n, str) or not _SPACE_RE.match(n):
            raise StoreError(f"bad sparse space name: {n!r} "
                             f"(letters/digits/_/- only)")
        if n in taken or n == "":
            raise StoreError(
                f"sparse space {n!r} collides with another vector space")
        out[n] = dict(params) if isinstance(params, dict) else {}
    return out


def _check_multi_spaces(multi, taken) -> dict:
    """Validate multivector space declarations -> {name: dim}
    (qdrant multivectors: each point holds a variable-length [T, dim]
    matrix of sub-vectors, compared by max-sim)."""
    out = {}
    for n, d in (multi or {}).items():
        if not isinstance(n, str) or not _SPACE_RE.match(n):
            raise StoreError(f"bad multivector space name: {n!r} "
                             f"(letters/digits/_/- only)")
        if n in taken or n == "":
            raise StoreError(
                f"multivector space {n!r} collides with another "
                f"vector space")
        d = int(d)
        if d <= 0:
            raise StoreError(f"bad dim for multivector space {n!r}: {d}")
        out[n] = d
    return out


def check_multi_row(row, d: int) -> np.ndarray:
    """Normalize one multivector to a [T, d] f32 array (T may be 0;
    None means empty)."""
    if row is None:
        return np.zeros((0, d), np.float32)
    arr = np.ascontiguousarray(row, np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.ndim != 2 or arr.shape[1] != d:
        raise StoreError(
            f"multivector rows must be [*, {d}], got {arr.shape}")
    return arr


def check_sparse_row(row):
    """Normalize one sparse vector to (indices u32, values f32), both
    sorted by index, duplicates rejected (qdrant requires unique
    indices). Accepts {"indices": ..., "values": ...} dicts or
    (indices, values) pairs; None/empty means an empty row."""
    if row is None:
        return (np.zeros(0, "<u4"), np.zeros(0, "<f4"))
    if isinstance(row, dict):
        idx, val = row.get("indices"), row.get("values")
    else:
        idx, val = row
    idx = np.asarray(idx if idx is not None else [], np.int64).reshape(-1)
    val = np.asarray(val if val is not None else [],
                     np.float32).reshape(-1)
    if idx.shape != val.shape:
        raise StoreError(
            f"sparse row has {idx.size} indices but {val.size} values")
    if idx.size:
        if idx.min() < 0 or idx.max() > np.iinfo(np.uint32).max:
            raise StoreError("sparse indices must be u32")
        order = np.argsort(idx, kind="stable")
        idx, val = idx[order], val[order]
        if np.any(idx[1:] == idx[:-1]):
            raise StoreError("duplicate indices in a sparse vector")
    return (idx.astype("<u4"), val.astype("<f4"))


def collection_name(db_name: str) -> str:
    return f"{COLLECTION_PREFIX}{db_name}"


def list_databases(root: str) -> list[str]:
    """Directory listing of the DB root (reference core_system.py:74-88)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if os.path.isdir(p) and name != "checkpoints":
            out.append(name)
    return out


def delete_database(root: str, name: str) -> None:
    """shutil.rmtree of the DB dir (reference core_system.py:121-135).

    A locked store is live in another process (a build appending to
    it); deleting it out from under the writer both destroys the data
    mid-build and lets a later create() interleave with the zombie
    writer. Mirror create(overwrite=True)'s guard: explicit unlock
    required first (the reference exposed the same escape hatch,
    core_system.py:137-154)."""
    path = os.path.join(root, name)
    if not os.path.isdir(path):
        raise StoreError(f"Database not found: {name}")
    # only a LIVE holder blocks (docs/OPERATIONS.md contract); a stale
    # lock from a crashed build is taken over, same as the resume path
    if lock_holder_alive(root, name):
        raise StoreLockedError(
            f"Database '{name}' is locked (a build may be running); "
            f"unlock it first")
    shutil.rmtree(path)
    # aliases pointing at the deleted database die with it (qdrant
    # drops a collection's aliases on deletion)
    aliases = _read_aliases(root)
    dangling = [a for a, n in aliases.items() if n == name]
    if dangling:
        for a in dangling:
            del aliases[a]
        try:
            _write_aliases(root, aliases)
        except OSError:
            pass


ALIASES_FILE = "aliases.json"


def _read_aliases(root: str) -> dict:
    path = os.path.join(root, ALIASES_FILE)
    try:
        with open(path) as f:
            data = json.load(f)
        return {str(k): str(v) for k, v in data.items()}
    except (OSError, ValueError):
        return {}


def _write_aliases(root: str, aliases: dict) -> None:
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, ALIASES_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(aliases, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, ALIASES_FILE))


def list_aliases(root: str) -> dict:
    """alias -> database name map (qdrant collection-aliases role)."""
    return _read_aliases(root)


def set_alias(root: str, alias: str, name: str) -> None:
    """Point `alias` at database `name` (created or repointed
    atomically — qdrant's alias switchover use case: build a new
    index under a fresh name, then flip the alias)."""
    if not alias or os.sep in alias or alias != os.path.basename(alias):
        raise StoreError(f"Bad alias name: {alias!r}")
    if os.path.isdir(os.path.join(root, alias)):
        raise StoreError(
            f"Alias '{alias}' collides with an existing database")
    if not os.path.isdir(os.path.join(root, name)):
        raise StoreError(f"Database not found: {name}")
    aliases = _read_aliases(root)
    aliases[alias] = name
    _write_aliases(root, aliases)


def delete_alias(root: str, alias: str) -> bool:
    """Remove an alias; returns False when it did not exist."""
    aliases = _read_aliases(root)
    if alias not in aliases:
        return False
    del aliases[alias]
    _write_aliases(root, aliases)
    return True


def resolve_alias(root: str, name: str) -> str:
    """Database name or alias -> database name. A real database
    directory always wins over a same-named alias (set_alias forbids
    creating that collision, but a db created later shadows)."""
    if os.path.isdir(os.path.join(root, name)):
        return name
    return _read_aliases(root).get(name, name)


def lock_holder_alive(root: str, name: str) -> Optional[bool]:
    """Whether the process that wrote a store's lock file is still alive.

    Returns None when there is no lock, True/False otherwise. A lock whose
    PID is unparseable counts as alive (conservative: never steal it).
    Crash-resume uses this to distinguish a stale lock left by a dead
    build (safe to take over) from a live concurrent writer.
    """
    return _lock_holder_alive_at(os.path.join(root, name))


def _lock_holder_alive_at(path: str) -> Optional[bool]:
    lock = os.path.join(path, LOCK_FILE)
    if not os.path.exists(lock):
        return None
    try:
        with open(lock) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return True
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def unlock_database(root: str, name: str) -> bool:
    """Remove a stale lock file; returns True if one was removed
    (reference core_system.py:137-154)."""
    path = os.path.join(root, name)
    if not os.path.isdir(path):
        raise StoreError(f"Database not found: {name}")
    lock = os.path.join(path, LOCK_FILE)
    if os.path.exists(lock):
        os.remove(lock)
        return True
    return False


@dataclass
class VectorStore:
    """Append-only on-disk store of L2-normalized fp32 vectors + payloads."""

    path: str
    name: str
    dim: int
    collection: str
    count: int = 0
    # Monotonic content-version: seeded from the wall clock at create()
    # and bumped by EVERY mutation (append/truncate/compact/payload
    # edit), so two stores that happen to hold the same row count never
    # alias — host-side caches (payload columns, offset tables) key on
    # (count, data_version).
    data_version: int = 0
    # Bumped only when VECTOR content changes (append/truncate/compact),
    # NOT by payload edits: the device index keys on (count,
    # vector_version) so a set_payload on a 4 GB corpus doesn't trigger
    # a full HBM re-upload of unchanged vectors.
    vector_version: int = 0
    # Bumped ONLY by truncate (the one mutation that rewrites existing
    # rows). While it holds still, the row prefix is immutable, so
    # derived structures built over the first N rows (the IVF k-means
    # cache) can be EXTENDED with newly-appended rows instead of being
    # rebuilt from scratch.
    mutation_epoch: int = 0
    # extra NAMED vector spaces: {name: dim} (qdrant named vectors).
    # Every point carries a vector in EVERY space (append requires all;
    # qdrant's sparse per-point presence is not supported). The default
    # space "" (dim `self.dim`) always exists.
    named: dict = field(default_factory=dict)
    # SPARSE vector spaces: {name: params} (qdrant sparse vectors).
    # Disjoint from the dense names; every append covers every sparse
    # space too (empty rows are legal — unlike dense, a point may have
    # no entries in a sparse space, matching qdrant).
    sparse: dict = field(default_factory=dict)
    # MULTIVECTOR spaces: {name: dim} (qdrant multivectors) — each
    # point holds a variable-length [T, dim] matrix of sub-vectors
    # (max-sim comparison). Same ragged entry-log layout as sparse.
    multi: dict = field(default_factory=dict)
    # Distance metric of the DENSE spaces (qdrant's Distance config):
    # "cosine" (the default — rows are stored L2-normalized and scores
    # are plain dots), "dot" (raw inner product, rows stored as-is),
    # "euclid" or "manhattan" (scores are -distance so higher-is-better
    # ordering holds everywhere; the device index maps euclid onto the
    # same fused dot kernels via the [x, ||x||^2] augmentation, and L1
    # onto the chunked ops/l1.py scan — no dot factorization exists).
    distance: str = "cosine"
    _vec_fs: dict = field(default_factory=dict, repr=False)
    _sp_fs: dict = field(default_factory=dict, repr=False)
    _sp_idx_fs: dict = field(default_factory=dict, repr=False)
    _sp_pos: dict = field(default_factory=dict, repr=False)
    _pay_f: Any = field(default=None, repr=False)
    _idx_f: Any = field(default=None, repr=False)
    _pay_pos: int = field(default=0, repr=False)
    _locked: bool = field(default=False, repr=False)

    def spaces(self) -> dict:
        """{space name: dim} including the default space ''."""
        return {"": self.dim, **self.named}

    # -- lifecycle -----------------------------------------------------

    @staticmethod
    def create(root: str, name: str, dim: int, *,
               named: Optional[dict] = None, sparse=None,
               multi: Optional[dict] = None, distance: str = "cosine",
               overwrite: bool = False) -> "VectorStore":
        path = os.path.join(root, name)
        named = _check_spaces(named)
        sparse = _check_sparse_spaces(sparse, named)
        multi = _check_multi_spaces(multi, {**named, **sparse})
        if distance not in ("cosine", "dot", "euclid", "manhattan"):
            raise StoreError(f"unknown distance {distance!r} "
                             f"(cosine|dot|euclid|manhattan)")
        if os.path.isdir(path) and overwrite:
            # The lock must protect the one destructive operation too: a
            # locked store is live in another process — refuse to rmtree
            # it out from under the writer (explicit unlock required).
            if os.path.exists(os.path.join(path, LOCK_FILE)):
                raise StoreLockedError(
                    f"Database '{name}' is locked; unlock it first")
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        meta_path = os.path.join(path, META_FILE)
        if os.path.exists(meta_path) and not overwrite:
            raise StoreError(f"Database already exists: {name}")
        # both seeded from the clock so a delete-recreate under the same
        # name never aliases a prior incarnation's derived caches
        now = time.time_ns()
        store = VectorStore(path=path, name=name, dim=dim,
                            collection=collection_name(name), count=0,
                            data_version=now, vector_version=now,
                            mutation_epoch=now, named=named,
                            sparse=sparse, multi=multi,
                            distance=distance)
        store._acquire_lock()
        store._write_meta()
        # touch data files
        for space in store.spaces():
            open(os.path.join(path, vec_file(space)), "ab").close()
        for space in store._ragged():
            ent_path, idx_path, _ = store._ragged_paths(space)
            open(ent_path, "ab").close()
            open(idx_path, "ab").close()
        open(os.path.join(path, PAYLOAD_FILE), "ab").close()
        open(os.path.join(path, PAYLOAD_IDX_FILE), "ab").close()
        return store

    @staticmethod
    def open(root: str, name: str, *, writable: bool = False) -> "VectorStore":
        path = os.path.join(root, name)
        meta_path = os.path.join(path, META_FILE)
        if not os.path.isdir(path):
            raise StoreError(f"Database not found: {name}")
        try:
            # roll forward (or sweep) an interrupted compaction BEFORE
            # meta is read: post-marker, the marker's meta is the truth
            # and the old meta's count exceeds the compacted files
            VectorStore._recover_compact(path)
            VectorStore._recover_vec_patch(path)
        except OSError:
            pass                  # read-only filesystem: stale stage
        if not os.path.exists(meta_path):
            raise StoreError(f"Collection not found in database: {name}")
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except ValueError as e:   # empty/partial meta: StoreError, so
            raise StoreError(     # recovery paths catch it uniformly
                f"Corrupt store {name}: unreadable meta.json ({e})")
        # legacy-name fallback (reference core_system.py:107)
        coll = meta.get("collection", collection_name(name))
        dv = int(meta.get("data_version", 0))
        store = VectorStore(path=path, name=name, dim=int(meta["dim"]),
                            collection=coll, count=int(meta["count"]),
                            data_version=dv,
                            # legacy stores (pre payload-edit support):
                            # vectors changed whenever data did
                            vector_version=int(meta.get("vector_version",
                                                        dv)),
                            mutation_epoch=int(meta.get("mutation_epoch",
                                                        0)),
                            named={str(k): int(v) for k, v in
                                   (meta.get("named") or {}).items()},
                            sparse={str(k): (dict(v) if isinstance(v, dict)
                                             else {}) for k, v in
                                    (meta.get("sparse") or {}).items()},
                            multi={str(k): int(v) for k, v in
                                   (meta.get("multi") or {}).items()},
                            distance=str(meta.get("distance",
                                                  "cosine")))
        for space, d in store.spaces().items():
            vec_path = os.path.join(path, vec_file(space))
            actual_rows = os.path.getsize(vec_path) // (4 * d) \
                if os.path.exists(vec_path) else 0
            if actual_rows < store.count:
                raise StoreError(
                    f"Corrupt store {name}: meta says {store.count} rows, "
                    f"{vec_file(space)} has {actual_rows}")
        for space, rec in store._ragged().items():
            ent_path, idx_path, _ = store._ragged_paths(space)
            idx_rows = os.path.getsize(idx_path) // 8 \
                if os.path.exists(idx_path) else 0
            if idx_rows < store.count:
                raise StoreError(
                    f"Corrupt store {name}: meta says {store.count} rows, "
                    f"space {space!r} indptr has {idx_rows}")
            need = store._ragged_total(space, store.count) * rec
            have = os.path.getsize(ent_path) \
                if os.path.exists(ent_path) else 0
            if have < need:
                raise StoreError(
                    f"Corrupt store {name}: space {space!r} needs "
                    f"{need} entry bytes for {store.count} rows, has "
                    f"{have}")
        # rows beyond count are a torn append (crash between write and
        # meta flush): keep the durable prefix, ignore the tail.
        # Read-only handles just never look past count; a WRITABLE
        # handle must physically trim the tail (below) because append()
        # writes at EOF — appending after torn bytes would misalign
        # every later row.
        if writable:
            store._acquire_lock()
            store._trim_torn_tail()
        return store

    def refresh(self) -> None:
        """Re-sync a read-only handle with the on-disk meta (count and
        data_version), so external mutations (a build in another process)
        become visible without reopening. No-op for writable handles —
        the writer's in-memory state is authoritative."""
        if self._locked:
            return
        meta_path = os.path.join(self.path, META_FILE)
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return
        count = int(meta.get("count", self.count))
        version = int(meta.get("data_version", self.data_version))
        if count != self.count or version != self.data_version:
            self.count = count
            self.data_version = version
            self.vector_version = int(meta.get("vector_version", version))
            self.mutation_epoch = int(meta.get("mutation_epoch",
                                               self.mutation_epoch))
            self._offsets_cache = None

    def _acquire_lock(self) -> None:
        # O_CREAT|O_EXCL makes acquisition atomic: a check-then-create
        # would let two processes that race past the exists() check
        # both "hold" the lock and interleave appends (permanent
        # row/payload misalignment)
        lock = os.path.join(self.path, LOCK_FILE)
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            raise StoreLockedError(
                f"Database '{self.name}' is locked; unlock it first")
        with os.fdopen(fd, "w") as f:
            f.write(str(os.getpid()))
        self._locked = True

    def close(self) -> None:
        self.flush()
        for fs in (self._vec_fs, self._sp_fs, self._sp_idx_fs):
            for f in fs.values():
                f.close()
            fs.clear()
        if self._pay_f is not None:
            self._pay_f.close()
            self._pay_f = None
        if self._idx_f is not None:
            self._idx_f.close()
            self._idx_f = None
        if self._locked:
            lock = os.path.join(self.path, LOCK_FILE)
            if os.path.exists(lock):
                os.remove(lock)
            self._locked = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- io ------------------------------------------------------------

    def _meta_dict(self, *, count: Optional[int] = None, bump_data=0,
                   bump_vec=0, bump_epoch=0) -> dict:
        """Meta JSON for the (possibly post-mutation) state. The
        `named` map only appears when non-empty so legacy stores'
        meta files are byte-compatible."""
        meta = {"name": self.name, "collection": self.collection,
                "dim": self.dim,
                "count": self.count if count is None else count,
                "data_version": self.data_version + bump_data,
                "vector_version": self.vector_version + bump_vec,
                "mutation_epoch": self.mutation_epoch + bump_epoch,
                "dtype": "float32", "version": 1}
        if self.named:
            meta["named"] = dict(self.named)
        if self.sparse:
            meta["sparse"] = {k: dict(v) for k, v in self.sparse.items()}
        if self.multi:
            meta["multi"] = dict(self.multi)
        if self.distance != "cosine":
            meta["distance"] = self.distance
        return meta

    def _write_meta(self) -> None:
        tmp = os.path.join(self.path, META_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self._meta_dict(), f, indent=2)
            # fsync BEFORE the rename: os.replace is atomic in the
            # namespace but does not imply the new file's data blocks
            # are durable — power loss could otherwise commit a rename
            # to an empty/partial meta.json
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, META_FILE))

    def _check_batch(self, vectors) -> dict:
        """Normalize an append/upsert batch to {space: [n, dim] f32}.
        Arrays address the default space; a store with named spaces
        requires a dict covering EVERY space (each point carries a
        vector in each — see `named`)."""
        if not isinstance(vectors, dict):
            vectors = {"": vectors}
        spaces = self.spaces()
        if set(vectors) != set(spaces):
            raise StoreError(
                f"append needs vectors for exactly the spaces "
                f"{sorted(spaces)}, got {sorted(vectors)}")
        out = {}
        n = None
        for space, d in spaces.items():
            arr = np.ascontiguousarray(vectors[space], dtype=np.float32)
            if arr.ndim != 2 or arr.shape[1] != d:
                raise StoreError(
                    f"expected [*, {d}] vectors for space {space!r}, "
                    f"got {arr.shape}")
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise StoreError(
                    f"space {space!r} has {arr.shape[0]} rows, "
                    f"expected {n}")
            out[space] = arr
        return out

    def append(self, vectors, payloads: Sequence[dict],
               sparse_vectors=None, multi_vectors=None) -> None:
        """Append a batch of L2-normalized fp32 vectors with payloads.
        `vectors` is an array (default space) or a {space: array} dict
        covering every dense vector space; a store with SPARSE spaces
        also requires `sparse_vectors` = {space: [n rows]} covering
        every sparse space (rows are {"indices", "values"} dicts,
        (indices, values) pairs, or None for empty), and one with
        MULTIVECTOR spaces requires `multi_vectors` = {space: [n
        matrices]} ([T, d] each, or None for empty)."""
        batch = self._check_batch(vectors)
        n = len(next(iter(batch.values())))
        sp_batch = self._check_sparse_batch(sparse_vectors, n)
        sp_batch.update(self._check_multi_batch(multi_vectors, n))
        if len(payloads) != n:
            raise StoreError("payload count != vector count")
        if not self._locked:
            raise StoreError("store opened read-only")
        if not self._vec_fs:
            for space in self.spaces():
                self._vec_fs[space] = open(
                    os.path.join(self.path, vec_file(space)), "ab")
            for space in self._ragged():
                ent_path, idx_path, _ = self._ragged_paths(space)
                # resume the cumulative record counter from the committed
                # prefix (a writable open already trimmed torn tails)
                self._sp_pos[space] = self._ragged_total(space, self.count)
                self._sp_fs[space] = open(ent_path, "ab")
                self._sp_idx_fs[space] = open(idx_path, "ab")
            self._pay_f = open(os.path.join(self.path, PAYLOAD_FILE), "ab")
            self._pay_pos = os.path.getsize(
                os.path.join(self.path, PAYLOAD_FILE))
            self._repair_sidecar()
            self._idx_f = open(os.path.join(self.path, PAYLOAD_IDX_FILE), "ab")
        for space, arr in batch.items():
            self._vec_fs[space].write(arr.tobytes())
        for space, (ent, nnz) in sp_batch.items():
            self._sp_fs[space].write(ent.tobytes())
            ends = self._sp_pos[space] + np.cumsum(nnz)
            self._sp_idx_fs[space].write(ends.astype("<i8").tobytes())
            self._sp_pos[space] = int(ends[-1]) if len(ends) else \
                self._sp_pos[space]
        offsets = np.empty(len(payloads), "<i8")
        for row, p in enumerate(payloads):
            line = (json.dumps(p, separators=(",", ":")) + "\n").encode()
            offsets[row] = self._pay_pos
            self._pay_f.write(line)
            self._pay_pos += len(line)
        self._idx_f.write(offsets.tobytes())
        self.count += n
        self.data_version += 1
        self.vector_version += 1
        self._offsets_cache = None

    def _repair_sidecar(self) -> None:
        """Bring payloads.idx into lockstep with payloads.jsonl.

        A crash between the JSONL write and the sidecar write (or a
        legacy store with no sidecar at all) leaves the sidecar short;
        resume by scanning the JSONL only from the last indexed line —
        O(new lines), not O(N). A sidecar pointing past EOF (truncate
        torn mid-way) is rebuilt from scratch."""
        jsonl = os.path.join(self.path, PAYLOAD_FILE)
        idx = os.path.join(self.path, PAYLOAD_IDX_FILE)
        jsonl_size = os.path.getsize(jsonl) if os.path.exists(jsonl) else 0
        idx_rows = os.path.getsize(idx) // 8 if os.path.exists(idx) else 0
        scan_from = 0
        if idx_rows > 0:
            with open(idx, "rb") as f:
                f.seek((idx_rows - 1) * 8)
                last = int(np.frombuffer(f.read(8), "<i8")[0])
            if 0 <= last < jsonl_size:
                with open(jsonl, "rb") as f:
                    f.seek(last)
                    scan_from = last + len(f.readline())
            else:            # sidecar points past EOF: rebuild fully
                idx_rows = 0
        tail = []
        with open(jsonl, "rb") as f:
            f.seek(scan_from)
            pos = scan_from
            for line in f:
                tail.append(pos)
                pos += len(line)
        if idx_rows == 0:
            tmp = idx + ".tmp"
            with open(tmp, "wb") as f:
                f.write(np.asarray(tail, "<i8").tobytes())
            os.replace(tmp, idx)
        elif tail:
            with open(idx, "ab") as f:
                f.write(np.asarray(tail, "<i8").tobytes())

    def flush(self) -> None:
        for fs in (self._vec_fs, self._sp_fs, self._sp_idx_fs):
            for f in fs.values():
                f.flush()
                os.fsync(f.fileno())
        if self._pay_f is not None:
            self._pay_f.flush()
            os.fsync(self._pay_f.fileno())
        if self._idx_f is not None:
            self._idx_f.flush()
            os.fsync(self._idx_f.fileno())
        if self._locked:
            self._write_meta()

    def vectors(self, space: str = "") -> np.ndarray:
        """Memory-mapped [count, dim] fp32 view (zero copy) of one
        vector space ('' = the default space)."""
        d = self.spaces().get(space)
        if d is None:
            raise StoreError(f"unknown vector space {space!r} "
                             f"(have {sorted(self.spaces())})")
        self.flush()
        path = os.path.join(self.path, vec_file(space))
        if self.count == 0:
            return np.zeros((0, d), np.float32)
        return np.memmap(path, dtype=np.float32, mode="r",
                         shape=(self.count, d))

    # -- ragged spaces (sparse + multivector) ------------------------------

    def _ragged(self) -> dict:
        """{space: record bytes} for every ragged space (sparse entry
        logs and multivector sub-vector logs share the layout)."""
        out = {sp: SPARSE_ENTRY.itemsize for sp in self.sparse}
        out.update({sp: 4 * d for sp, d in self.multi.items()})
        return out

    def _ragged_paths(self, space: str) -> tuple:
        """(entry log path, indptr path, record bytes) for one ragged
        space."""
        if space in self.sparse:
            return (os.path.join(self.path, SPARSE_FMT.format(space)),
                    os.path.join(self.path, SPARSE_IDX_FMT.format(space)),
                    SPARSE_ENTRY.itemsize)
        if space in self.multi:
            return (os.path.join(self.path, MULTI_FMT.format(space)),
                    os.path.join(self.path, MULTI_IDX_FMT.format(space)),
                    4 * self.multi[space])
        raise StoreError(f"unknown sparse/multivector space {space!r} "
                         f"(have {sorted(self._ragged())})")

    def _ragged_total(self, space: str, count: int) -> int:
        """Cumulative record count at the end of row `count - 1` — one
        8-byte read of the indptr sidecar (0 when count is 0)."""
        if count <= 0:
            return 0
        _, idx_path, _ = self._ragged_paths(space)
        if not os.path.exists(idx_path) or \
                os.path.getsize(idx_path) < count * 8:
            raise StoreError(
                f"space {space!r} indptr shorter than {count} rows")
        with open(idx_path, "rb") as f:
            f.seek((count - 1) * 8)
            return int(np.frombuffer(f.read(8), "<i8")[0])

    # backwards-compatible sparse aliases (used by store/sparse.py)
    def _sparse_paths(self, space: str) -> tuple:
        ent, idx, _ = self._ragged_paths(space)
        return ent, idx

    def _sparse_total(self, space: str, count: int) -> int:
        return self._ragged_total(space, count)

    def ragged_indptr(self, space: str) -> np.ndarray:
        """[count] int64 cumulative record ends (memmap; row r's
        records are [indptr[r-1], indptr[r]) in the entry log)."""
        _, idx_path, _ = self._ragged_paths(space)
        self.flush()
        if self.count == 0:
            return np.zeros(0, np.int64)
        return np.memmap(idx_path, dtype="<i8", mode="r",
                         shape=(self.count,))

    def sparse_indptr(self, space: str) -> np.ndarray:
        return self.ragged_indptr(space)

    def sparse_entries(self, space: str) -> np.ndarray:
        """Structured [total] (u32 index, f32 value) entry log (memmap)
        covering the committed rows."""
        if space not in self.sparse:
            raise StoreError(f"unknown sparse space {space!r} "
                             f"(have {sorted(self.sparse)})")
        ent_path, _, _ = self._ragged_paths(space)
        self.flush()
        total = self._ragged_total(space, self.count)
        if total == 0:
            return np.zeros(0, SPARSE_ENTRY)
        return np.memmap(ent_path, dtype=SPARSE_ENTRY, mode="r",
                         shape=(total,))

    def multivectors(self, space: str) -> tuple:
        """(sub-vector matrix [total, d] f32 memmap, indptr [count])
        for one multivector space — the flat layout the max-sim scan
        consumes directly."""
        if space not in self.multi:
            raise StoreError(f"unknown multivector space {space!r} "
                             f"(have {sorted(self.multi)})")
        ent_path, _, _ = self._ragged_paths(space)
        d = self.multi[space]
        self.flush()
        total = self._ragged_total(space, self.count)
        ent = (np.memmap(ent_path, dtype=np.float32, mode="r",
                         shape=(total, d)) if total
               else np.zeros((0, d), np.float32))
        return ent, self.ragged_indptr(space)

    def sparse_rows(self, space: str, rows) -> list:
        """Per-row sparse vectors: list of {"indices", "values"} dicts
        (row ids out of range -> None), O(k) seeks via the indptr."""
        if space not in self.sparse:
            raise StoreError(f"unknown sparse space {space!r} "
                             f"(have {sorted(self.sparse)})")
        out = []
        for raw in self._ragged_read(space, rows):
            if raw is None:
                out.append(None)
                continue
            ent = np.frombuffer(raw, SPARSE_ENTRY)
            out.append({"indices": ent["i"].astype(np.int64),
                        "values": ent["v"].astype(np.float32)})
        return out

    def multivector_rows(self, space: str, rows) -> list:
        """Per-row multivectors: list of [T, d] f32 arrays (row ids out
        of range -> None), O(k) seeks via the indptr."""
        if space not in self.multi:
            raise StoreError(f"unknown multivector space {space!r} "
                             f"(have {sorted(self.multi)})")
        d = self.multi[space]
        out = []
        for raw in self._ragged_read(space, rows):
            out.append(None if raw is None else
                       np.frombuffer(raw, np.float32).reshape(-1, d))
        return out

    def _ragged_read(self, space: str, rows) -> list:
        """Raw record bytes per requested row (None when out of range)."""
        indptr = self.ragged_indptr(space)
        ent_path, _, rec = self._ragged_paths(space)
        out = []
        with open(ent_path, "rb") as f:
            for r in rows:
                r = int(r)
                if not 0 <= r < self.count:
                    out.append(None)
                    continue
                lo = int(indptr[r - 1]) if r else 0
                hi = int(indptr[r])
                f.seek(lo * rec)
                out.append(f.read((hi - lo) * rec))
        return out

    def _check_sparse_batch(self, sparse_vectors, n: int) -> dict:
        """Normalize an append batch's sparse part to
        {space: (entries structured array, per-row nnz int64)}.
        A store with sparse spaces requires every space covered with a
        length-n sequence of rows (dicts/pairs/None)."""
        sparse_vectors = dict(sparse_vectors or {})
        if set(sparse_vectors) != set(self.sparse):
            raise StoreError(
                f"append needs sparse vectors for exactly the spaces "
                f"{sorted(self.sparse)}, got {sorted(sparse_vectors)}")
        out = {}
        for space, rows in sparse_vectors.items():
            rows = list(rows)
            if len(rows) != n:
                raise StoreError(
                    f"sparse space {space!r} has {len(rows)} rows, "
                    f"expected {n}")
            parts = [check_sparse_row(r) for r in rows]
            nnz = np.asarray([len(i) for i, _ in parts], np.int64)
            ent = np.zeros(int(nnz.sum()), SPARSE_ENTRY)
            if len(ent):
                ent["i"] = np.concatenate([i for i, _ in parts])
                ent["v"] = np.concatenate([v for _, v in parts])
            out[space] = (ent, nnz)
        return out

    def _check_multi_batch(self, multi_vectors, n: int) -> dict:
        """Normalize an append batch's multivector part to
        {space: (flat [sum T, d] f32, per-row T int64)}. A store with
        multivector spaces requires every space covered with a
        length-n sequence of [T, d] matrices (or None for empty)."""
        multi_vectors = dict(multi_vectors or {})
        if set(multi_vectors) != set(self.multi):
            raise StoreError(
                f"append needs multivectors for exactly the spaces "
                f"{sorted(self.multi)}, got {sorted(multi_vectors)}")
        out = {}
        for space, rows in multi_vectors.items():
            d = self.multi[space]
            rows = list(rows)
            if len(rows) != n:
                raise StoreError(
                    f"multivector space {space!r} has {len(rows)} rows, "
                    f"expected {n}")
            parts = [check_multi_row(r, d) for r in rows]
            nnz = np.asarray([len(p) for p in parts], np.int64)
            flat = (np.concatenate(parts) if parts
                    else np.zeros((0, d), np.float32))
            out[space] = (flat, nnz)
        return out

    def _payload_offsets(self):
        """Byte offset of each payload line.

        Prefers the `payloads.idx` sidecar (a memmap read — O(1) to
        open, O(k) per query join even with a cold cache); falls back
        to a one-time O(N) scan of the JSONL for legacy/torn stores,
        writing the sidecar back so the scan never repeats."""
        cached = getattr(self, "_offsets_cache", None)
        if cached is not None and len(cached) >= self.count:
            return cached
        jsonl = os.path.join(self.path, PAYLOAD_FILE)
        idx = os.path.join(self.path, PAYLOAD_IDX_FILE)
        idx_rows = os.path.getsize(idx) // 8 if os.path.exists(idx) else 0
        if idx_rows >= self.count:
            offsets = np.memmap(idx, dtype="<i8", mode="r",
                                shape=(idx_rows,)) if idx_rows else \
                np.zeros((0,), np.int64)
            # torn-truncate guard: an offset past EOF means the sidecar
            # is stale relative to the JSONL — rebuild below instead
            if self.count == 0 or int(offsets[self.count - 1]) < \
                    os.path.getsize(jsonl):
                self._offsets_cache = offsets
                return offsets
        offsets = []
        pos = 0
        with open(jsonl, "rb") as f:
            for line in f:
                offsets.append(pos)
                pos += len(line)
        arr = np.asarray(offsets, np.int64)
        try:               # upgrade in place (atomic; readers may race)
            tmp = idx + ".tmp"
            with open(tmp, "wb") as f:
                f.write(arr.astype("<i8").tobytes())
            os.replace(tmp, idx)
        except OSError:
            pass           # read-only filesystem: scan-per-process only
        self._offsets_cache = arr
        return arr

    def payloads(self, indices: Iterable[int] | None = None) -> list[dict]:
        """Load payloads; `indices` selects specific rows (host-side join
        after a device-side top-k) via seek — O(k), not O(N)."""
        self.flush()
        path = os.path.join(self.path, PAYLOAD_FILE)
        if indices is None:
            with open(path, "rb") as f:
                lines = f.read().splitlines()
            return [json.loads(l) for l in lines[: self.count]]
        offsets = self._payload_offsets()
        out = []
        with open(path, "rb") as f:
            for i in indices:
                if i < 0 or i >= min(self.count, len(offsets)):
                    out.append(None)
                    continue
                f.seek(int(offsets[i]))
                out.append(json.loads(f.readline()))
        return out

    def _payload_cut(self, count: int) -> int:
        """Byte offset in payloads.jsonl where line `count` starts —
        O(1) via the sidecar (plus a short walk if the sidecar trails
        by a few lines), never an O(N) scan of the JSONL."""
        jsonl = os.path.join(self.path, PAYLOAD_FILE)
        if count <= 0 or not os.path.exists(jsonl):
            return 0
        size = os.path.getsize(jsonl)
        idx = os.path.join(self.path, PAYLOAD_IDX_FILE)
        idx_rows = os.path.getsize(idx) // 8 if os.path.exists(idx) else 0
        start_row, start_pos = 0, 0
        if idx_rows > 0:
            row = min(count, idx_rows - 1)
            with open(idx, "rb") as f:
                f.seek(row * 8)
                cand = int(np.frombuffer(f.read(8), "<i8")[0])
            if 0 <= cand <= size:
                if row == count:          # direct hit: start of line count
                    return cand
                start_row, start_pos = row, cand
        with open(jsonl, "rb") as f:
            f.seek(start_pos)
            for _ in range(start_row, count):
                if not f.readline():
                    break
            return f.tell()

    def _trim_torn_tail(self) -> None:
        """Physically drop file bytes beyond the committed `count`
        (torn append, or a truncate interrupted after its meta commit).
        Called on writable open, before any append can land at EOF."""
        for space, d in self.spaces().items():
            vec_path = os.path.join(self.path, vec_file(space))
            vec_bytes = self.count * 4 * d
            if os.path.exists(vec_path) and \
                    os.path.getsize(vec_path) > vec_bytes:
                with open(vec_path, "r+b") as f:
                    os.ftruncate(f.fileno(), vec_bytes)
        for space in self._ragged():
            ent_path, idx_path, rec = self._ragged_paths(space)
            ent_bytes = self._ragged_total(space, self.count) * rec
            if os.path.exists(ent_path) and \
                    os.path.getsize(ent_path) > ent_bytes:
                with open(ent_path, "r+b") as f:
                    os.ftruncate(f.fileno(), ent_bytes)
            if os.path.exists(idx_path) and \
                    os.path.getsize(idx_path) > self.count * 8:
                with open(idx_path, "r+b") as f:
                    os.ftruncate(f.fileno(), self.count * 8)
        jsonl = os.path.join(self.path, PAYLOAD_FILE)
        if os.path.exists(jsonl):
            cut = self._payload_cut(self.count)
            if os.path.getsize(jsonl) > cut:
                with open(jsonl, "r+b") as f:
                    os.ftruncate(f.fileno(), cut)
        idx_path = os.path.join(self.path, PAYLOAD_IDX_FILE)
        if os.path.exists(idx_path) and \
                os.path.getsize(idx_path) > self.count * 8:
            with open(idx_path, "r+b") as f:
                os.ftruncate(f.fileno(), self.count * 8)

    def truncate(self, count: int) -> None:
        """Drop rows beyond `count` (resume support: roll back a torn
        batch).

        Crash-safe ordering: the reduced count is committed to meta
        FIRST (readers never look past meta count, and the next
        writable open trims oversized files via `_trim_torn_tail`), and
        the payload file is shrunk in place at its exact byte offset —
        never rewritten (the old read-all/rewrite both loaded the whole
        JSONL into RAM and, worse, zeroed the file before rewriting: a
        crash in that window destroyed every payload)."""
        if not self._locked:
            raise StoreError("store opened read-only")
        if count > self.count:
            raise StoreError("cannot truncate upward")
        if count == self.count:
            # no-op: the row prefix is untouched — keep mutation_epoch
            # (and the IVF k-means cache keyed on it) intact. The
            # resume path truncates unconditionally, and a full retrain
            # after every clean resume would be pure waste.
            return
        self.close_files_for_truncate()
        cut = self._payload_cut(count)
        self.count = count
        self.data_version += 1
        self.vector_version += 1
        self.mutation_epoch += 1     # rows beyond count may be replaced:
        self._offsets_cache = None   # larger-prefix caches are invalid
        self._write_meta()
        for space, d in self.spaces().items():
            vec_path = os.path.join(self.path, vec_file(space))
            with open(vec_path, "r+b") as f:
                os.ftruncate(f.fileno(), count * 4 * d)
        for space in self._ragged():
            ent_path, idx_path, rec = self._ragged_paths(space)
            ent_bytes = self._ragged_total(space, count) * rec
            with open(ent_path, "r+b") as f:
                os.ftruncate(f.fileno(), ent_bytes)
            with open(idx_path, "r+b") as f:
                os.ftruncate(f.fileno(), count * 8)
        pay_path = os.path.join(self.path, PAYLOAD_FILE)
        if os.path.exists(pay_path):
            with open(pay_path, "r+b") as f:
                os.ftruncate(f.fileno(), cut)
        idx_path = os.path.join(self.path, PAYLOAD_IDX_FILE)
        if os.path.exists(idx_path):
            with open(idx_path, "r+b") as f:
                os.ftruncate(f.fileno(), count * 8)
        # tidy the delete_vectors mask (ids beyond the new count are
        # already dropped on READ — this rewrite is cosmetic, so a
        # crash before it costs nothing)
        if os.path.exists(self._deleted_path()):
            self._write_deleted(self._read_deleted())

    def close_files_for_truncate(self) -> None:
        for fs in (self._vec_fs, self._sp_fs, self._sp_idx_fs):
            for f in fs.values():
                f.close()
            fs.clear()
        if self._pay_f is not None:
            self._pay_f.close()
            self._pay_f = None
        if self._idx_f is not None:
            self._idx_f.close()
            self._idx_f = None

    # -- compaction (delete points) ------------------------------------

    def compact(self, keep_mask) -> int:
        """Rewrite the store keeping only rows where `keep_mask` is True
        — the delete-points/delete-by-filter role of qdrant's API
        (the reference's store could delete ids; an append-only layout
        needs a compaction pass for it). Returns rows removed.

        Crash-safe via a roll-forward journal: compacted files are
        staged as `.compact` siblings, a commit marker holding the new
        meta is fsynced, and only then do renames happen; `open()`
        completes an interrupted compaction from the marker (stage
        files without a marker are inert). The data_version AND
        mutation_epoch bump invalidates every derived cache (device
        index, IVF k-means, payload columns)."""
        if not self._locked:
            raise StoreError("store opened read-only")
        keep = np.asarray(keep_mask, bool)
        if keep.shape != (self.count,):
            raise StoreError(
                f"keep_mask must be [{self.count}], got {keep.shape}")
        removed = int(self.count - keep.sum())
        if removed == 0:
            return 0
        self.flush()
        self.close_files_for_truncate()
        new_count = int(keep.sum())

        for space, d in self.spaces().items():
            vec_path = os.path.join(self.path, vec_file(space))
            stage_vec = vec_path + ".compact"
            mm = np.memmap(vec_path, dtype=np.float32, mode="r",
                           shape=(self.count, d)) if self.count else None
            with open(stage_vec, "wb") as out:
                for lo in range(0, self.count, 65536):  # bounded memory
                    hi = min(lo + 65536, self.count)
                    sel = keep[lo:hi]
                    if sel.any():
                        out.write(np.ascontiguousarray(
                            mm[lo:hi][sel]).tobytes())
                out.flush()
                os.fsync(out.fileno())
            del mm

        for space in self._ragged():
            ent_path, idx_path, rec = self._ragged_paths(space)
            indptr = np.memmap(idx_path, dtype="<i8", mode="r",
                               shape=(self.count,)) if self.count else \
                np.zeros(0, np.int64)
            starts = np.concatenate([[0], indptr[:-1]]) if self.count \
                else np.zeros(0, np.int64)
            nnz = np.asarray(indptr) - starts
            total = int(indptr[-1]) if self.count else 0
            # record-size-agnostic byte view: one row of `ent` = one
            # record (a sparse (idx, val) pair or a multivector row)
            ent = np.memmap(ent_path, dtype=np.uint8, mode="r",
                            shape=(total, rec)) if total else \
                np.zeros((0, rec), np.uint8)
            with open(ent_path + ".compact", "wb") as out:
                for lo in range(0, self.count, 65536):
                    hi = min(lo + 65536, self.count)
                    e0 = int(starts[lo]) if hi > lo else 0
                    e1 = int(indptr[hi - 1]) if hi > lo else 0
                    if e1 > e0:
                        emask = np.repeat(keep[lo:hi], nnz[lo:hi])
                        out.write(np.ascontiguousarray(
                            ent[e0:e1][emask]).tobytes())
                out.flush()
                os.fsync(out.fileno())
            with open(idx_path + ".compact", "wb") as out:
                out.write(np.cumsum(nnz[keep]).astype("<i8").tobytes())
                out.flush()
                os.fsync(out.fileno())
            del ent, indptr

        pay_path = os.path.join(self.path, PAYLOAD_FILE)
        stage_pay = pay_path + ".compact"
        stage_idx = os.path.join(self.path, PAYLOAD_IDX_FILE) + ".compact"
        offsets = np.empty(new_count, "<i8")
        with open(pay_path, "rb") as src, open(stage_pay, "wb") as out:
            pos = row = 0
            for i, line in enumerate(src):
                if i >= self.count:
                    break
                if keep[i]:
                    offsets[row] = pos
                    out.write(line)
                    pos += len(line)
                    row += 1
            out.flush()
            os.fsync(out.fileno())
        with open(stage_idx, "wb") as out:
            out.write(offsets[: row].tobytes())
            out.flush()
            os.fsync(out.fileno())

        # remap the delete_vectors mask through the kept-row renumbering
        # (surviving deleted rows keep their bit at the new id); staged
        # like every other compacted file so the commit marker makes
        # mask and data move together. An emptied mask stages {} — the
        # rename then clears the old ids instead of stranding them.
        dels = self._read_deleted()
        if dels:
            new_ids = np.cumsum(keep) - 1
            staged_dels = {}
            for s, v in dels.items():
                surv = v[keep[v]]
                if surv.size:
                    staged_dels[s] = new_ids[surv].tolist()
            dstage = self._deleted_path() + ".compact"
            with open(dstage, "w") as f:
                json.dump(staged_dels, f)
                f.flush()
                os.fsync(f.fileno())

        now_meta = self._meta_dict(count=new_count, bump_data=1,
                                   bump_vec=1, bump_epoch=1)
        marker = os.path.join(self.path, COMPACT_MARKER)
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            json.dump(now_meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, marker)      # <- commit point (roll forward)

        ragged_files = []
        for s in self._ragged():
            e, i, _ = self._ragged_paths(s)
            ragged_files += [os.path.basename(e), os.path.basename(i)]
        for fname in ([vec_file(s) for s in self.spaces()]
                      + ragged_files
                      + [PAYLOAD_FILE, PAYLOAD_IDX_FILE, DELETED_FILE]):
            full = os.path.join(self.path, fname)
            try:
                os.replace(full + ".compact", full)
            except FileNotFoundError:
                pass    # a recovery pass (stale-lock takeover) won the race
        self.count = new_count
        self.data_version = now_meta["data_version"]
        self.vector_version = now_meta["vector_version"]
        self.mutation_epoch = now_meta["mutation_epoch"]
        self._offsets_cache = None
        self._pay_pos = 0
        self._write_meta()
        try:
            os.remove(marker)
        except FileNotFoundError:
            pass      # a concurrent reader's open() already rolled forward
        return removed

    def update_payloads(self, rows, *, patch: Optional[dict] = None,
                        keys: Optional[Sequence[str]] = None,
                        mode: str = "set") -> int:
        """Rewrite the payloads of specific rows in place — the
        set_payload / overwrite_payload / delete_payload / clear_payload
        role of qdrant's points API (the reference's qdrant store had
        these; an append-only JSONL needs a rewrite pass for them).

        Modes: "set" merges `patch` keys into each payload,
        "overwrite" replaces the whole payload with `patch`, "delete"
        removes `keys`, "clear" empties the payload. Returns rows
        touched.

        Vectors are untouched, so only payloads.jsonl/.idx are staged —
        through the same `.compact` + commit-marker journal as
        `compact()` (the marker's roll-forward renames whichever stage
        files exist). `data_version` bumps (payload-column caches must
        refresh); `vector_version` and `mutation_epoch` do NOT (the
        device index and the IVF k-means cache stay valid)."""
        if not self._locked:
            raise StoreError("store opened read-only")
        if mode not in ("set", "overwrite", "delete", "clear"):
            raise StoreError(f"unknown payload update mode: {mode!r}")
        if mode in ("set", "overwrite") and not isinstance(patch, dict):
            raise StoreError(f"mode {mode!r} needs a dict patch")
        if mode == "delete" and not keys:
            raise StoreError("mode 'delete' needs keys to remove")
        sel = np.zeros(self.count, bool)
        rows = np.asarray(list(rows), np.int64).reshape(-1)
        if len(rows) and (rows.min() < 0 or rows.max() >= self.count):
            raise StoreError(
                f"row ids must be in [0, {self.count}), got "
                f"[{rows.min()}, {rows.max()}]")
        sel[rows] = True
        touched = int(sel.sum())
        if touched == 0:
            return 0
        self.flush()
        self.close_files_for_truncate()

        kset = set(keys or ())

        def rewrite(payload: dict) -> dict:
            if mode == "set":
                return {**payload, **patch}
            if mode == "overwrite":
                return dict(patch)
            if mode == "delete":
                return {k: v for k, v in payload.items() if k not in kset}
            return {}                                   # clear

        pay_path = os.path.join(self.path, PAYLOAD_FILE)
        stage_pay = pay_path + ".compact"
        stage_idx = os.path.join(self.path, PAYLOAD_IDX_FILE) + ".compact"
        with open(pay_path, "rb") as src, open(stage_pay, "wb") as out, \
                open(stage_idx, "wb") as idx_out:
            pos = 0
            obuf: list[int] = []              # bounded memory at 100M rows
            for i, line in enumerate(src):
                if i >= self.count:
                    break
                if sel[i]:
                    line = (json.dumps(rewrite(json.loads(line)),
                                       separators=(",", ":"))
                            + "\n").encode()
                obuf.append(pos)
                if len(obuf) == 65536:
                    idx_out.write(np.asarray(obuf, "<i8").tobytes())
                    obuf.clear()
                out.write(line)
                pos += len(line)
            if obuf:
                idx_out.write(np.asarray(obuf, "<i8").tobytes())
            out.flush()
            os.fsync(out.fileno())
            idx_out.flush()
            os.fsync(idx_out.fileno())

        now_meta = self._meta_dict(bump_data=1)
        marker = os.path.join(self.path, COMPACT_MARKER)
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            json.dump(now_meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, marker)      # <- commit point (roll forward)

        for fname in (PAYLOAD_FILE, PAYLOAD_IDX_FILE):
            full = os.path.join(self.path, fname)
            try:
                os.replace(full + ".compact", full)
            except FileNotFoundError:
                pass    # a recovery pass (stale-lock takeover) won the race
        self.data_version = now_meta["data_version"]
        self._offsets_cache = None
        self._pay_pos = 0
        self._write_meta()
        try:
            os.remove(marker)
        except FileNotFoundError:
            pass      # a concurrent reader's open() already rolled forward
        return touched

    def update_vectors(self, rows, vectors, space: str = "") -> int:
        """Overwrite the vectors of existing rows in place — qdrant's
        update_vectors role (payloads untouched; `space` selects the
        vector space, '' = default). Rows are fixed-width, so the
        rewrite is a handful of seeks, not a file rewrite.

        Crash safety: the full patch (row ids + new rows + the
        post-apply meta) is committed to `vectors.patch` FIRST
        (tmp+fsync+rename — the commit point), then applied to
        vectors.bin; `open()` rolls an interrupted apply forward from
        the patch (idempotent absolute writes). All three version
        fields bump: data_version (host caches), vector_version (the
        device index re-uploads — vectors actually changed), and
        mutation_epoch (the IVF k-means cache's prefix-immutability
        contract is broken by any in-place rewrite)."""
        if not self._locked:
            raise StoreError("store opened read-only")
        d = self.spaces().get(space)
        if d is None:
            raise StoreError(f"unknown vector space {space!r} "
                             f"(have {sorted(self.spaces())})")
        rows = np.asarray(list(rows), np.int64).reshape(-1)
        vecs = np.ascontiguousarray(vectors, np.float32)
        if vecs.ndim != 2 or vecs.shape != (len(rows), d):
            raise StoreError(
                f"expected [{len(rows)}, {d}] vectors, got "
                f"{vecs.shape}")
        if len(rows) == 0:
            return 0
        if rows.min() < 0 or rows.max() >= self.count:
            raise StoreError(
                f"row ids must be in [0, {self.count}), got "
                f"[{rows.min()}, {rows.max()}]")
        if len(np.unique(rows)) != len(rows):
            raise StoreError("duplicate row ids in update_vectors")
        self.flush()
        self.close_files_for_truncate()
        new_meta = self._meta_dict(bump_data=1, bump_vec=1, bump_epoch=1)
        patch = os.path.join(self.path, VEC_PATCH)
        tmp = patch + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, rows=rows, vecs=vecs,
                     meta=np.asarray(json.dumps(new_meta)),
                     space=np.asarray(space))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, patch)         # <- commit point (roll forward)
        self._apply_vec_patch(self.path, rows, vecs, space)
        self.count = new_meta["count"]
        self.data_version = new_meta["data_version"]
        self.vector_version = new_meta["vector_version"]
        self.mutation_epoch = new_meta["mutation_epoch"]
        self._write_meta()
        try:
            os.remove(patch)
        except FileNotFoundError:
            pass    # a concurrent reader's open() already rolled forward
        return len(rows)

    # -- per-point dense-vector deletion (qdrant delete_vectors) --------

    def _deleted_path(self) -> str:
        return os.path.join(self.path, DELETED_FILE)

    def _read_deleted(self) -> dict:
        """{dense space: sorted unique int64 row ids in [0, count)}.
        A missing/empty file means no deletions. Unknown spaces and
        out-of-range ids (a truncate that didn't tidy, a snapshot from
        a larger incarnation) are dropped on READ rather than policed
        at every mutation — the file is always written atomically, so
        no torn state exists to repair."""
        try:
            with open(self._deleted_path()) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(raw, dict):
            return {}
        out = {}
        spaces = self.spaces()
        for space, ids in raw.items():
            if space not in spaces or not isinstance(ids, list):
                continue
            try:    # imported snapshots: malformed lists never brick a store
                arr = np.unique(np.asarray(ids, np.int64))
            except (TypeError, ValueError, OverflowError):
                continue
            arr = arr[(arr >= 0) & (arr < self.count)]
            if arr.size:
                out[space] = arr
        return out

    def _write_deleted(self, dels: dict) -> None:
        path = self._deleted_path()
        dels = {s: np.asarray(v, np.int64).tolist()
                for s, v in dels.items() if len(v)}
        if not dels:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dels, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def deleted_rows(self, space: str = "") -> np.ndarray:
        """Sorted row ids whose `space` vector has been deleted
        (qdrant delete_vectors). Dense spaces only — sparse and
        multivector deletions physically empty the ragged row and need
        no mask (their presence comes from the indptr sidecar)."""
        if space not in self.spaces():
            raise StoreError(f"unknown dense vector space {space!r} "
                             f"(have {sorted(self.spaces())})")
        return self._read_deleted().get(space, np.zeros(0, np.int64))

    def delete_vector_rows(self, rows, space: str = "") -> int:
        """Mark the `space` vectors of existing rows deleted — the
        dense side of qdrant's delete_vectors. The points keep their
        payloads and their other spaces; searches in `space` exclude
        them exactly (the engine folds the mask into every scan),
        `has_vector` turns False, and `update_vectors` on the row
        resurrects it. Dense rows are fixed-width, so the bytes stay
        in place and this small mask file IS the deletion — written
        atomically, then data_version (has_vector answers changed) and
        vector_version (the device index must re-mask) bump. A crash
        between the two writes leaves the deletion durable with stale
        versions; reopen reads the file directly, and any live reader
        catches up at the next version bump. Returns newly-deleted
        count (already-deleted rows are idempotent no-ops)."""
        if not self._locked:
            raise StoreError("store opened read-only")
        if space not in self.spaces():
            raise StoreError(f"unknown dense vector space {space!r} "
                             f"(have {sorted(self.spaces())})")
        rows = np.unique(np.asarray(list(rows), np.int64).reshape(-1))
        if rows.size == 0:
            return 0
        if rows.min() < 0 or rows.max() >= self.count:
            raise StoreError(
                f"row ids must be in [0, {self.count}), got "
                f"[{rows.min()}, {rows.max()}]")
        dels = self._read_deleted()
        have = dels.get(space, np.zeros(0, np.int64))
        merged = np.union1d(have, rows)
        added = int(merged.size - have.size)
        if added == 0:
            return 0
        dels[space] = merged
        self._write_deleted(dels)
        self.data_version += 1
        self.vector_version += 1
        self._write_meta()
        return added

    def update_sparse_vectors(self, rows, sparse_rows, space: str) -> int:
        """Overwrite the sparse vectors of existing rows — the sparse
        side of qdrant's update_vectors. See `_update_ragged` for the
        crash-safety contract."""
        if space not in self.sparse:
            raise StoreError(f"unknown sparse space {space!r} "
                             f"(have {sorted(self.sparse)})")
        packed = []
        for r in sparse_rows:
            idx_a, val_a = check_sparse_row(r)
            rec = np.zeros(len(idx_a), SPARSE_ENTRY)
            rec["i"], rec["v"] = idx_a, val_a
            packed.append(rec.tobytes())
        return self._update_ragged(rows, packed, space)

    def update_multivectors(self, rows, multi_rows, space: str) -> int:
        """Overwrite the multivectors of existing rows — the
        multivector side of qdrant's update_vectors. See
        `_update_ragged` for the crash-safety contract."""
        if space not in self.multi:
            raise StoreError(f"unknown multivector space {space!r} "
                             f"(have {sorted(self.multi)})")
        d = self.multi[space]
        packed = [np.ascontiguousarray(check_multi_row(r, d)).tobytes()
                  for r in multi_rows]
        return self._update_ragged(rows, packed, space)

    def _update_ragged(self, rows, packed, space: str) -> int:
        """Overwrite the ragged-space records of existing rows.
        Ragged rows are variable width, so unlike the dense patch path
        this stages a full rewrite of the space's entry log + indptr
        through the SAME `.compact` + commit-marker journal as
        compact()/update_payloads (open() rolls an interrupted rewrite
        forward; pre-marker stage files are inert). Bumps all three
        versions — vector content changed. `packed` holds each row's
        raw record bytes."""
        if not self._locked:
            raise StoreError("store opened read-only")
        rows = np.asarray(list(rows), np.int64).reshape(-1)
        if len(packed) != len(rows):
            raise StoreError(
                f"{len(rows)} row ids but {len(packed)} vectors")
        if len(rows) == 0:
            return 0
        if rows.min() < 0 or rows.max() >= self.count:
            raise StoreError(
                f"row ids must be in [0, {self.count}), got "
                f"[{rows.min()}, {rows.max()}]")
        if len(np.unique(rows)) != len(rows):
            raise StoreError("duplicate row ids in ragged update")
        patch = dict(zip(rows.tolist(), packed))
        self.flush()
        self.close_files_for_truncate()

        ent_path, idx_path, rec_b = self._ragged_paths(space)
        indptr = np.memmap(idx_path, dtype="<i8", mode="r",
                           shape=(self.count,))
        total = int(indptr[-1])
        ent = np.memmap(ent_path, dtype=np.uint8, mode="r",
                        shape=(total, rec_b)) if total else \
            np.zeros((0, rec_b), np.uint8)
        with open(ent_path + ".compact", "wb") as out, \
                open(idx_path + ".compact", "wb") as idx_out:
            pos = 0
            obuf: list[int] = []
            for r in range(self.count):
                lo = int(indptr[r - 1]) if r else 0
                if r in patch:
                    raw = patch[r]
                    out.write(raw)
                    pos += len(raw) // rec_b
                else:
                    hi = int(indptr[r])
                    if hi > lo:
                        out.write(np.ascontiguousarray(
                            ent[lo:hi]).tobytes())
                    pos += hi - lo
                obuf.append(pos)
                if len(obuf) == 65536:
                    idx_out.write(np.asarray(obuf, "<i8").tobytes())
                    obuf.clear()
            if obuf:
                idx_out.write(np.asarray(obuf, "<i8").tobytes())
            out.flush()
            os.fsync(out.fileno())
            idx_out.flush()
            os.fsync(idx_out.fileno())
        del ent, indptr

        now_meta = self._meta_dict(bump_data=1, bump_vec=1, bump_epoch=1)
        marker = os.path.join(self.path, COMPACT_MARKER)
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            json.dump(now_meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, marker)      # <- commit point (roll forward)
        for full in (ent_path, idx_path):
            try:
                os.replace(full + ".compact", full)
            except FileNotFoundError:
                pass    # a recovery pass (stale-lock takeover) won the race
        self.data_version = now_meta["data_version"]
        self.vector_version = now_meta["vector_version"]
        self.mutation_epoch = now_meta["mutation_epoch"]
        self._write_meta()
        try:
            os.remove(marker)
        except FileNotFoundError:
            pass      # a concurrent reader's open() already rolled forward
        return len(rows)

    @staticmethod
    def _apply_vec_patch(path: str, rows, vecs, space: str = "") -> None:
        """Idempotent absolute-offset writes of the patch rows, plus
        the delete_vectors resurrect: a rewritten row has a vector
        again (qdrant semantics). Running the resurrect HERE puts it
        inside the patch journal — the roll-forward replays it, so a
        crash anywhere in update_vectors still lands the full post-op
        state (the crash-fuzz's atomic-visibility invariant)."""
        vec_path = os.path.join(path, vec_file(space))
        row_bytes = vecs.shape[1] * 4
        with open(vec_path, "r+b") as f:
            for r, v in zip(rows.tolist(), vecs):
                f.seek(r * row_bytes)
                f.write(v.tobytes())
            f.flush()
            os.fsync(f.fileno())
        VectorStore._resurrect_deleted(path, rows.tolist(), space)

    @staticmethod
    def _resurrect_deleted(dir_path: str, rows, space: str) -> None:
        """Drop `rows` from the delete_vectors mask of `space`
        (idempotent; atomic rewrite; a missing/foreign file is left
        alone)."""
        p = os.path.join(dir_path, DELETED_FILE)
        try:
            with open(p) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(raw, dict):
            return
        ids = raw.get(space)
        if not isinstance(ids, list):
            return
        gone = {int(r) for r in rows}
        keep = [i for i in ids
                if not (isinstance(i, int) and not isinstance(i, bool)
                        and i in gone)]
        if len(keep) == len(ids):
            return
        if keep:
            raw[space] = keep
        else:
            raw.pop(space)
        if raw:
            tmp = p + ".tmp"
            with open(tmp, "w") as f:
                json.dump(raw, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, p)
        else:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    @staticmethod
    def _recover_vec_patch(path: str) -> None:
        """Roll an interrupted vector patch forward: the committed
        `vectors.patch` holds everything needed (ids + rows + the
        post-apply meta), and its writes are idempotent. A live lock
        holder is applying it right now — back off (same contract as
        `_recover_compact`). A corrupt/mismatched patch is dropped:
        pre-commit crashes only ever leave a `.tmp`, so a named patch
        that doesn't parse predates this code or lost its store."""
        if _lock_holder_alive_at(path):
            return
        patch = os.path.join(path, VEC_PATCH)
        if not os.path.exists(patch):
            return
        # Phase 1 — judge the patch. Only an explicit stale/corrupt/
        # mismatch verdict may DROP it; an apply-time I/O failure must
        # KEEP it (the patch is the only copy of the committed rows —
        # deleting it after a partial apply would freeze a half-patched
        # vectors.bin under the old meta with nothing left to re-roll).
        try:
            with np.load(patch, allow_pickle=False) as z:
                rows = np.asarray(z["rows"], np.int64)
                vecs = np.asarray(z["vecs"], np.float32)
                meta = json.loads(str(z["meta"]))
                space = str(z["space"]) if "space" in z.files else ""
            vec_path = os.path.join(path, vec_file(space))
            need = (int(rows.max()) + 1) * vecs.shape[1] * 4 \
                if len(rows) else 0
            with open(os.path.join(path, META_FILE)) as f:
                cur = json.load(f)
            space_dim = (meta["dim"] if not space
                         else (meta.get("named") or {}).get(space))
            drop = (space_dim != vecs.shape[1]
                    or not os.path.exists(vec_path)
                    or os.path.getsize(vec_path) < need
                    # a patch not beyond the live meta is a leftover
                    # whose removal failed after later mutations —
                    # replaying it would roll newer data back
                    or int(cur.get("data_version", 0))
                    >= meta["data_version"])
        except Exception:
            drop = True           # unreadable: pre-dates this code
        if drop:
            try:
                os.remove(patch)
            except OSError:
                pass
            return
        # Phase 2 — apply. Any failure here leaves the patch in place
        # for the next open() to retry (writes are idempotent).
        VectorStore._apply_vec_patch(path, rows, vecs, space)
        tmp = os.path.join(path, META_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, META_FILE))
        try:
            os.remove(patch)
        except OSError:
            pass

    @staticmethod
    def _recover_compact(path: str) -> None:
        """Complete a compaction interrupted after its commit marker
        landed: finish the staged-file renames (idempotent), install
        the marker's meta, drop the marker. Without a marker, stage
        files are leftovers of a pre-commit crash — removed
        best-effort; the original files are untouched and authoritative.

        A LIVE lock holder means a compaction may be in flight in that
        process right now: pre-marker stage files are its work product
        (sweeping them would make its post-marker renames fail), and
        post-marker roll-forward is its job — so recovery backs off
        entirely and lets the writer finish. Only a lock-free or
        stale-lock (dead PID) store is recovered here."""
        if _lock_holder_alive_at(path):
            return
        marker = os.path.join(path, COMPACT_MARKER)
        # discover stage files dynamically: named vector spaces stage
        # one vectors_<name>.bin.compact each, so a static list would
        # strand (pre-marker) or lose (post-marker) their data
        staged = [os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith(".compact")]
        if not os.path.exists(marker):
            for s in staged:
                if os.path.exists(s):
                    try:
                        os.remove(s)
                    except OSError:
                        pass
            return
        try:
            with open(marker) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            # torn marker write can't happen (tmp+rename), but a
            # half-written legacy one must not brick the store
            os.remove(marker)
            return
        for s in staged:
            if os.path.exists(s):
                try:
                    os.replace(s, s[: -len(".compact")])
                except FileNotFoundError:
                    pass        # another opener won the rename race
        tmp = os.path.join(path, META_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, META_FILE))
        try:
            os.remove(marker)
        except FileNotFoundError:
            pass

    # -- snapshots (export / import) -----------------------------------

    def export_snapshot(self, out_path: str) -> str:
        """Write a portable single-file snapshot (uncompressed tar) of
        the committed rows: meta.json + the exact byte prefixes of
        vectors.bin / payloads.jsonl / payloads.idx covering `count`
        rows — the role qdrant's collection snapshots play for the
        reference's store (its app exposed none; the capability is the
        store's). The cut is taken at the current committed count, so
        a concurrent append in another process can't tear the archive;
        derived caches (`index/`) and the lock file are deliberately
        excluded (rebuilt on demand, keyed on data_version).
        """
        import io as _io
        import tarfile

        self.flush()
        count = self.count
        pay_bytes = self._payload_cut(count)
        meta = self._meta_dict(count=count)
        tmp = out_path + ".tmp"
        try:
            with tarfile.open(tmp, "w") as tar:
                raw = json.dumps(meta, indent=2).encode()
                info = tarfile.TarInfo(META_FILE)
                info.size = len(raw)
                tar.addfile(info, _io.BytesIO(raw))

                def add_prefix(fname: str, nbytes: int) -> None:
                    src = os.path.join(self.path, fname)
                    have = os.path.getsize(src) if os.path.exists(src) else 0
                    if have < nbytes:
                        raise StoreError(
                            f"cannot snapshot {self.name}: {fname} holds "
                            f"{have} bytes, committed rows need {nbytes}")
                    info = tarfile.TarInfo(fname)
                    info.size = nbytes
                    if nbytes == 0:
                        tar.addfile(info, _io.BytesIO(b""))
                        return
                    with open(src, "rb") as f:
                        tar.addfile(info, f)   # reads exactly `size` bytes

                for space, d in self.spaces().items():
                    add_prefix(vec_file(space), count * 4 * d)
                for space in self._ragged():
                    e, i, rec = self._ragged_paths(space)
                    add_prefix(os.path.basename(e),
                               self._ragged_total(space, count) * rec)
                    add_prefix(os.path.basename(i), count * 8)
                # delete_vectors mask: always-consistent whole file
                # (atomic writes); ids beyond the snapshot count are
                # clipped on read after import
                dels = self._read_deleted()
                if dels:
                    raw = json.dumps({s: v.tolist()
                                      for s, v in dels.items()}).encode()
                    info = tarfile.TarInfo(DELETED_FILE)
                    info.size = len(raw)
                    tar.addfile(info, _io.BytesIO(raw))
                add_prefix(PAYLOAD_FILE, pay_bytes)
                # sidecar may legitimately trail (legacy stores): ship
                # what exists; import rebuilds the rest on first access
                idx_have = 0
                idx_path = os.path.join(self.path, PAYLOAD_IDX_FILE)
                if os.path.exists(idx_path):
                    idx_have = min(os.path.getsize(idx_path) // 8, count) * 8
                add_prefix(PAYLOAD_IDX_FILE, idx_have)
            os.replace(tmp, out_path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        return out_path

    @staticmethod
    def import_snapshot(root: str, name: str, snapshot_path: str, *,
                        overwrite: bool = False) -> "VectorStore":
        """Restore a snapshot as database `name` under `root`.

        Extraction is validated (only the four known member names, no
        links/paths) and staged into a temp directory, sizes checked
        against the snapshot meta, then atomically moved into place.
        The imported store gets FRESH data_version/mutation_epoch so
        any derived caches from a prior incarnation of `name` never
        alias it. Returns a read-only handle.
        """
        import tarfile

        path = os.path.join(root, name)
        if os.path.isdir(path):
            if not overwrite:
                raise StoreError(f"Database already exists: {name}")
            if os.path.exists(os.path.join(path, LOCK_FILE)):
                raise StoreLockedError(
                    f"Database '{name}' is locked; unlock it first")
        os.makedirs(root, exist_ok=True)
        tmp_dir = os.path.join(root, f".import-{name}-{os.getpid()}")
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        try:
            with tarfile.open(snapshot_path, "r") as tar:
                members = tar.getmembers()
                names = {m.name for m in members}
                if META_FILE not in names:
                    raise StoreError(
                        f"not a reverso snapshot: members {sorted(names)}")
                meta_member = tar.extractfile(META_FILE)
                meta = json.loads(meta_member.read())
                named = _check_spaces(meta.get("named") or {})
                sparse = _check_sparse_spaces(meta.get("sparse") or {},
                                              named)
                multi = _check_multi_spaces(meta.get("multi") or {},
                                            {**named, **sparse})
                allowed = ({META_FILE, VEC_FILE, PAYLOAD_FILE,
                            PAYLOAD_IDX_FILE, DELETED_FILE}
                           | {vec_file(s) for s in named}
                           | {SPARSE_FMT.format(s) for s in sparse}
                           | {SPARSE_IDX_FMT.format(s) for s in sparse}
                           | {MULTI_FMT.format(s) for s in multi}
                           | {MULTI_IDX_FMT.format(s) for s in multi})
                bad = names - allowed
                if bad:
                    raise StoreError(
                        f"not a reverso snapshot: members {sorted(names)}")
                for m in members:
                    if not m.isreg():
                        raise StoreError(
                            f"refusing non-regular snapshot member {m.name}")
                    with open(os.path.join(tmp_dir, m.name), "wb") as out:
                        shutil.copyfileobj(tar.extractfile(m), out)
            with open(os.path.join(tmp_dir, META_FILE)) as f:
                meta = json.load(f)
            dim, count = int(meta["dim"]), int(meta["count"])
            for space, d in {"": dim, **named}.items():
                fname = vec_file(space)
                vec_size = os.path.getsize(os.path.join(tmp_dir, fname)) \
                    if fname in names else 0
                if vec_size != count * 4 * d:
                    raise StoreError(
                        f"corrupt snapshot: {count} rows x dim {d} "
                        f"({fname}) needs {count * 4 * d} bytes, archive "
                        f"has {vec_size}")
            ragged = [(s, SPARSE_FMT.format(s), SPARSE_IDX_FMT.format(s),
                       SPARSE_ENTRY.itemsize) for s in sparse]
            ragged += [(s, MULTI_FMT.format(s), MULTI_IDX_FMT.format(s),
                        4 * d) for s, d in multi.items()]
            for space, ename, iname, rec in ragged:
                ipath = os.path.join(tmp_dir, iname)
                isize = os.path.getsize(ipath) if iname in names else 0
                if isize != count * 8:
                    raise StoreError(
                        f"corrupt snapshot: space {space!r} indptr "
                        f"needs {count * 8} bytes, archive has {isize}")
                total = 0
                if count:
                    with open(ipath, "rb") as f:
                        f.seek((count - 1) * 8)
                        total = int(np.frombuffer(f.read(8), "<i8")[0])
                esize = os.path.getsize(os.path.join(tmp_dir, ename)) \
                    if ename in names else 0
                if esize != total * rec:
                    raise StoreError(
                        f"corrupt snapshot: space {space!r} needs "
                        f"{total * rec} entry bytes, "
                        f"archive has {esize}")
            now = time.time_ns()
            meta.update({"name": name, "collection": collection_name(name),
                         "data_version": now, "vector_version": now,
                         "mutation_epoch": now})
            with open(os.path.join(tmp_dir, META_FILE), "w") as f:
                json.dump(meta, f, indent=2)
                f.flush()
                os.fsync(f.fileno())
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.replace(tmp_dir, path)
        except BaseException:
            if os.path.isdir(tmp_dir):
                shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        return VectorStore.open(root, name)
