"""Payload filters: qdrant-style metadata conditions compiled to a row mask.

The reference embeds qdrant local mode as its store, whose search API
accepts payload filters (must / should / must_not conditions) even
though the app itself only ever passed `score_threshold`
(reference core_system.py:659-664). This module supplies that
capability for the TPU store: a filter is parsed host-side, payload
columns are extracted once per store version into numpy arrays, and
the filter evaluates to a boolean row mask. The device kernels apply
the mask exactly (masked rows score -inf before k-selection), so
filtered search keeps the exact `(-score, idx)` result contract —
a filtered top-k equals the brute-force scan over the matching subset.

Filter spec (dict form, qdrant-shaped):

    {"must":     [cond, ...],   # all must match
     "should":   [cond, ...],   # at least one must match (if present)
     "must_not": [cond, ...]}   # none may match

with each condition one of

    {"key": K, "match": v}              # payload[K] == v
    {"key": K, "match": {"value": v}}   # qdrant's canonical wrapper
    {"key": K, "match": {"any": [...]}} # qdrant's set-match wrapper
    {"key": K, "match": {"except": [...]}}  # none of the listed values
    {"key": K, "match": {"text": "q"}}  # token containment (see below)
    {"key": K, "match": {"phrase": "q"}}  # consecutive tokens (see below)
    {"key": K, "any": [v1, v2, ...]}    # payload[K] in {v1, v2, ...}
    {"key": K, "range": {"gt"|"gte"|"lt"|"lte": x, ...}}
    {"key": K, "datetime_range": {...}} # bounds are RFC 3339 strings
    {"key": K, "values_count": {...}}   # list length (1 scalar, 0 absent)
    {"key": K, "geo_bounding_box": {"top_left": P, "bottom_right": P}}
    {"key": K, "geo_radius": {"center": P, "radius": meters}}
    {"key": K, "geo_polygon": {"exterior": RING, "interiors": [RING..]}}
    {"is_empty": {"key": K}}            # absent, null, or [] payload
    {"is_null": {"key": K}}             # present and exactly null
    {"has_id": [id, ...]}               # row ids (int) / region_id (str)
    {"has_vector": "space"}             # point has that vector set
    {"nested": {"key": K, "filter": F}} # one array ELEMENT matches F
    nested filter dict                  # recursive must/should/must_not

where P is a geo point `{"lon": x, "lat": y}` (payload values may also
be a LIST of such points — the row matches when any point does) and
RING is `{"points": [P, ...]}` (closed automatically).

plus shorthand: a dict without must/should/must_not is a conjunction,
`{"detected_class": "person", "confidence": {"gte": 0.5}}` — scalar
values mean `match`, lists mean `any`, range-keyed dicts mean `range`
(`has_id`/`is_empty`/`is_null` keep their condition meaning here too).

String form (the CLI's `--filter`): comma-separated clauses
`key=value`, `key!=value`, `key>=x`, `key<=x`, `key>x`, `key<x`;
numeric-looking values compare numerically for the ordered operators.

Clause-level extras: `{"min_should": {"conditions": [...],
"min_count": n}}` beside must/should/must_not — at least `min_count`
of the listed conditions hold (qdrant's MinShould).

Keys are qdrant payload PATHS: dots descend nested objects and arrays
traverse implicitly (`a.b` == `a[].b` when `a` holds an array of
objects), so `meta.labels[].name=car` works in every condition,
order_by, facet, and group_by. Path columns derive once per store
version and persist in the column cache like plain keys.

Semantics notes (all pinned by tests/test_filter.py):

- Equality is PYTHON equality (`True == 1`, big ints compare exactly)
  with qdrant's ARRAY semantics on top: a LIST payload matches when
  ANY element matches, for match/any/except/range/datetime_range/
  text alike (a dict payload still never equals a scalar, and exact
  whole-list equality remains available by passing a list as the
  match value). `match {"except": [...]}` is the exact complement of
  `match {"any": [...]}`: it matches rows where NO stored value is
  any listed value — including rows missing the key entirely (an
  empty value set trivially contains none of the listed values;
  qdrant behaves the same way).
- `nested` requires ONE element of an array-of-objects payload to
  satisfy the whole inner filter — `{"key": "items", "filter":
  {"must": [a, b]}}` needs one element matching BOTH, whereas the
  path conditions `items.a`/`items.b` may each be satisfied by a
  different element. has_id is not allowed inside (elements have no
  point id).
- `match {"text": q}`: both sides lowercase and tokenize on \\w+ runs;
  the row matches when every query token appears among the value's
  tokens (qdrant's word-tokenizer full-text match; no index needed —
  evaluation is once per UNIQUE string thanks to the dictionary-coded
  view). Non-string payloads never match.
- `match {"phrase": q}`: qdrant 1.15's MatchPhrase — same lowercase
  \\w+ tokenization, but the query tokens must appear CONSECUTIVELY
  and in order among the value's tokens ("good cheap" matches
  "a good cheap tool", not "cheap but good"). qdrant requires a text
  index with `phrase_matching: true`; here the dictionary-coded view
  plays that role and no index declaration is needed. A single-token
  phrase degenerates to token containment, like qdrant's.
- `datetime_range`: payload values must be RFC 3339 / ISO 8601
  strings (naive timestamps are taken as UTC, like qdrant);
  unparseable or non-string values never match.
- `values_count`: a list payload counts len(list); any other present
  value counts 1; a missing key counts 0 (so `{"lt": 1}` matches
  rows without the key).
- Geo conditions: `geo_bounding_box` handles date-line-crossing boxes
  (top_left.lon > bottom_right.lon); `geo_radius` is great-circle
  (haversine, mean earth radius 6 371 008.8 m, matching qdrant's geo
  crate); `geo_polygon` is even-odd ray casting in lon/lat with
  interior rings subtracted. Rows without a parseable geo value never
  match.
- `has_id`: integer ids select store rows directly; string ids match
  the `region_id` payload (the point-id role — see Reverso.retrieve).
- `has_vector`: qdrant's HasVectorCondition. Dense spaces ("" = the
  default space) are populated for every committed row EXCEPT rows
  whose vector was removed via delete_vectors (the store's
  deleted-rows mask); sparse/multivector spaces match rows with at
  least one stored entry (a row appended as None/empty, or cleared by
  delete_vectors, has no vector). Unknown space names are a
  FilterError (caught before any scan, like every other malformed
  spec).
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

_RANGE_OPS = ("gt", "gte", "lt", "lte")
# ops that appear alongside "key" in a condition dict
_KEYED_OPS = ("match", "any", "range", "datetime_range", "values_count",
              "exists", "geo_bounding_box", "geo_radius", "geo_polygon")
# the payload key holding the point-id string (see Reverso.retrieve)
ID_KEY = "region_id"
# qdrant distances go through the `geo` crate's haversine with the
# IUGG mean earth radius; matching it keeps radius thresholds portable
_EARTH_RADIUS_M = 6_371_008.8
_TOKEN_RE = re.compile(r"\w+", re.UNICODE)


class FilterError(ValueError):
    """Malformed filter spec."""


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Condition:
    key: str
    op: str        # _KEYED_OPS | "except" | "text" | "phrase" | "is_empty"
    #                | "is_null" | "has_id"
    value: Any = None

    def keys(self) -> set:
        if self.op == "has_vector":
            return set()          # answered by the store, not payloads
        if self.op == "has_id":
            # the id column is only needed when string ids are present;
            # pure-row-id filters must not force extracting the
            # (all-unique, expensive) region_id column
            return ({ID_KEY} if any(isinstance(v, str)
                                    for v in self.value) else set())
        return {self.key}


@dataclass(frozen=True)
class Filter:
    must: tuple = ()
    should: tuple = ()
    must_not: tuple = ()
    min_should: tuple = ()       # qdrant's min_should.conditions
    min_count: int = 0           # ... of which at least this many match

    def keys(self) -> set:
        out: set = set()
        for clause in (self.must, self.should, self.must_not,
                       self.min_should):
            for c in clause:
                out |= c.keys()
        return out

    def is_empty(self) -> bool:
        return not (self.must or self.should or self.must_not
                    or self.min_should)


def _has_phrase(qseq: list, toks: list) -> bool:
    """True when `qseq` appears as a CONSECUTIVE run inside `toks`
    (qdrant MatchPhrase semantics; parse guarantees qseq non-empty)."""
    span = len(qseq)
    first = qseq[0]
    return any(toks[i] == first and toks[i:i + span] == qseq
               for i in range(len(toks) - span + 1))


def _iso_compat(text: str) -> str:
    """fromisoformat only accepts the RFC 3339 'Z' suffix on 3.11+;
    normalize it so supported 3.10 parses the canonical form too."""
    return text[:-1] + "+00:00" if text[-1:] in ("Z", "z") else text


def _parse_datetime(value: Any, *, what: str) -> float:
    """RFC 3339 / ISO 8601 string (or datetime) -> epoch seconds.
    Naive timestamps are taken as UTC, matching qdrant."""
    import datetime as _dt
    if isinstance(value, _dt.datetime):
        dt = value
    elif isinstance(value, str):
        try:
            dt = _dt.datetime.fromisoformat(_iso_compat(value))
        except ValueError:
            raise FilterError(
                f"{what}: not an RFC 3339 timestamp: {value!r}") from None
    else:
        raise FilterError(
            f"{what}: expected an RFC 3339 string, got {value!r}")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt.timestamp()


def _dt_or_nan(text: str) -> float:
    """Payload-side datetime parse: unparseable -> NaN (never matches)."""
    import datetime as _dt
    try:
        dt = _dt.datetime.fromisoformat(_iso_compat(text))
    except (ValueError, TypeError):
        return float("nan")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt.timestamp()


def _geo_point(obj: Any, *, what: str) -> tuple:
    """{"lon": x, "lat": y} -> (lon, lat) floats, validated."""
    if not isinstance(obj, dict) or not {"lon", "lat"} <= set(obj):
        raise FilterError(f"{what}: geo point must be a dict with "
                          f"'lon' and 'lat', got {obj!r}")
    try:
        lon, lat = float(obj["lon"]), float(obj["lat"])
    except (TypeError, ValueError):
        raise FilterError(f"{what}: non-numeric lon/lat: {obj!r}") from None
    return lon, lat


def _geo_ring(obj: Any, *, what: str) -> tuple:
    """{"points": [P, ...]} -> ((lon, lat), ...) with the closing
    duplicate point dropped; needs >= 3 distinct vertices."""
    if not isinstance(obj, dict) or "points" not in obj:
        raise FilterError(f"{what}: ring must be {{'points': [...]}}, "
                          f"got {obj!r}")
    pts = [_geo_point(p, what=what) for p in obj["points"]]
    if len(pts) >= 2 and pts[0] == pts[-1]:
        pts = pts[:-1]                       # accept pre-closed rings
    if len(pts) < 3:
        raise FilterError(f"{what}: ring needs at least 3 distinct "
                          f"points, got {len(pts)}")
    return tuple(pts)


def _range_dict(value: Any, *, key: str, op: str,
                coerce=float) -> dict:
    if not isinstance(value, dict) or not value or \
            not set(value) <= set(_RANGE_OPS):
        raise FilterError(
            f"{op} for key {key!r} must be a dict with keys from "
            f"{_RANGE_OPS}, got {value!r}")
    return {k: coerce(v) for k, v in value.items()}


def _path_segments(key: str) -> Optional[list]:
    """'a.b[].c' -> ['a', 'b', 'c']; None for plain (non-path) keys.

    Dots separate nested-object segments and a '[]' suffix marks array
    projection, qdrant's payload-path syntax; arrays also traverse
    implicitly, so 'a.b' and 'a[].b' behave identically when `a` holds
    an array (as in qdrant). A payload key that literally contains a
    dot is not addressable through filters (same qdrant limitation)."""
    if "." not in key and not key.endswith("[]"):
        return None
    segs = [s[:-2] if s.endswith("[]") else s for s in key.split(".")]
    if any(not s or "[" in s or "]" in s for s in segs):
        raise FilterError(f"bad payload path {key!r}")
    return segs


def _normalize_key(key: str) -> str:
    """Canonical spelling of a payload key/path ('a[].b' -> 'a.b') so
    column caches and ensure() see one name per path."""
    segs = _path_segments(key)
    return ".".join(segs) if segs else key


def _collect_path(value: Any, segs: list, si: int, out: list) -> bool:
    """Walk one payload value along path segments, appending leaf
    values to `out`. Lists traverse implicitly (qdrant style), so the
    result is multi-valued whenever a list was crossed — returns True
    then (the caller stores the collected leaves as an array)."""
    if isinstance(value, list):
        for e in value:
            _collect_path(e, segs, si, out)
        return True
    if si == len(segs):
        out.append(value)
        return False
    if isinstance(value, dict) and segs[si] in value:
        return _collect_path(value[segs[si]], segs, si + 1, out)
    return False


def _walk_conditions(filt: "Filter"):
    for clause in (filt.must, filt.should, filt.must_not,
                   filt.min_should):
        for c in clause:
            if isinstance(c, Filter):
                yield from _walk_conditions(c)
            else:
                yield c
                if c.op == "nested":
                    yield from _walk_conditions(c.value)


def _parse_nested(inner: Any) -> Condition:
    """qdrant's nested condition: `{"nested": {"key": K, "filter":
    F}}` — a row matches when at least one OBJECT ELEMENT of the array
    payload at K satisfies the whole inner filter (all inner
    conditions evaluated against the SAME element, unlike independent
    path conditions)."""
    if not isinstance(inner, dict) or \
            not {"key", "filter"} <= set(inner) or \
            not set(inner) <= {"key", "filter"}:
        raise FilterError(
            f"nested needs {{'key': K, 'filter': {{...}}}}, got {inner!r}")
    key = inner["key"]
    if not isinstance(key, str):
        raise FilterError(f"nested key must be a string, got {key!r}")
    filt = parse_filter(inner["filter"])
    for c in _walk_conditions(filt):
        if c.op in ("has_id", "has_vector"):
            raise FilterError(f"{c.op} is not allowed inside a nested "
                              "filter (elements have no point identity)")
    return Condition(_normalize_key(key), "nested", filt)


def _parse_keyless(spec: dict) -> Optional[Condition]:
    """The three qdrant condition forms that carry no payload 'key':
    has_id / is_empty / is_null. Returns None when `spec` is not one."""
    if set(spec) == {"has_id"}:
        ids = spec["has_id"]
        if isinstance(ids, (str, int)):
            ids = [ids]
        if not isinstance(ids, (list, tuple)) or not all(
                isinstance(v, (str, int)) and not isinstance(v, bool)
                for v in ids):
            raise FilterError(
                f"has_id needs a list of int row ids / str region ids, "
                f"got {spec['has_id']!r}")
        return Condition(ID_KEY, "has_id", tuple(ids))
    if set(spec) == {"has_vector"}:
        space = spec["has_vector"]
        if not isinstance(space, str):
            raise FilterError(f"has_vector needs a vector space name "
                              f"string, got {spec['has_vector']!r}")
        return Condition("", "has_vector", space)
    for name in ("is_empty", "is_null"):
        if set(spec) == {name}:
            target = spec[name]
            if isinstance(target, dict) and set(target) == {"key"}:
                target = target["key"]
            if not isinstance(target, str):
                raise FilterError(
                    f"{name} needs {{'key': K}} or a key string, "
                    f"got {spec[name]!r}")
            return Condition(_normalize_key(target), name)
    return None


def _parse_condition(spec: Any) -> "Condition | Filter":
    if isinstance(spec, (Filter, Condition)):
        return spec
    if not isinstance(spec, dict):
        raise FilterError(f"condition must be a dict, got {type(spec).__name__}")
    if any(k in spec for k in ("must", "should", "must_not",
                               "min_should")):
        return parse_filter(spec)
    if set(spec) == {"nested"}:
        return _parse_nested(spec["nested"])
    keyless = _parse_keyless(spec)
    if keyless is not None:
        return keyless
    if "key" in spec:
        key = spec["key"]
        ops = [k for k in _KEYED_OPS if k in spec]
        if len(ops) != 1:
            raise FilterError(
                f"condition for key {key!r} needs exactly one of "
                f"{'/'.join(_KEYED_OPS)}, got {sorted(spec)}")
        op = ops[0]
        value = spec[op]
        if op == "match" and isinstance(value, dict):
            # qdrant's canonical wrappers: {"match": {"value": v}},
            # {"match": {"any": [...]}}, {"match": {"except": [...]}},
            # {"match": {"text": "..."}} — unwrap rather than comparing
            # the wrapper dict itself (which would silently match nothing)
            if set(value) == {"value"}:
                value = value["value"]
            elif set(value) == {"any"}:
                op, value = "any", value["any"]
            elif set(value) == {"except"}:
                op, value = "except", value["except"]
            elif set(value) == {"text"}:
                op, value = "text", value["text"]
            elif set(value) == {"phrase"}:
                op, value = "phrase", value["phrase"]
            else:
                raise FilterError(
                    f"match for key {key!r} must be a scalar, "
                    f"{{'value': v}}, {{'any': [...]}}, "
                    f"{{'except': [...]}}, {{'text': s}}, or "
                    f"{{'phrase': s}}, got {value!r}")
        if op == "range":
            value = _range_dict(value, key=key, op=op)
        elif op == "datetime_range":
            value = _range_dict(
                value, key=key, op=op,
                coerce=lambda v: _parse_datetime(
                    v, what=f"datetime_range for key {key!r}"))
        elif op == "values_count":
            def _count_bound(v):
                # exact ints only: int() would truncate 2.5 into an
                # off-by-one bound, and a TypeError would escape the
                # FilterError handlers that 400 at the UI/CLI boundary
                if isinstance(v, bool) or not isinstance(v, int):
                    raise FilterError(
                        f"values_count bound for key {key!r} must be "
                        f"an int, got {v!r}")
                return v
            value = _range_dict(value, key=key, op=op,
                                coerce=_count_bound)
        elif op in ("any", "except"):
            if not isinstance(value, (list, tuple, set)):
                raise FilterError(
                    f"{op} for key {key!r} needs a list, got {value!r}")
            value = tuple(value)
        elif op in ("text", "phrase"):
            if not isinstance(value, str):
                raise FilterError(
                    f"{op} match for key {key!r} needs a string, "
                    f"got {value!r}")
            if not _TOKEN_RE.search(value):
                # an empty token set would vacuously match every row
                # holding any string — reject at parse so UI/CLI
                # callers 400 instead of selecting everything
                raise FilterError(
                    f"{op} match for key {key!r} has no word tokens: "
                    f"{value!r}")
        elif op == "exists":
            value = bool(value)
        elif op == "geo_bounding_box":
            what = f"geo_bounding_box for key {key!r}"
            if not isinstance(value, dict) or \
                    not {"top_left", "bottom_right"} <= set(value):
                raise FilterError(f"{what}: needs top_left and "
                                  f"bottom_right points, got {value!r}")
            value = {"top_left": _geo_point(value["top_left"], what=what),
                     "bottom_right": _geo_point(value["bottom_right"],
                                                what=what)}
        elif op == "geo_radius":
            what = f"geo_radius for key {key!r}"
            if not isinstance(value, dict) or \
                    not {"center", "radius"} <= set(value):
                raise FilterError(f"{what}: needs center point and "
                                  f"radius meters, got {value!r}")
            try:
                radius = float(value["radius"])
            except (TypeError, ValueError):
                raise FilterError(f"{what}: non-numeric radius: "
                                  f"{value['radius']!r}") from None
            if radius < 0:
                raise FilterError(f"{what}: negative radius")
            value = {"center": _geo_point(value["center"], what=what),
                     "radius": radius}
        elif op == "geo_polygon":
            what = f"geo_polygon for key {key!r}"
            if not isinstance(value, dict) or "exterior" not in value:
                raise FilterError(f"{what}: needs an exterior ring, "
                                  f"got {value!r}")
            value = {"exterior": _geo_ring(value["exterior"], what=what),
                     "interiors": tuple(
                         _geo_ring(r, what=what)
                         for r in value.get("interiors") or ())}
        return Condition(_normalize_key(str(key)), op, value)
    raise FilterError(f"condition dict needs a 'key': {spec!r}")


def _shorthand_condition(key: str, value: Any) -> Condition:
    key = _normalize_key(key)
    if isinstance(value, dict):
        if set(value) <= set(_RANGE_OPS) and value:
            return Condition(key, "range", {k: float(v)
                                            for k, v in value.items()})
        raise FilterError(
            f"shorthand value for {key!r} must be a scalar, list, or "
            f"range dict ({_RANGE_OPS}), got {value!r}")
    if isinstance(value, (list, tuple, set)):
        return Condition(key, "any", tuple(value))
    return Condition(key, "match", value)


def parse_filter(spec: Any) -> Filter:
    """Normalize any accepted spec (dict, string, Filter) to a Filter."""
    if spec is None:
        return Filter()
    if isinstance(spec, Filter):
        return spec
    if isinstance(spec, str):
        return _parse_filter_string(spec)
    if isinstance(spec, (list, tuple)):
        # list of string clauses (repeatable CLI flag)
        merged = Filter()
        for part in spec:
            f = parse_filter(part)
            if f.min_should and merged.min_should:
                raise FilterError("at most one min_should clause per "
                                  "filter")
            merged = Filter(merged.must + f.must, merged.should + f.should,
                            merged.must_not + f.must_not,
                            merged.min_should or f.min_should,
                            merged.min_count or f.min_count)
        return merged
    if not isinstance(spec, dict):
        raise FilterError(f"cannot parse filter from {type(spec).__name__}")
    if any(k in spec for k in ("must", "should", "must_not",
                               "min_should")):
        extra = set(spec) - {"must", "should", "must_not", "min_should"}
        if extra:
            raise FilterError(f"unknown filter clauses: {sorted(extra)}")

        def clause(name: str) -> tuple:
            items = spec.get(name, ())
            if isinstance(items, dict):
                items = (items,)
            return tuple(_parse_condition(c) for c in items)
        ms_conds: tuple = ()
        ms_count = 0
        ms = spec.get("min_should")
        if ms is not None:
            # qdrant's form: at least min_count of the conditions hold
            if not isinstance(ms, dict) or \
                    not {"conditions", "min_count"} <= set(ms) or \
                    not set(ms) <= {"conditions", "min_count"}:
                raise FilterError(
                    "min_should needs {'conditions': [...], "
                    f"'min_count': n}}, got {ms!r}")
            items = ms["conditions"]
            if isinstance(items, dict):
                items = (items,)
            ms_conds = tuple(_parse_condition(c) for c in items)
            if isinstance(ms["min_count"], bool) or \
                    not isinstance(ms["min_count"], int) or \
                    ms["min_count"] < 1:
                raise FilterError(f"min_should.min_count must be a "
                                  f"positive int, got {ms['min_count']!r}")
            ms_count = ms["min_count"]
        return Filter(clause("must"), clause("should"),
                      clause("must_not"), ms_conds, ms_count)
    if "key" in spec and any(k in spec for k in _KEYED_OPS):
        return Filter((_parse_condition(spec),))     # bare condition dict
    if set(spec) == {"nested"}:                      # bare nested cond
        return Filter((_parse_nested(spec["nested"]),))
    keyless = _parse_keyless(spec)
    if keyless is not None:      # bare {"has_id"/"is_empty"/"is_null": ..}
        return Filter((keyless,))
    conds = []
    for k, v in spec.items():
        if k in ("has_id", "has_vector", "is_empty", "is_null"):
            # keep the condition meaning inside shorthand conjunctions
            # too (a payload key literally named e.g. "has_id" must use
            # the explicit {"key": "has_id", ...} form instead)
            conds.append(_parse_keyless({k: v}))
        elif k == "nested":
            conds.append(_parse_nested(v))
        else:
            conds.append(_shorthand_condition(k, v))
    return Filter(tuple(conds))


_CLAUSE_RE = re.compile(
    r"^\s*([A-Za-z0-9_.\-]+(?:\[\])?(?:\.[A-Za-z0-9_.\-]+(?:\[\])?)*)"
    r"\s*(>=|<=|!=|=|>|<)\s*(.*?)\s*$")


def _parse_scalar(text: str) -> Any:
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text.strip("\"'")


def _parse_filter_string(text: str) -> Filter:
    """`key=v,key2>=3` — comma-separated conjunction of clauses.

    A JSON object string is also accepted and parsed as the dict form.
    """
    text = text.strip()
    if not text:
        return Filter()
    if text.startswith("{"):
        try:
            return parse_filter(json.loads(text))
        except json.JSONDecodeError as e:
            raise FilterError(f"bad JSON filter: {e}") from None
    must, must_not = [], []
    for part in text.split(","):
        if not part.strip():
            continue
        m = _CLAUSE_RE.match(part)
        if not m:
            raise FilterError(
                f"bad filter clause {part!r} (expected key=value, "
                f"key!=value, or key{{<,<=,>,>=}}number)")
        key, op, raw = m.groups()
        key = _normalize_key(key)
        value = _parse_scalar(raw)
        if op == "=":
            must.append(Condition(key, "match", value))
        elif op == "!=":
            must_not.append(Condition(key, "match", value))
        else:
            try:
                num = float(raw)
            except ValueError:
                raise FilterError(
                    f"ordered comparison needs a numeric value: {part!r}"
                ) from None
            rop = {">": "gt", ">=": "gte", "<": "lt", "<=": "lte"}[op]
            must.append(Condition(key, "range", {rop: num}))
    return Filter(tuple(must), (), tuple(must_not))


# ---------------------------------------------------------------------------
# Payload columns (one streaming pass per store version)
# ---------------------------------------------------------------------------

_MISSING = object()


def _assign(col: np.ndarray, idx: np.ndarray, values: list) -> None:
    """col[idx] = values, element-wise — a plain fancy assignment would
    let numpy coerce a list of equal-length lists into a 2-D block."""
    tmp = np.asarray(values, object)
    if tmp.ndim != 1:               # equal-length list values: keep 1-D
        tmp = np.empty((len(values),), object)
        for m, v in enumerate(values):
            tmp[m] = v
    col[idx] = tmp


class PayloadColumns:
    """Columnar view of selected payload keys.

    Built by ONE pass over `payloads.jsonl` (never holding all payload
    dicts at once); each requested key becomes an object ndarray of
    length `count` with `_MISSING` for absent keys. A second `ensure`
    call with new keys re-streams once for the union. Freshness is the
    owner's job: cache instances keyed on (count, data_version) — see
    `Reverso._filter_mask`.

    The pass runs through the native C++ JSONL walker when available
    (`native.payload_scan`: multithreaded, touches each byte once,
    materializes only the requested keys — the scaling path for 10M+
    row stores), falling back to the Python `json` reference pass. The
    two are semantically identical (ints beyond +-2**53 come back as
    spans the native path json-parses, keeping big-int exactness).
    """

    def __init__(self, store):
        self._store = store
        self.count = store.count
        self._cols: dict[str, np.ndarray] = {}
        self._views: dict[str, "TypedView"] = {}
        # cache-loaded keys whose object column hasn't been asked for
        # yet: key -> odd values (column() materializes on demand)
        self._pending: dict[str, list] = {}
        # memoized per-key derived arrays: ("dt"|"geo", key) -> arrays
        self._derived: dict[tuple, Any] = {}

    def ensure(self, keys: Sequence[str]) -> None:
        missing = [k for k in keys
                   if k not in self._cols and k not in self._pending]
        if not missing or self.count == 0:
            for k in missing:
                self._cols[k] = np.empty((0,), object)
            return
        missing = self._load_persisted(missing)
        if not missing:
            return
        paths = [k for k in missing if _path_segments(k)]
        if paths:
            # nested paths derive from their ROOT key's column — ensure
            # the roots (plus any plain keys) in one streaming pass,
            # then traverse host-side; derived columns persist like any
            # other (the cache key is the dotted path itself)
            flat = [k for k in missing if k not in paths]
            roots = sorted({_path_segments(k)[0] for k in paths})
            self.ensure(flat + [r for r in roots if r not in flat])
            for k in paths:
                self._cols[k] = self._derive_path(k)
            self._maybe_persist(paths)
            return
        self._store.flush()
        cols = None
        if os.environ.get("REVERSO_NATIVE", "1") != "0":
            try:
                cols = self._extract_native(missing)
            except Exception:
                cols = None           # any native hiccup -> json pass
        if cols is None:
            cols = self._extract_python(missing)
        self._cols.update(cols)
        self._maybe_persist(list(cols))

    def _load_persisted(self, missing: Sequence[str]) -> list:
        """Install any of `missing` available in the on-disk column
        cache for this exact store version; returns the keys still
        missing. Any corruption falls back to re-extraction."""
        if os.environ.get("REVERSO_PAYCOL_CACHE", "1") == "0":
            return list(missing)
        path = _paycols_path(self._store)
        if not os.path.exists(path):
            return list(missing)
        try:
            with np.load(path, allow_pickle=False) as z:
                have = {name.split("::", 1)[0] for name in z.files}
                still = []
                for k in missing:
                    if k not in have:
                        still.append(k)
                        continue
                    # per-key isolation: a corrupt/wrong-size member
                    # must fall back to extraction WITHOUT leaving a
                    # half-installed view behind for that key
                    try:
                        view, odd_vals = _view_from_arrays(z, k,
                                                           self.count)
                    except Exception:
                        still.append(k)
                        continue
                    self._views[k] = view
                    self._pending[k] = odd_vals
            return still
        except Exception:
            return list(missing)

    def persist(self, keys: Optional[Sequence[str]] = None, *,
                force: bool = True) -> Optional[str]:
        """Write a typed-column cache file for this store version — the
        payload-index role of qdrant's create_payload_index: later
        processes load these arrays (an mmap-speed npz read) instead of
        re-streaming the whole JSONL and re-deriving views. Returns the
        path, or None when nothing qualified / the filesystem refused.

        `force=False` applies the auto-persist size guard per key
        (skips e.g. all-unique id columns whose dictionary would dwarf
        the data). Existing cached keys for the same version are
        preserved (merge-on-write); stale versions are swept."""
        if keys is None:
            keys = list(self._cols) + [k for k in self._pending
                                       if k not in self._cols]
        keys = list(keys)
        if not keys or self.count == 0:
            return None
        path = _paycols_path(self._store)
        arrays: dict = {}
        try:
            if os.path.exists(path):       # merge with already-cached keys
                with np.load(path, allow_pickle=False) as z:
                    arrays.update({name: z[name] for name in z.files})
        except Exception:
            arrays = {}
        budget = _PERSIST_MAX_BYTES_PER_ROW * self.count
        wrote = False
        for k in keys:
            member = _view_to_arrays(k, self.view(k), self.column(k))
            if not force and sum(a.nbytes for a in member.values()) > budget:
                continue
            arrays.update(member)
            wrote = True
        if not wrote:
            return None
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
            for fname in os.listdir(os.path.dirname(path)):
                if fname.startswith(_PAYCOL_PREFIX) and \
                        fname != os.path.basename(path):
                    try:
                        os.remove(os.path.join(os.path.dirname(path),
                                               fname))
                    except OSError:
                        pass
            return path
        except OSError:
            return None               # read-only filesystem etc.

    def _maybe_persist(self, new_keys: Sequence[str]) -> None:
        """Auto-persist freshly extracted keys on big stores, so the
        NEXT process's first filtered search skips the JSONL stream
        and the view derivation entirely."""
        if self.count < _PERSIST_MIN_ROWS or \
                os.environ.get("REVERSO_PAYCOL_CACHE", "1") == "0":
            return
        try:
            self.persist(new_keys, force=False)
        except Exception:
            pass                      # cache write must never fail a query

    def _extract_python(self, missing: Sequence[str]) -> dict:
        """Reference implementation: json-parse every line."""
        from .persist import PAYLOAD_FILE
        cols = {k: np.full((self.count,), _MISSING, object)
                for k in missing}
        path = os.path.join(self._store.path, PAYLOAD_FILE)
        with open(path, "rb") as f:
            for i, line in enumerate(f):
                if i >= self.count:
                    break
                try:
                    payload = json.loads(line)
                except (ValueError, UnicodeDecodeError):
                    continue        # torn/corrupt line -> all keys missing
                for k in missing:
                    if k in payload:
                        cols[k][i] = payload[k]
        return cols

    def _extract_native(self, missing: Sequence[str]) -> Optional[dict]:
        """One multithreaded C++ byte pass; only complex values
        (lists/objects) and escaped strings json-parse per cell.
        Returns None when the native library or offsets can't serve."""
        import mmap as mmap_mod

        from ..native import (PAYLOAD_COMPLEX, PAYLOAD_FALSE, PAYLOAD_FLOAT,
                              PAYLOAD_INT, PAYLOAD_NULL, PAYLOAD_STR,
                              PAYLOAD_STR_ESC, PAYLOAD_TRUE, intern_spans,
                              payload_scan)
        from .persist import PAYLOAD_FILE

        store = self._store
        offsets = np.asarray(store._payload_offsets(), np.int64)
        if len(offsets) < self.count:
            return None          # sidecar trails the JSONL: json pass
        path = os.path.join(store.path, PAYLOAD_FILE)
        size = os.path.getsize(path)
        if size == 0:
            return None
        n = self.count
        with open(path, "rb") as f:
            mm = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)
        buf = mv = None
        try:
            buf = np.frombuffer(mm, np.uint8)
            ends = np.empty(n, np.int64)
            ends[:-1] = offsets[1:n]
            if len(offsets) > n:
                ends[-1] = int(offsets[n])
            else:
                # The sidecar holds exactly n offsets, so the last row's
                # span would otherwise run to EOF — which can include a
                # TORN TAIL (crash between the jsonl append and the
                # sidecar append). parse_line rejects trailing bytes, so
                # that would silently drop the last committed row from
                # every filter. Bound the span at the row's own newline.
                nl = mm.find(b"\n", int(offsets[n - 1]))
                ends[-1] = size if nl < 0 else nl + 1
            res = payload_scan(buf, offsets[:n], ends, list(missing))
            if res is None:
                return None
            types, numbers, str_off, str_len = res
            mv = memoryview(mm)
            cols = {}
            for j, key in enumerate(missing):
                col = np.full((n,), _MISSING, object)
                t = types[:, j]
                col[t == PAYLOAD_NULL] = None
                col[t == PAYLOAD_FALSE] = False
                col[t == PAYLOAD_TRUE] = True
                ii = np.nonzero(t == PAYLOAD_INT)[0]
                if len(ii):
                    # tolist() boxes to Python ints/floats at C speed
                    _assign(col, ii,
                            numbers[ii, j].astype(np.int64).tolist())
                ii = np.nonzero(t == PAYLOAD_FLOAT)[0]
                if len(ii):
                    _assign(col, ii, numbers[ii, j].tolist())
                ii = np.nonzero(t == PAYLOAD_STR)[0]
                if len(ii):
                    col[ii] = self._decode_strings(
                        buf, mv, str_off[ii, j], str_len[ii, j])
                for tag, wrap in ((PAYLOAD_STR_ESC, b'"%s"'),
                                  (PAYLOAD_COMPLEX, b"%s")):
                    ii = np.nonzero(t == tag)[0]
                    if len(ii):
                        vals = []
                        for o, ln in zip(str_off[ii, j].tolist(),
                                         str_len[ii, j].tolist()):
                            try:
                                vals.append(json.loads(
                                    wrap % bytes(mv[o:o + ln])))
                            except ValueError:
                                vals.append(_MISSING)
                        _assign(col, ii, vals)
                cols[key] = col
            return cols
        finally:
            # the mmap can't close while numpy/memoryview exports exist
            # (NB: probing via locals() would cache a frame-locals dict
            # that itself keeps `buf` exported past the rebind)
            if mv is not None:
                mv.release()
            buf = None
            mm.close()

    @staticmethod
    def _decode_strings(buf, mv, offs, lens) -> np.ndarray:
        """Clean-string spans -> object array of Python strings.

        Low-cardinality columns (detected_class & friends — the usual
        filter keys) dictionary-encode natively so each UNIQUE value
        decodes once, then one vectorized object gather. A sample pass
        decides: when the column is mostly unique (region_id-like ids),
        interning buys nothing, so rows decode directly."""
        from ..native import intern_spans

        sample = 65536
        enc = (intern_spans(buf, offs[:sample], lens[:sample])
               if len(offs) > sample else None)
        mostly_unique = (enc is not None
                         and len(enc[1]) > 0.5 * min(sample, len(offs)))
        if not mostly_unique:
            enc = intern_spans(buf, offs, lens)
        if enc is not None and not mostly_unique:
            codes, u_off, u_len = enc
            uniq = np.empty((len(u_off),), object)
            for m, (o, ln) in enumerate(zip(u_off.tolist(),
                                            u_len.tolist())):
                uniq[m] = bytes(mv[o:o + ln]).decode("utf-8")
            return uniq[codes]
        # direct per-row decode (native lib absent, or mostly unique)
        interned: dict = {}
        vals = np.empty((len(offs),), object)
        for m, (o, ln) in enumerate(zip(offs.tolist(), lens.tolist())):
            b = bytes(mv[o:o + ln])
            v = interned.get(b)
            if v is None:
                v = interned[b] = b.decode("utf-8")
            vals[m] = v
        return vals

    def column(self, key: str) -> np.ndarray:
        self.ensure([key])
        if key in self._pending:        # cache-loaded: materialize now
            self._cols[key] = _column_from_view(
                self._views[key], self._pending.pop(key), self.count)
        return self._cols[key]

    def view(self, key: str) -> "TypedView":
        """Memoized typed view (see `TypedView`) — derived once per
        (store version, key), then every filter/order_by/lookup is
        vectorized numpy. Treat the arrays as read-only."""
        v = self._views.get(key)
        if v is None:
            v = self._views[key] = TypedView(self.column(key))
        return v

    def vector_presence(self, space: str) -> np.ndarray:
        """[count] bool — rows that HAVE a vector in `space` (the
        has_vector condition). Dense spaces are append-complete (every
        committed row carries every dense space), so presence is
        all-True; sparse/multivector spaces read the indptr sidecar
        (zero entries == vector not set). Unknown names are a
        FilterError so malformed specs 400 before any scan."""
        store = self._store
        key = ("hasvec", space)
        got = self._derived.get(key)
        if got is not None:
            return got
        if space in store.spaces():
            # append-complete, MINUS any per-point delete_vectors mask
            # (qdrant delete_vectors; store.deleted_rows). _ElementColumns
            # and test doubles carry no store method — all-present then.
            m = np.ones(self.count, np.bool_)
            dels = getattr(store, "deleted_rows", None)
            if dels is not None:
                gone = dels(space)
                m[gone[gone < self.count]] = False
        elif space in getattr(store, "sparse", {}) \
                or space in getattr(store, "multi", {}):
            ind = np.asarray(store.ragged_indptr(space)[:self.count],
                             np.int64)
            m = np.diff(ind, prepend=np.int64(0)) > 0
        else:
            raise FilterError(f"has_vector: unknown vector space "
                              f"{space!r}")
        self._derived[key] = m
        return m

    def present(self, key: str) -> np.ndarray:
        """[count] bool: rows whose payload carries `key` at all.
        Treat as read-only (shared with the memoized view)."""
        return self.view(key).present

    def text_index(self, key: str):
        """Memoized full-text inverted index over `key`'s unique-string
        dictionary (store/text.py — the qdrant full-text payload index
        role). Loaded from the typed-column cache when `index-payload
        --text` persisted it for this store version (digest-checked
        against the live dictionary), else built in-process on first
        use — which costs about one legacy per-unique evaluation, so
        every text/phrase query after the first is pure postings
        work."""
        from .text import TextIndex

        got = self._derived.get(("text", key))
        if got is None:
            view = self.view(key)
            ti = None
            store = getattr(self, "_store", None)
            if (store is not None
                    and os.environ.get("REVERSO_PAYCOL_CACHE", "1") != "0"):
                path = _paycols_path(store)
                if os.path.exists(path):
                    try:
                        with np.load(path, allow_pickle=False) as z:
                            ti = TextIndex.from_arrays(z, key, view.uniq)
                    except Exception:
                        ti = None
            if ti is None:
                ti = TextIndex.build(view.uniq)
            got = self._derived[("text", key)] = ti
        return got

    def persist_text(self, keys: Sequence[str]) -> Optional[str]:
        """Persist full-text indexes (plus the backing typed views, so
        dictionary ordering and postings always travel together) for
        `keys` into the typed-column cache file. Returns the path or
        None when the filesystem refused."""
        path = self.persist(keys, force=True)
        if path is None:
            return None
        arrays: dict = {}
        try:
            with np.load(path, allow_pickle=False) as z:
                arrays.update({name: z[name] for name in z.files})
            for k in keys:
                arrays.update(self.text_index(k).to_arrays(k))
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
            return path
        except OSError:
            return None

    def datetime_num(self, key: str) -> tuple:
        """(rows [count] f64, elements [E] f64) epoch seconds for
        RFC 3339 string payloads, NaN for everything else (missing /
        non-string / unparseable — NaN compares False under every
        range operator); the element array covers array payloads
        (any-element datetime_range). Parsing runs once per UNIQUE
        string via the dictionary-coded view, so this never touches
        the object column (cache-loaded views stay lazy); memoized
        per (store version, key)."""
        cached = self._derived.get(("dt", key))
        if cached is None:
            view = self.view(key)
            per_uniq = np.fromiter(
                (_dt_or_nan(u) for u in view.uniq.tolist()),
                np.float64, count=len(view.uniq))
            rows = np.full(len(view.present), np.nan, np.float64)
            srows = view.codes >= 0
            rows[srows] = per_uniq[view.codes[srows]]
            elems = np.full(len(view.erow), np.nan, np.float64)
            es = view.ecodes >= 0
            elems[es] = per_uniq[view.ecodes[es]]
            cached = self._derived[("dt", key)] = (rows, elems)
        return cached

    def geo(self, key: str) -> tuple:
        """(lon [count] f64, lat [count] f64, multi {row: [(lon, lat)]})
        derived from geo-point payloads: a `{"lon": x, "lat": y}` dict
        fills the arrays (NaN where absent/malformed — NaN never
        matches); a LIST of such dicts lands its first point in the
        arrays and the full set in `multi` for the any-point recheck.
        Geo values are dicts/lists, i.e. always TypedView `odd` rows,
        so derivation is a sparse pass; memoized per store version."""
        cached = self._derived.get(("geo", key))
        if cached is None:
            view = self.view(key)
            n = len(view.present)
            lon = np.full(n, np.nan, np.float64)
            lat = np.full(n, np.nan, np.float64)
            multi: dict[int, list] = {}
            if len(view.odd):
                col = self.column(key)
                for i in view.odd.tolist():
                    pts = _geo_value(col[i])
                    if not pts:
                        continue
                    lon[i], lat[i] = pts[0]
                    if len(pts) > 1:
                        multi[i] = pts
            cached = self._derived[("geo", key)] = (lon, lat, multi)
        return cached

    def _derive_path(self, key: str) -> np.ndarray:
        """Column for a nested payload path ('a.b.c'): the root column
        traversed host-side once per store version. Multi-valued
        results (any list crossed) store as a list — the element-level
        TypedView arrays then give them qdrant's any-element
        semantics; single leaves store as the scalar."""
        segs = _path_segments(key) or [key]
        base = self.column(segs[0])
        if len(segs) == 1:
            return base
        rest = segs[1:]
        out = np.full(self.count, _MISSING, object)
        for i, v in enumerate(base):
            if v is _MISSING:
                continue
            leaves: list = []
            hit = _collect_path(v, rest, 0, leaves)
            if leaves:
                # an empty projection stays MISSING (not []), so
                # `exists` answers "is there any value at this path"
                # and its False form finds the rows lacking one;
                # is_empty/values_count treat missing as empty/0 anyway
                out[i] = leaves if hit else leaves[0]
        return out

    def element_table(self, key: str) -> tuple:
        """(erow [E] int64, _ElementColumns) for the `nested`
        condition: every OBJECT element of the array payload at `key`
        becomes one virtual row (a bare object payload counts as a
        one-element array); memoized per store version."""
        cached = self._derived.get(("nested", key))
        if cached is None:
            col = self.column(key)
            erow: list[int] = []
            elems: list[dict] = []
            for i, v in enumerate(col):
                if isinstance(v, dict):
                    erow.append(i)
                    elems.append(v)
                elif isinstance(v, list):
                    for e in v:
                        if isinstance(e, dict):
                            erow.append(i)
                            elems.append(e)
            cached = self._derived[("nested", key)] = (
                np.asarray(erow, np.int64), _ElementColumns(elems))
        return cached


class TypedView:
    """Exactness-preserving typed views of one object column.

    Derived in ONE python pass per (store version, key) and memoized on
    the owning `PayloadColumns`, so every later filter evaluation,
    order_by sort, and region_id lookup is pure vectorized numpy — the
    per-query python loop over 1M+ rows that the object column forces
    otherwise. The exactness contract vs the python reference
    semantics is kept by sparse row lists (values float64 equality
    can't represent: ints beyond 2^53, lists, dicts) that match/any
    re-check with python `==`.

    LIST payloads additionally flatten into element-level typed arrays
    (`erow`/`ecodes`/`enum`/…) sharing the row arrays' string
    dictionary, so qdrant's any-element array semantics (match / any /
    except / range / text over array fields) evaluate as the same
    vectorized passes plus one scatter-OR back onto rows. `odd` still
    lists EVERY non-scalar row (the exact-reconstruction set used by
    `_column_from_view` and non-scalar match values); `odd_scalar`
    (dicts, big ints) and `eodd_rows` (lists holding dict/list/big-int
    elements) are the sparse python-recheck sets for scalar matches."""

    __slots__ = ("present", "num", "numb", "codes", "uniq", "uindex",
                 "is_null", "isint", "odd", "odd_scalar", "vcount",
                 "list_rows", "erow", "ecodes", "enum", "enumb",
                 "eisnull", "eodd_rows")

    def __init__(self, col: np.ndarray):
        n = len(col)
        self.present = np.zeros(n, np.bool_)
        # numbers excluding bools (the `range` operand, matching the
        # old _numeric); big ints round to f64 exactly as before
        self.num = np.full(n, np.nan, np.float64)
        # numbers INCLUDING bools as 1/0 (the `match` operand: python
        # equality says True == 1)
        self.numb = np.full(n, np.nan, np.float64)
        self.codes = np.full(n, -1, np.int32)      # clean-string dict codes
        self.is_null = np.zeros(n, np.bool_)
        self.isint = np.zeros(n, np.bool_)   # int (vs float) numeric rows
        uniq: list[str] = []
        uindex: dict[str, int] = {}
        odd: list[int] = []
        lists: list[tuple[int, list]] = []
        big = 2 ** 53
        for i, v in enumerate(col):
            if v is _MISSING:
                continue
            self.present[i] = True
            t = type(v)
            if t is str:
                c = uindex.get(v)
                if c is None:
                    c = uindex[v] = len(uniq)
                    uniq.append(v)
                self.codes[i] = c
            elif t is bool:
                self.numb[i] = 1.0 if v else 0.0
            elif t is int:
                self.num[i] = self.numb[i] = v
                self.isint[i] = True
                if not -big <= v <= big:
                    odd.append(i)          # f64-inexact: python-check ==
            elif t is float:
                self.num[i] = self.numb[i] = v
            elif v is None:
                self.is_null[i] = True
            elif t is list:
                odd.append(i)
                lists.append((i, v))
            else:
                odd.append(i)              # dicts/exotic types
        self.odd = np.asarray(odd, np.int64)
        self._index_elements(lists, uniq, uindex)
        self.uniq = np.asarray(uniq, object)
        self.uindex = uindex

    def _index_elements(self, lists: list, uniq: list,
                        uindex: dict) -> None:
        """Flatten list rows into element arrays (see class doc).
        Element strings intern into the SAME dictionary as row strings
        so text/datetime derivations stay once-per-unique."""
        n = len(self.present)
        self.vcount = self.present.astype(np.int32)  # scalar=1, missing=0
        self.list_rows = np.zeros(n, np.bool_)
        list_set = set()
        erow: list[int] = []
        ecodes: list[int] = []
        enum: list[float] = []
        enumb: list[float] = []
        eisnull: list[bool] = []
        eodd_rows: set[int] = set()
        big = 2 ** 53
        for i, v in lists:
            self.vcount[i] = len(v)
            self.list_rows[i] = True
            list_set.add(i)
            for e in v:
                erow.append(i)
                t = type(e)
                code, num, numb, isnull = -1, np.nan, np.nan, False
                if t is str:
                    code = uindex.get(e)
                    if code is None:
                        code = uindex[e] = len(uniq)
                        uniq.append(e)
                elif t is bool:
                    numb = 1.0 if e else 0.0
                elif t is int:
                    num = numb = float(e)
                    if not -big <= e <= big:
                        eodd_rows.add(i)   # f64-inexact element
                elif t is float:
                    num = numb = e
                elif e is None:
                    isnull = True
                else:
                    eodd_rows.add(i)       # dict/list element
                ecodes.append(code)
                enum.append(num)
                enumb.append(numb)
                eisnull.append(isnull)
        self.erow = np.asarray(erow, np.int64)
        self.ecodes = np.asarray(ecodes, np.int32)
        self.enum = np.asarray(enum, np.float64)
        self.enumb = np.asarray(enumb, np.float64)
        self.eisnull = np.asarray(eisnull, np.bool_)
        self.eodd_rows = np.asarray(sorted(eodd_rows), np.int64)
        self.odd_scalar = np.asarray(
            [i for i in self.odd.tolist() if i not in list_set], np.int64)


class _ElementColumns(PayloadColumns):
    """PayloadColumns over a flattened list of object elements — the
    `nested` condition's evaluation table. Columns (dotted paths
    included) derive straight from the element dicts instead of
    streaming the store; views/derivations then work unchanged."""

    def __init__(self, elems: list):
        self.count = len(elems)
        self._cols = {}
        self._views = {}
        self._pending = {}
        self._derived = {}
        self._elems = elems

    def ensure(self, keys: Sequence[str]) -> None:
        for k in keys:
            if k in self._cols:
                continue
            segs = _path_segments(k) or [k]
            col = np.full(self.count, _MISSING, object)
            for i, e in enumerate(self._elems):
                leaves: list = []
                hit = _collect_path(e, segs, 0, leaves)
                if leaves:       # empty projection stays MISSING
                    col[i] = leaves if hit else leaves[0]
            self._cols[k] = col


_PAYCOL_PREFIX = "paycols_"
_PERSIST_MIN_ROWS = 100_000        # auto-persist threshold (rows)
_PERSIST_MAX_BYTES_PER_ROW = 40    # per-key auto-persist size guard


def _paycols_path(store) -> str:
    """Persisted-column file for the store's CURRENT version. The
    (count, data_version) key in the name is the whole invalidation
    story: any mutation bumps data_version, so a stale file simply
    never matches again (and is swept on the next persist)."""
    return os.path.join(
        store.path, "index",
        f"{_PAYCOL_PREFIX}{store.count}_{store.data_version}.npz")


def _view_to_arrays(key: str, view: "TypedView",
                    col: np.ndarray) -> dict:
    """TypedView -> plain typed arrays (npz-safe, no pickle). Unique
    strings ship as one utf-8 blob + lengths; odd values (big ints,
    lists, dicts) as their exact JSON."""
    enc = [u.encode("utf-8") for u in view.uniq.tolist()]
    blob = (np.frombuffer(b"".join(enc), np.uint8).copy() if enc
            else np.zeros(0, np.uint8))
    lens = np.asarray([len(e) for e in enc], np.int64)
    odd_json = (np.asarray([json.dumps(col[i])
                            for i in view.odd.tolist()])
                if len(view.odd) else np.zeros(0, "U1"))
    return {f"{key}::present": view.present, f"{key}::num": view.num,
            f"{key}::numb": view.numb, f"{key}::codes": view.codes,
            f"{key}::is_null": view.is_null, f"{key}::isint": view.isint,
            f"{key}::odd": view.odd, f"{key}::odd_json": odd_json,
            f"{key}::uniq_blob": blob, f"{key}::uniq_lens": lens}


def _view_from_arrays(z, key: str, n: int):
    """Inverse of `_view_to_arrays`: (TypedView, odd values)."""
    view = TypedView.__new__(TypedView)
    for slot in ("present", "num", "numb", "codes", "is_null", "isint",
                 "odd"):
        arr = np.asarray(z[f"{key}::{slot}"])
        setattr(view, slot, arr)
    if len(view.present) != n:
        raise ValueError(f"persisted column {key!r} has "
                         f"{len(view.present)} rows, store has {n}")
    blob = bytes(np.asarray(z[f"{key}::uniq_blob"], np.uint8))
    lens = np.asarray(z[f"{key}::uniq_lens"], np.int64).tolist()
    uniq, pos = [], 0
    for ln in lens:
        uniq.append(blob[pos:pos + ln].decode("utf-8"))
        pos += ln
    uindex = {u: i for i, u in enumerate(uniq)}
    odd_vals = [json.loads(s) for s in
                np.asarray(z[f"{key}::odd_json"]).tolist()]
    # element arrays are fully derivable from the (sparse) odd values,
    # so the cache format carries no extra members and files written
    # before the element arrays existed still load
    lists = [(i, v) for i, v in zip(view.odd.tolist(), odd_vals)
             if type(v) is list]
    view._index_elements(lists, uniq, uindex)
    view.uniq = np.asarray(uniq, object)
    view.uindex = uindex
    return view, odd_vals


def _column_from_view(view: "TypedView", odd_vals, n: int) -> np.ndarray:
    """Object column reconstructed from a loaded view — each cell with
    its exact python type (ints via isint, bools via numb-without-num,
    NaN floats, odd rows from their JSON), so facet/group-by/python-
    fallback paths behave identically to a freshly extracted column.
    Deferred until someone actually asks for the object view: filter
    evaluation runs on the typed arrays alone."""
    col = np.full(n, _MISSING, object)
    srows = np.nonzero(view.codes >= 0)[0]
    if len(srows):
        col[srows] = view.uniq[view.codes[srows]]
    has_num = ~np.isnan(view.num)
    irows = np.nonzero(view.isint)[0]
    if len(irows):
        col[irows] = view.num[irows].astype(np.int64).tolist()
    frows = np.nonzero(has_num & ~view.isint)[0]
    if len(frows):
        col[frows] = view.num[frows].tolist()
    brows = np.nonzero(~has_num & ~np.isnan(view.numb))[0]
    if len(brows):
        col[brows] = (view.numb[brows] > 0.5).tolist()
    col[view.is_null] = None
    # NaN-float payloads: present but in no typed class above
    nanrows = (view.present & np.isnan(view.numb) & (view.codes < 0)
               & ~view.is_null)
    nanrows[view.odd] = False
    col[nanrows] = float("nan")
    for i, v in zip(view.odd.tolist(), odd_vals):
        col[i] = v
    return col


def _numeric(col: np.ndarray) -> np.ndarray:
    """Object column -> float64 with NaN for missing/non-numeric values
    (NaN compares False under every ordered operator, which is exactly
    the 'missing never matches a range' semantics we want).
    Kept as the reference implementation; hot paths use
    `PayloadColumns.view(key).num` instead."""
    out = np.full(col.shape, np.nan, np.float64)
    for i, v in enumerate(col):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[i] = v
    return out


def _geo_value(v: Any) -> list:
    """Payload cell -> [(lon, lat), ...] ([] when not a geo value)."""
    def point(obj):
        if isinstance(obj, dict):
            lon, lat = obj.get("lon"), obj.get("lat")
            if isinstance(lon, (int, float)) and not isinstance(lon, bool) \
                    and isinstance(lat, (int, float)) \
                    and not isinstance(lat, bool):
                return float(lon), float(lat)
        return None
    p = point(v)
    if p is not None:
        return [p]
    if isinstance(v, list):
        return [p for e in v if (p := point(e)) is not None]
    return []


def _haversine_m(lon: np.ndarray, lat: np.ndarray,
                 clon: float, clat: float) -> np.ndarray:
    """Great-circle distance in meters from (clon, clat), vectorized."""
    import math
    rlon, rlat = np.radians(lon), np.radians(lat)
    crlon, crlat = math.radians(clon), math.radians(clat)
    a = (np.sin((rlat - crlat) * 0.5) ** 2
         + np.cos(rlat) * math.cos(crlat)
         * np.sin((rlon - crlon) * 0.5) ** 2)
    return 2.0 * _EARTH_RADIUS_M * np.arcsin(np.sqrt(np.minimum(a, 1.0)))


def _in_ring(lon: np.ndarray, lat: np.ndarray, ring: tuple) -> np.ndarray:
    """Even-odd ray casting in lon/lat. NaN coordinates come out False
    (every comparison against NaN is False)."""
    inside = np.zeros(lon.shape, np.bool_)
    m = len(ring)
    for e in range(m):
        x1, y1 = ring[e]
        x2, y2 = ring[(e + 1) % m]
        if y1 == y2:
            continue             # horizontal edge: never crosses the ray
        crosses = (y1 > lat) != (y2 > lat)
        xi = (x2 - x1) * (lat - y1) / (y2 - y1) + x1
        inside ^= crosses & (lon < xi)
    return inside


def _geo_mask(op: str, value: dict, lon: np.ndarray,
              lat: np.ndarray) -> np.ndarray:
    if op == "geo_radius":
        (clon, clat), radius = value["center"], value["radius"]
        return _haversine_m(lon, lat, clon, clat) <= radius
    if op == "geo_bounding_box":
        (tl_lon, tl_lat) = value["top_left"]
        (br_lon, br_lat) = value["bottom_right"]
        ok = (lat <= tl_lat) & (lat >= br_lat)
        if tl_lon <= br_lon:
            ok &= (lon >= tl_lon) & (lon <= br_lon)
        else:                    # box crosses the date line
            ok &= (lon >= tl_lon) | (lon <= br_lon)
        return ok
    # geo_polygon: inside the exterior, outside every interior ring
    ok = _in_ring(lon, lat, value["exterior"])
    for ring in value["interiors"]:
        ok &= ~_in_ring(lon, lat, ring)
    return ok


def _apply_range(num: np.ndarray, r: dict) -> np.ndarray:
    """Ordered comparisons; NaN rows (missing/non-numeric) never match.
    An empty dict matches everything (the reference behavior)."""
    ok = np.ones(num.shape, np.bool_)
    if "gt" in r:
        ok &= num > r["gt"]
    if "gte" in r:
        ok &= num >= r["gte"]
    if "lt" in r:
        ok &= num < r["lt"]
    if "lte" in r:
        ok &= num <= r["lte"]
    return ok


def _py_match(v, value) -> bool:
    """The python reference predicate for `match`: equality, or —
    qdrant's array semantics — ANY element of a list payload equal."""
    if v is _MISSING:
        return False
    if v == value:
        return True
    return isinstance(v, list) and any(e == value for e in v)


def _match_mask(view: TypedView, col_fn, value) -> np.ndarray:
    """Vectorized `payload[key] == value` with python-equality
    semantics (True == 1, exact big-int compares) and qdrant's array
    semantics: a LIST payload matches when any element does. `col_fn`
    supplies the object column lazily — it is only touched for the
    sparse recheck rows (dicts, big ints, lists holding non-scalar
    elements) or non-scalar match values, so cache-loaded columns
    usually never materialize."""
    if isinstance(value, str):
        c = view.uindex.get(value, -2)
        m = view.codes == c
        em = view.ecodes == c
    elif value is None:
        m = view.is_null.copy()
        em = view.eisnull
    elif isinstance(value, bool) or (isinstance(value, int)
                                     and -2**53 <= value <= 2**53) \
            or isinstance(value, float):
        m = view.numb == float(value)
        em = view.enumb == float(value)
    else:
        # non-scalar or f64-inexact match value: python reference path
        col = col_fn()
        return np.fromiter((_py_match(v, value) for v in col),
                           np.bool_, count=len(col))
    m[view.erow[em]] = True                # any-element scatter-OR
    if len(view.odd_scalar) or len(view.eodd_rows):
        col = col_fn()
        for i in view.odd_scalar:          # dicts, big-int rows
            m[i] = col[i] == value
        for i in view.eodd_rows:           # lists w/ non-scalar elements
            # unconditional: the vectorized pass can also FALSE-POSITIVE
            # here (a big-int element f64-colliding with the match
            # value), so the python pass over the whole list decides
            m[i] = any(e == value for e in col[i])
    return m


def _eval_condition(cond: "Condition | Filter",
                    columns: PayloadColumns) -> np.ndarray:
    if isinstance(cond, Filter):
        return evaluate_filter(cond, columns)
    if cond.op == "has_id":
        m = np.zeros(columns.count, np.bool_)
        str_ids = []
        for v in cond.value:
            if isinstance(v, str):
                str_ids.append(v)
            elif 0 <= v < columns.count:
                m[v] = True
        if str_ids:
            # string ids address the region_id payload; only then is
            # the (all-unique) id column touched — see Condition.keys
            view = columns.view(ID_KEY)
            for s in str_ids:
                c = view.uindex.get(s)
                if c is not None:
                    m |= view.codes == c
        return m
    if cond.op == "has_vector":
        return columns.vector_presence(cond.value)
    if cond.op == "nested":
        # one element satisfying the WHOLE inner filter (all inner
        # conditions bind to the same element, unlike path conditions)
        erow, ecols = columns.element_table(cond.key)
        m = np.zeros(columns.count, np.bool_)
        if len(erow):
            m[erow[evaluate_filter(cond.value, ecols)]] = True
        return m
    view = columns.view(cond.key)
    col_fn = lambda: columns.column(cond.key)   # noqa: E731 — lazy
    if cond.op == "exists":
        return view.present if cond.value else ~view.present
    if cond.op == "is_null":
        return view.is_null
    if cond.op == "is_empty":
        # absent, null, or an empty ARRAY (qdrant's IsEmpty; {} is a
        # present object value and does NOT count)
        return ((~view.present) | view.is_null
                | (view.list_rows & (view.vcount == 0)))
    if cond.op == "match":
        return _match_mask(view, col_fn, cond.value)
    if cond.op in ("any", "except"):
        m = np.zeros(len(view.present), np.bool_)
        for value in cond.value:
            m |= _match_mask(view, col_fn, value)
        # except is the exact complement: "no stored value is any of
        # the listed ones" — vacuously true for rows missing the key
        return ~m if cond.op == "except" else m
    if cond.op in ("text", "phrase"):
        if os.environ.get("REVERSO_TEXT_INDEX", "1") != "0":
            # inverted-index path (store/text.py): postings
            # intersection instead of re-tokenizing every unique
            # string per query; the kill switch keeps the legacy
            # evaluator reachable (it is also the parity oracle)
            ti = columns.text_index(cond.key)
            ok_uniq = (ti.text_match(cond.value) if cond.op == "text"
                       else ti.phrase_match(cond.value))
        else:
            if cond.op == "text":
                qtok = set(_TOKEN_RE.findall(cond.value.lower()))
                hit = lambda u: qtok <= set(_TOKEN_RE.findall(u.lower()))  # noqa: E731
            else:
                qseq = _TOKEN_RE.findall(cond.value.lower())
                hit = lambda u: _has_phrase(qseq, _TOKEN_RE.findall(u.lower()))  # noqa: E731
            ok_uniq = np.fromiter(
                (hit(u) for u in view.uniq.tolist()),
                np.bool_, count=len(view.uniq))
        m = np.zeros(len(view.present), np.bool_)
        srows = view.codes >= 0
        m[srows] = ok_uniq[view.codes[srows]]
        es = view.ecodes >= 0                # any-element for arrays
        m[view.erow[es][ok_uniq[view.ecodes[es]]]] = True
        return m
    if cond.op == "values_count":
        return _apply_range(view.vcount.astype(np.float64), cond.value)
    if cond.op == "range":
        # NaN rows (missing/non-numeric) compare False under every op,
        # and a (pathological) empty range matches everything — both
        # the reference-implementation semantics. Array payloads match
        # when ANY numeric element is in range (qdrant semantics).
        m = _apply_range(view.num, cond.value)
        if len(view.erow) and cond.value:
            m[view.erow[_apply_range(view.enum, cond.value)]] = True
        return m
    if cond.op == "datetime_range":
        rows_dt, elems_dt = columns.datetime_num(cond.key)
        m = _apply_range(rows_dt, cond.value)
        if len(view.erow) and cond.value:
            m[view.erow[_apply_range(elems_dt, cond.value)]] = True
        return m
    if cond.op in ("geo_bounding_box", "geo_radius", "geo_polygon"):
        lon, lat, multi = columns.geo(cond.key)
        m = _geo_mask(cond.op, cond.value, lon, lat)
        for i, pts in multi.items():     # any-point semantics for lists
            plon = np.asarray([p[0] for p in pts], np.float64)
            plat = np.asarray([p[1] for p in pts], np.float64)
            m[i] = bool(_geo_mask(cond.op, cond.value, plon, plat).any())
        return m
    raise FilterError(f"unknown condition op {cond.op!r}")


def evaluate_filter(filt: Filter, columns: PayloadColumns) -> np.ndarray:
    """Boolean mask [count] of rows matching the filter.

    Semantics match qdrant: must = AND of all; must_not = AND of the
    negations; should = at least one matches whenever the clause is
    non-empty (alongside must, both apply)."""
    n = columns.count
    mask = np.ones((n,), np.bool_)
    for c in filt.must:
        mask &= _eval_condition(c, columns)
    if filt.should:
        any_mask = np.zeros((n,), np.bool_)
        for c in filt.should:
            any_mask |= _eval_condition(c, columns)
        mask &= any_mask
    if filt.min_should:
        hits = np.zeros((n,), np.int32)
        for c in filt.min_should:
            hits += _eval_condition(c, columns)
        mask &= hits >= filt.min_count
    for c in filt.must_not:
        mask &= ~_eval_condition(c, columns)
    return mask


# ---------------------------------------------------------------------------
# Payload selectors (qdrant's with_payload include/exclude forms)
# ---------------------------------------------------------------------------

_SEL_LEAF = object()          # trie terminator: the whole subtree


def _selector_trie(paths) -> dict:
    """Include/exclude key list -> nested {segment: subtrie|LEAF}.
    Keys use the same payload-path syntax as filters ('a.b', 'a[].b');
    a shorter path subsumes any longer one under it."""
    if isinstance(paths, str):
        paths = [paths]
    if not isinstance(paths, (list, tuple)) or not paths or not all(
            isinstance(p, str) and p for p in paths):
        raise FilterError(
            f"payload selector needs a non-empty list of key strings, "
            f"got {paths!r}")
    trie: dict = {}
    for p in paths:
        segs = _path_segments(p) or [p]
        node = trie
        for s in segs[:-1]:
            nxt = node.get(s)
            if nxt is _SEL_LEAF:
                break                      # 'a' already includes 'a.b'
            if nxt is None:
                nxt = node[s] = {}
            node = nxt
        else:
            node[segs[-1]] = _SEL_LEAF
    return trie


_SEL_NOTHING = object()


def _sel_include(value, trie):
    """Pruned copy of `value` keeping only trie paths; _SEL_NOTHING
    when nothing along the paths exists. Lists traverse implicitly
    (qdrant payload-path style): elements with no selected content are
    dropped from the copied array."""
    if trie is _SEL_LEAF:
        return value
    if isinstance(value, dict):
        out = {}
        for k, sub in trie.items():
            if k in value:
                got = _sel_include(value[k], sub)
                if got is not _SEL_NOTHING:
                    out[k] = got
        return out if out else _SEL_NOTHING
    if isinstance(value, list):
        kept = [g for g in (_sel_include(e, trie) for e in value)
                if g is not _SEL_NOTHING]
        return kept if kept else _SEL_NOTHING
    return _SEL_NOTHING


def _sel_exclude(value, trie):
    """Copy of `value` with trie paths removed (arrays element-wise)."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            sub = trie.get(k)
            if sub is _SEL_LEAF:
                continue
            out[k] = v if sub is None else _sel_exclude(v, sub)
        return out
    if isinstance(value, list):
        return [_sel_exclude(e, trie) for e in value]
    return value


def compile_payload_selector(selector):
    """Normalize a qdrant `with_payload` value.

    Returns True (attach full payloads), False (attach None), or a
    callable dict->dict applying the selector. Accepted forms, same as
    qdrant's PayloadSelector: bool; a key string or list of keys
    (include shorthand); {"include": [keys]}; {"exclude": [keys]}.
    Keys are payload paths (dots descend, arrays traverse implicitly).
    Malformed selectors raise FilterError before any store IO."""
    if selector is True or selector is None:
        return selector is True
    if selector is False:
        return False
    if isinstance(selector, dict):
        if set(selector) == {"include"}:
            trie = _selector_trie(selector["include"])
            return lambda p: (lambda g: g if g is not _SEL_NOTHING
                              else {})(_sel_include(p, trie))
        if set(selector) == {"exclude"}:
            trie = _selector_trie(selector["exclude"])
            return lambda p: _sel_exclude(p, trie)
        raise FilterError(
            f"payload selector dict must be exactly {{'include': [...]}}"
            f" or {{'exclude': [...]}}, got {sorted(selector)!r}")
    if isinstance(selector, (str, list, tuple)):
        trie = _selector_trie(selector)
        return lambda p: (lambda g: g if g is not _SEL_NOTHING
                          else {})(_sel_include(p, trie))
    raise FilterError(f"bad with_payload value {selector!r}")


def payload_mask(store, spec: Any) -> np.ndarray:
    """One-shot convenience: parse + stream + evaluate against a store."""
    filt = parse_filter(spec)
    cols = PayloadColumns(store)
    cols.ensure(sorted(filt.keys()))
    return evaluate_filter(filt, cols)
