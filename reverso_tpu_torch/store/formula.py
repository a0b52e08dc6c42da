"""Formula (score-boosting) rescoring — qdrant's FormulaQuery role.

qdrant 1.14 lets `query_points` rescore prefetch candidates with an
arithmetic expression over prefetch scores, payload values, filter
conditions, geo distance and decay functions. The reference app never
reached it (plain `search` only, reference core_system.py:659-664),
but it belongs to the store surface this package rebuilds; evaluation
is HOST-side numpy over the candidate set (the candidate union is
k-scale, so this is glue, not kernel work — same placement qdrant
gives it).

Expression grammar (one JSON value per node):
  3.5                         constant
  "$score"                    the point's score from the FIRST prefetch
                              branch it appeared in (branch order)
  "$score[i]"                 the point's score in prefetch branch i
  "price" / "meta.depth"      payload value (dot/[] paths like filters;
                              booleans read as 1/0, RFC 3339 strings as
                              epoch seconds, so datetimes decay)
  {"sum": [e, ...]}           +        {"mult": [e, ...]}          *
  {"div": {"left": e, "right": e, "by_zero_default": c?}}
  {"neg": e} {"abs": e} {"sqrt": e} {"exp": e} {"ln": e} {"log10": e}
  {"pow": {"base": e, "exponent": e}}
  {"geo_distance": {"origin": {"lat","lon"}, "to": "payload_key"}}
                              haversine meters (same earth radius as
                              the geo filter conditions)
  {"lin_decay":   {"x": e, "target": e?, "scale": c?, "midpoint": c?}}
  {"exp_decay":   ...}        decay of |x - target| that equals
  {"gauss_decay": ...}        `midpoint` (default 0.5) at distance
                              `scale` (default 1.0); target defaults
                              to 0 — pass an RFC 3339 string (or a
                              datetime payload key) for time decay
  {<any filter condition>}    1.0 where the point matches, else 0.0
                              (e.g. {"key": "tag", "match": {...}})

Missing payload values (and missing `$score[i]` entries) fall back to
the query's `defaults` map; a missing variable with no default is a
ValueError, like qdrant's error response. Results order by
(-score, id) like every other search surface.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Optional

import numpy as np

from .filter import (
    _collect_path,
    _geo_point,
    _haversine_m,
    _parse_datetime,
    _path_segments,
)

_UNARY = ("neg", "abs", "sqrt", "exp", "ln", "log10")
_DECAYS = ("lin_decay", "exp_decay", "gauss_decay")
_OPS = ("sum", "mult", "div", "pow", "geo_distance") + _UNARY + _DECAYS
_SCORE_RE = re.compile(r"^\$score(?:\[(\d+)\])?$")


class FormulaError(ValueError):
    """Malformed formula spec or unresolvable variable."""


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def parse_formula(spec: Any) -> Any:
    """Validate a formula tree (raises FormulaError on bad shapes so
    API layers can 400 before touching any data). Returns the spec."""
    if _is_number(spec):
        return spec
    if isinstance(spec, str):
        return spec
    if isinstance(spec, dict):
        op_keys = [k for k in spec if k in _OPS]
        if len(op_keys) == 1 and len(spec) == 1:
            op, body = op_keys[0], spec[op_keys[0]]
            if op in ("sum", "mult"):
                if not isinstance(body, (list, tuple)) or not body:
                    raise FormulaError(f"{op} needs a non-empty list")
                for e in body:
                    parse_formula(e)
            elif op in _UNARY:
                parse_formula(body)
            elif op == "div":
                if not isinstance(body, dict) or \
                        not {"left", "right"} <= set(body):
                    raise FormulaError("div needs {left, right}")
                parse_formula(body["left"])
                parse_formula(body["right"])
                if "by_zero_default" in body and \
                        not _is_number(body["by_zero_default"]):
                    raise FormulaError("by_zero_default must be a number")
            elif op == "pow":
                if not isinstance(body, dict) or \
                        not {"base", "exponent"} <= set(body):
                    raise FormulaError("pow needs {base, exponent}")
                parse_formula(body["base"])
                parse_formula(body["exponent"])
            elif op == "geo_distance":
                if not isinstance(body, dict) or \
                        not {"origin", "to"} <= set(body):
                    raise FormulaError("geo_distance needs {origin, to}")
                try:
                    _geo_point(body["origin"], what="geo_distance origin")
                except ValueError as e:
                    raise FormulaError(str(e)) from None
                if not isinstance(body["to"], str):
                    raise FormulaError("geo_distance 'to' must be a "
                                       "payload key")
            else:                                     # decays
                if not isinstance(body, dict) or "x" not in body:
                    raise FormulaError(f"{op} needs an 'x' expression")
                parse_formula(body["x"])
                if "target" in body and not isinstance(body["target"], str):
                    parse_formula(body["target"])
                mid = body.get("midpoint", 0.5)
                if not _is_number(mid) or not 0.0 < mid < 1.0:
                    raise FormulaError("midpoint must be in (0, 1)")
                scale = body.get("scale", 1.0)
                if not _is_number(scale) or scale <= 0:
                    raise FormulaError("scale must be > 0")
            return spec
        # anything else dict-shaped is a filter condition — defer its
        # validation to the filter parser at eval-bind time
        if not spec:
            raise FormulaError("empty object is not a formula node")
        return spec
    raise FormulaError(f"bad formula node: {spec!r}")


class FormulaContext:
    """Evaluation context bound to one candidate set.

    ids:            [C] candidate row ids (ascending)
    branch_scores:  per prefetch branch, {row id: score}
    payloads_of:    BATCHED fetcher: [row ids] -> [payload dicts]
                    (called at most once, lazily — one sidecar-seek
                    pass instead of one call per candidate)
    condition_mask: filter-condition spec -> bool array indexed by ROW
                    id (the engine's cached filter machinery)
    defaults:       {"$score": v, payload_key: v} fallbacks
    """

    def __init__(self, ids, branch_scores, payloads_of: Callable,
                 condition_mask: Callable,
                 defaults: Optional[dict] = None):
        self.ids = np.asarray(ids, np.int64)
        self.branch_scores = list(branch_scores)
        self._payloads_of = payloads_of
        self._condition_mask = condition_mask
        self.defaults = dict(defaults or {})
        self._payloads: Optional[list] = None

    def payloads(self) -> list:
        if self._payloads is None:
            self._payloads = [p or {} for p in
                              self._payloads_of([int(i)
                                                 for i in self.ids])]
        return self._payloads

    # -- variable resolution -------------------------------------------

    def score_var(self, branch: Optional[int]) -> np.ndarray:
        out = np.empty(len(self.ids), np.float64)
        default = self.defaults.get("$score")
        for r, pid in enumerate(self.ids):
            pid = int(pid)
            if branch is None:
                v = next((b[pid] for b in self.branch_scores
                          if pid in b), None)
            else:
                if branch >= len(self.branch_scores):
                    raise FormulaError(
                        f"$score[{branch}] but only "
                        f"{len(self.branch_scores)} prefetch branches")
                v = self.branch_scores[branch].get(pid)
            if v is None:
                if default is None:
                    raise FormulaError(
                        "a candidate has no prefetch score for "
                        f"$score{'' if branch is None else f'[{branch}]'}"
                        " — provide defaults={'$score': ...}")
                v = default
            out[r] = float(v)
        return out

    def payload_var(self, key: str) -> np.ndarray:
        segs = _path_segments(key) or [key]
        default = self.defaults.get(key)
        out = np.empty(len(self.ids), np.float64)
        for r, payload in enumerate(self.payloads()):
            vals: list = []
            _collect_path(payload if isinstance(payload, dict) else {},
                          segs, 0, vals)
            v = vals[0] if vals else None
            if v is None:
                v = default
            if v is None:
                raise FormulaError(
                    f"payload key {key!r} missing on point "
                    f"{int(self.ids[r])} and no default given")
            out[r] = _to_number(v, key=key)
        return out

    def geo_var(self, key: str) -> np.ndarray:
        """Payload geo points as (lon, lat) DEGREE pairs — the units
        the shared filter haversine takes."""
        segs = _path_segments(key) or [key]
        out = np.empty((len(self.ids), 2), np.float64)
        for r, payload in enumerate(self.payloads()):
            vals: list = []
            _collect_path(payload if isinstance(payload, dict) else {},
                          segs, 0, vals)
            if not vals:
                raise FormulaError(f"geo payload key {key!r} missing on "
                                   f"point {int(self.ids[r])}")
            lon, lat = _geo_point(vals[0], what=f"payload key {key!r}")
            out[r] = (lon, lat)
        return out

    def condition(self, spec: dict) -> np.ndarray:
        mask = self._condition_mask(spec)
        return np.asarray(mask, bool)[self.ids].astype(np.float64)


def _to_number(v: Any, *, key: str) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if _is_number(v):
        return float(v)
    if isinstance(v, str):
        try:
            return _parse_datetime(v, what=f"payload key {key!r}")
        except Exception:
            raise FormulaError(
                f"payload key {key!r} value {v!r} is neither a number "
                "nor an RFC 3339 datetime") from None
    raise FormulaError(f"payload key {key!r} value {v!r} is not numeric")


def _decay_lambda(op: str, midpoint: float, scale: float) -> float:
    if op == "exp_decay":
        return math.log(midpoint) / scale
    if op == "gauss_decay":
        return math.log(midpoint) / (scale * scale)
    return (1.0 - midpoint) / scale          # lin_decay slope


def eval_formula(spec: Any, ctx: FormulaContext) -> np.ndarray:
    """Evaluate a parsed formula over the context's candidates.
    Returns [C] float64 scores."""
    n = len(ctx.ids)
    if _is_number(spec):
        return np.full(n, float(spec), np.float64)
    if isinstance(spec, str):
        m = _SCORE_RE.match(spec)
        if m:
            return ctx.score_var(int(m.group(1)) if m.group(1) else None)
        return ctx.payload_var(spec)
    if isinstance(spec, dict):
        op_keys = [k for k in spec if k in _OPS]
        if len(op_keys) == 1 and len(spec) == 1:
            op, body = op_keys[0], spec[op_keys[0]]
            if op == "sum":
                out = np.zeros(n, np.float64)
                for e in body:
                    out = out + eval_formula(e, ctx)
                return out
            if op == "mult":
                out = np.ones(n, np.float64)
                for e in body:
                    out = out * eval_formula(e, ctx)
                return out
            if op == "div":
                left = eval_formula(body["left"], ctx)
                right = eval_formula(body["right"], ctx)
                zero = right == 0
                if zero.any():
                    if "by_zero_default" not in body:
                        raise FormulaError(
                            "division by zero (set by_zero_default)")
                    return np.where(zero, float(body["by_zero_default"]),
                                    np.divide(left,
                                              np.where(zero, 1.0, right)))
                return left / right
            if op == "pow":
                return np.power(eval_formula(body["base"], ctx),
                                eval_formula(body["exponent"], ctx))
            if op == "neg":
                return -eval_formula(body, ctx)
            if op == "abs":
                return np.abs(eval_formula(body, ctx))
            if op == "sqrt":
                return np.sqrt(eval_formula(body, ctx))
            if op == "exp":
                return np.exp(eval_formula(body, ctx))
            if op == "ln":
                return np.log(eval_formula(body, ctx))
            if op == "log10":
                return np.log10(eval_formula(body, ctx))
            if op == "geo_distance":
                # the SAME clamped haversine the geo filter conditions
                # use (float error near antipodes can push the arcsin
                # argument past 1.0 -> NaN without the clamp)
                lon0, lat0 = _geo_point(body["origin"],
                                        what="geo_distance origin")
                pts = ctx.geo_var(body["to"])
                return _haversine_m(pts[:, 0], pts[:, 1], lon0, lat0)
            # decays
            x = eval_formula(body["x"], ctx)
            target = body.get("target", 0.0)
            if isinstance(target, str):
                # an RFC 3339 string is a datetime constant; any other
                # string is a normal variable node (payload key /
                # $score) — the docstring's "datetime payload key"
                try:
                    t = np.full(n, _parse_datetime(
                        target, what=f"{op} target"), np.float64)
                except Exception:
                    t = eval_formula(target, ctx)
            else:
                t = eval_formula(target, ctx)
            midpoint = float(body.get("midpoint", 0.5))
            scale = float(body.get("scale", 1.0))
            lam = _decay_lambda(op, midpoint, scale)
            d = np.abs(x - t)
            if op == "lin_decay":
                return np.maximum(0.0, 1.0 - lam * d)
            if op == "exp_decay":
                return np.exp(lam * d)
            return np.exp(lam * d * d)           # gauss_decay
        return ctx.condition(spec)
    raise FormulaError(f"bad formula node: {spec!r}")
