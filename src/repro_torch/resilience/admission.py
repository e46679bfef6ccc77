"""Per-request admission control: poison stays out of the session (the
port's copy of ``repro.resilience.admission``).

A serving process dies two ways: a fault kills it (the retry path's
job) or a *request* corrupts it — a NaN personalization vector seeds
NaN fluid that converges never and poisons H for every later request;
a graph delta built against a stale store version splices the wrong
edges.  Admission rejects those per request — the session state is
untouched, the stream keeps flowing — and the :class:`Quarantine`
keeps the evidence.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graph.delta import GraphDelta, edge_keys

__all__ = ["RequestRejected", "Quarantine", "validate_rhs",
           "validate_graph_update"]


class RequestRejected(ValueError):
    """A request that must not reach the session. ``reason`` is the
    machine-readable category, the str() the human detail."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason


def validate_rhs(b, n: int, name: str = "b") -> np.ndarray:
    """Admit a personalization / teleport vector or reject it.

    The checks mirror what the §2.2 invariant needs to stay a usable
    oracle: finite entries (NaN/Inf fluid never drains), nonnegative
    mass (PageRank teleport vectors are measures), and positive total
    mass (an all-zero B makes convergence vacuous and the served
    ranking meaningless).  Returns the validated float64 copy.
    """
    arr = np.asarray(b, dtype=np.float64)
    if arr.shape != (n,):
        raise RequestRejected(
            "bad-shape", f"{name} has shape {arr.shape}, expected ({n},)")
    if not np.isfinite(arr).all():
        bad = int(np.flatnonzero(~np.isfinite(arr))[0])
        raise RequestRejected(
            "non-finite", f"{name}[{bad}] = {arr[bad]} is not finite")
    if (arr < 0.0).any():
        bad = int(np.flatnonzero(arr < 0.0)[0])
        raise RequestRejected(
            "negative-mass", f"{name}[{bad}] = {arr[bad]} < 0 — teleport "
            "vectors are nonnegative measures")
    if arr.sum() <= 0.0:
        raise RequestRejected(
            "zero-mass", f"{name} has no mass (sum = {arr.sum()})")
    return arr


def validate_graph_update(store, delta,
                          store_version: Optional[int] = None,
                          queued: int = 0,
                          check_membership: bool = True) -> None:
    """Admit a graph delta against the store's CURRENT state or reject.

    * ``store_version`` (when the client pins one) must match the
      store's *logical* version ``store.version + queued`` — ``queued``
      counts deltas admitted but deferred by the degradation ladder,
      which WILL apply (in order) before this one, so a client tracking
      the update stream is ahead of the store by exactly that many
      versions.  A mismatch means the delta was computed against a
      state the store will never pass through;
    * every endpoint must be a valid node id;
    * weights must be finite and positive (P is substochastic);
    * removed / reweighted edges must exist, added edges must NOT —
      membership is checked against the canonical CSR via the shared
      ``edge_keys`` identity, the same oracle the splice itself uses,
      so admission rejects exactly what the splice would die on.
      Membership is only decidable against the state the delta will
      actually apply to — pass ``check_membership=False`` while deltas
      are queued ahead of it (the transactional apply still validates
      at flush time; a conflict there is quarantined, not fatal).
    """
    if not isinstance(delta, GraphDelta):
        raise RequestRejected(
            "malformed-delta",
            f"expected a GraphDelta, got {type(delta).__name__}")
    if store_version is not None and store.version + queued != store_version:
        raise RequestRejected(
            "stale-store-version",
            f"delta built against store version {store_version}, store "
            f"is at {store.version} with {queued} queued")
    n = store.n
    pairs = np.concatenate([delta.added, delta.removed, delta.reweighted])
    if pairs.size and ((pairs < 0).any() or (pairs >= n).any()):
        bad = pairs[((pairs < 0) | (pairs >= n)).any(axis=1)][0]
        raise RequestRejected(
            "bad-endpoint",
            f"edge ({bad[0]}, {bad[1]}) outside node range [0, {n})")
    for w, group in ((delta.added_w, "added"),
                     (delta.reweighted_w, "reweighted")):
        if w.size and (~np.isfinite(w) | (w <= 0.0)).any():
            bad = float(w[(~np.isfinite(w) | (w <= 0.0))][0])
            raise RequestRejected(
                "bad-weight", f"{group} weight {bad} is not a finite "
                "positive value")
    if not check_membership:
        return
    src_e, dst_e, _ = store.csr().edge_list()
    sorted_keys = edge_keys(src_e, dst_e)

    def member(group_pairs: np.ndarray) -> np.ndarray:
        if group_pairs.shape[0] == 0:
            return np.zeros(0, dtype=bool)
        keys = GraphDelta._keys(group_pairs)
        pos = np.searchsorted(sorted_keys, keys)
        return ((pos < sorted_keys.size)
                & (sorted_keys[np.minimum(pos, sorted_keys.size - 1)]
                   == keys))

    for group_pairs, must_exist, group in (
            (delta.removed, True, "removed"),
            (delta.reweighted, True, "reweighted"),
            (delta.added, False, "added")):
        ok = member(group_pairs)
        if must_exist and not ok.all():
            bad = group_pairs[~ok][0]
            raise RequestRejected(
                "missing-edge", f"{group} edge ({bad[0]}, {bad[1]}) does "
                "not exist in the store")
        if not must_exist and ok.any():
            bad = group_pairs[ok][0]
            raise RequestRejected(
                "duplicate-edge", f"added edge ({bad[0]}, {bad[1]}) "
                "already exists in the store")


class Quarantine:
    """Evidence locker for rejected requests: per-reason counters plus
    the ordered (request_id, reason) trail the soak asserts against."""

    def __init__(self):
        self.by_reason: Dict[str, int] = {}
        self.entries: List[Tuple[object, str]] = []

    def record(self, request_id, reason: str) -> None:
        self.by_reason[reason] = self.by_reason.get(reason, 0) + 1
        self.entries.append((request_id, reason))

    @property
    def total(self) -> int:
        return len(self.entries)

    def to_jsonable(self) -> Dict:
        return {"total": self.total, "by_reason": dict(self.by_reason)}
