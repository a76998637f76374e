"""Wire-protocol versioning — explicit version negotiation per RPC.

A fleet under rolling upgrade is never all one version: for the window
where old and new binaries coexist, every peer must either understand
the other's wire surface or refuse it HONESTLY. The reference gets
this for free from a stateless binary behind a k8s Deployment; our
stateful workers, fenced leader, and durable placement map make mixed-
version operation a real correctness problem (ROADMAP open item 4).
The discipline mirrors leadership fencing (cluster/fencing.py):

- every outbound RPC at the shared HTTP seams (``http_get`` /
  ``http_post`` / ``_ScatterClient.post`` / ``http_get_stream`` in
  cluster/node.py) stamps ``X-Proto-Version`` with the sender's wire
  version, beside ``X-Leader-Epoch`` where that rides;
- every front-plane reply stamps ``X-Proto-Version`` with the
  server's version (``_HttpHandlerBase._send``), so either side of
  any exchange can detect skew;
- handlers on the data planes (``/leader/*``, ``/worker/*``) accept a
  declared compat window ``[proto_min_compat, +inf)``: a request whose
  declared version is BELOW the floor is answered with the distinct
  status ``426 Upgrade Required`` + ``X-Proto-Rejected: 1`` —
  non-retryable and never a worker fault (a version cannot come back
  by retrying), so it never trips breakers
  (:func:`cluster.resilience.is_proto_rejection`);
- a request with NO version header is implicitly version 1 — the
  pre-versioning wire every binary before this module spoke. With the
  default floor of 1, old binaries interoperate unchanged; an operator
  raises the floor only after the whole fleet has upgraded past it;
- versions NEWER than ours are accepted (forward compatibility: a
  newer peer only ever ADDS surface, and unknown headers pass
  through untouched — pinned in tests/test_upgrade.py). Rejection is
  one-sided: only the floor rejects.

Ops endpoints (``/api/*``, metrics, trace export) are deliberately
version-agnostic: an operator must be able to inspect a node whatever
binary it runs — exactly the reads-unfenced choice fencing made.

The version itself is part of the machine-checked wire contract:
graftcheck's protocol pass (tools/graftcheck/protocol.py) reads
``PROTO_VERSION`` from this module, cross-checks it against the README
contract table's declared version and the pinned contract fingerprint,
and flags any wire-surface change that lands without a version bump.

Version history (bump PROTO_VERSION when the wire surface changes in
a way an old peer could misread; update the README fingerprint and the
``since``/``until`` columns in the same commit):

  1  the implicit pre-versioning wire : no version header.
  2  this module: X-Proto-Version / X-Proto-Rejected, 426 rejections,
     capture/replay request log, /api/health proto_version field.
  3  hybrid retrieval: additive ``mode`` (sparse|dense|hybrid) and
     ``fusion`` (rrf|wsum) fields on /leader/start and ``mode`` on
     /worker/process-batch (all slice re-issues too); staged replies
     carry 2n hit lists (n sparse then n dense) on the v2 packed
     wire; /leader/start replies stamp X-Search-Stages; /api/health
     gains the ``embedding`` block. Absent fields mean sparse — a
     v2 request is byte-for-byte a valid v3 sparse request, and a
     v2 worker that ignores ``mode`` replies n lists, which the
     leader's slot-count check catches (honest degradation, never a
     silently sparse-only "hybrid" result).
  4  compute-plane chaos: additive reply headers only.
     Workers stamp X-Compute-Degraded on 2xx replies served from the
     host mirror and X-Compute-Fault (+ X-Poison-Fingerprints for
     poison) on compute-fault 500s; the read plane answers 422 +
     X-Poison-Quarantined for quarantined queries and relays
     X-Compute-Degraded on merged replies. A v3 peer ignoring every
     new header sees the v3 wire unchanged (extra headers on replies
     it already handles; the 422 is the application-rejection class
     v3 clients already never retry).
"""

from __future__ import annotations

# the current wire-protocol version this binary speaks (see history
# table above — bump beside any wire-surface change)
PROTO_VERSION = 4

# the wire contract (stamped/checked at the shared HTTP seams)
PROTO_HEADER = "X-Proto-Version"
PROTO_REJECTED_HEADER = "X-Proto-Rejected"
PROTO_STATUS = 426          # Upgrade Required: distinct, non-retryable

# the version implicitly declared by a request with no version header:
# every binary that predates this module
IMPLICIT_VERSION = 1


def proto_headers() -> dict:
    """The outbound stamp every RPC carries (beside the fence epoch
    where that rides)."""
    return {PROTO_HEADER: str(PROTO_VERSION)}


def parse_version(value) -> int:
    """The wire version a request declares. ``value`` is the raw
    ``X-Proto-Version`` header (or None). Absent or malformed headers
    are the implicit pre-versioning wire — permissive by construction,
    like a malformed trace id: garbage never escalates to a rejection
    the sender cannot act on."""
    if value is None:
        return IMPLICIT_VERSION
    try:
        v = int(str(value).strip())
    except ValueError:
        return IMPLICIT_VERSION
    return v if v >= 1 else IMPLICIT_VERSION


def in_window(peer_version: int, min_compat: int) -> bool:
    """The compat-window rule: accept any peer at or above the floor.
    There is deliberately no ceiling — a newer peer is always accepted
    (forward compatibility; unknown headers pass through), so a rolling
    upgrade can proceed in either direction one process at a time."""
    return peer_version >= min_compat
