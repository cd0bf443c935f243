"""Replicated control planes: identity, peer membership, job forwarding.

One control plane is a SPOF and a throughput ceiling. This
module makes the plane a *cohort*: N ``server/app.py`` replicas share one
job store (``server/store.py`` is multi-writer hardened — WAL, busy-timeout,
locked-retry, fenced conditional UPDATEs) and each replica carries a
``plane_id`` stamped on every claim it brokers. Workers and SDK clients hold
the full endpoint list and fail over; the store's assignment-epoch fence
rejects a stale plane's late writes exactly like a stale worker's.

Plane-to-plane job forwarding closes the reference platform's scaffold TODO
(PAPER.md §0: server-to-server dispatch was left unimplemented): a
submission landing on a plane that cannot accept it locally (queue
saturated, no live workers) is forwarded to a peer instead of bounced to
the client. Forwarding is bounded and loop-fenced by an explicit hop chain
(``X-DGI-Plane-Hops``): a plane whose id is already in the chain never
re-forwards, and the chain length is capped (``DGI_PLANE_FORWARD_MAX_HOPS``).

Everything here is OFF by default: a ``ServerState`` constructed without
plane arguments behaves byte-identically to the single-plane build (no new
response fields, no forwarding, claims stamp a NULL plane_id).

The port's copy of ``distributed_gpu_inference_tpu/server/plane_cluster.py``:
forwarding posts through ``http.client`` on the loop's default executor
(one connection per call, ``_FORWARD_TIMEOUT_S`` as its socket timeout)
instead of an aiohttp session.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import os
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

# hop-chain header: comma-separated plane_ids the submission already visited
HOPS_HEADER = "X-DGI-Plane-Hops"

_DEF_MAX_HOPS = int(os.environ.get("DGI_PLANE_FORWARD_MAX_HOPS", "2"))
_FORWARD_TIMEOUT_S = float(
    os.environ.get("DGI_PLANE_FORWARD_TIMEOUT_S", "5.0")
)


def _parse_chain(raw: Optional[str]) -> List[str]:
    if not raw:
        return []
    return [p.strip() for p in raw.split(",") if p.strip()][:16]


class PlaneCluster:
    """This replica's identity + its view of the plane cohort.

    ``enabled`` is True only when the deployment opted into multi-plane
    (a plane_id or peer list was configured); every caller gates its
    behavior change on it, which is what keeps the single-plane
    configuration byte-identical to the pre-cohort build.
    """

    def __init__(self, plane_id: Optional[str] = None,
                 peers: Optional[Sequence[str]] = None,
                 forward_max_hops: Optional[int] = None,
                 api_key: Optional[str] = None) -> None:
        self.enabled = bool(plane_id) or bool(peers)
        self.plane_id = plane_id or (
            f"plane-{uuid.uuid4().hex[:8]}" if self.enabled else None
        )
        self.peers: List[str] = [
            str(u).rstrip("/") for u in (peers or []) if u
        ]
        self.forward_max_hops = (
            _DEF_MAX_HOPS if forward_max_hops is None
            else max(0, int(forward_max_hops))
        )
        self._api_key = api_key
        # counters surfaced through /metrics (record_request) and /health
        self.stats: Dict[str, int] = {
            "forwarded": 0, "forward_failed": 0,
            "received_forwarded": 0, "loop_fenced": 0,
        }

    # -- claim stamping -----------------------------------------------------

    @property
    def claim_stamp(self) -> Optional[str]:
        """plane_id written on claims this replica brokers (None when the
        cohort is disabled — the column stays NULL, as single-writer)."""
        return self.plane_id if self.enabled else None

    # -- forwarding ---------------------------------------------------------

    def may_forward(self, chain: Sequence[str]) -> bool:
        """Loop fence + hop bound: forward only when the cohort is enabled,
        a peer exists, our own id is not already in the chain (loop), and
        the chain has hops left."""
        if not (self.enabled and self.peers):
            return False
        if self.plane_id in chain:
            self.stats["loop_fenced"] += 1
            return False
        if len(chain) >= self.forward_max_hops:
            return False
        return True

    def note_received(self, chain: Sequence[str]) -> None:
        if chain:
            self.stats["received_forwarded"] += 1

    @staticmethod
    def _post(url: str, body: bytes,
              headers: Dict[str, str]) -> Tuple[int, bytes]:
        """One blocking POST → (status, body bytes); transport failures
        raise OSError / http.client.HTTPException."""
        u = urlsplit(url)
        cls = (http.client.HTTPSConnection if u.scheme == "https"
               else http.client.HTTPConnection)
        conn = cls(u.hostname, u.port, timeout=_FORWARD_TIMEOUT_S)
        try:
            conn.request("POST", u.path or "/", body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    async def forward_job(
        self, body: Dict[str, Any], chain: Sequence[str],
        sync: bool = False,
    ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """POST the submission to the first peer that accepts it.

        Returns ``(status, payload)`` from the accepting peer — any
        definitive answer (2xx, or a 4xx the client caused) is relayed
        verbatim. Peers that are down (transport error) or themselves
        capacity-rejecting (429/503) are skipped; None means every peer
        declined and the caller should return its own local rejection.
        """
        if not self.may_forward(chain):
            return None
        new_chain = ",".join([*chain, str(self.plane_id)])
        headers = {HOPS_HEADER: new_chain, "Content-Type": "application/json"}
        if self._api_key:
            headers["X-API-Key"] = self._api_key
        path = "/api/v1/jobs/sync" if sync else "/api/v1/jobs"
        data = json.dumps(body).encode()
        loop = asyncio.get_running_loop()
        for peer in self.peers:
            try:
                status, raw = await loop.run_in_executor(
                    None, self._post, peer + path, data, headers)
                if status in (429, 503):
                    continue         # peer has no capacity either
                payload = json.loads(raw)
                self.stats["forwarded"] += 1
                if isinstance(payload, dict):
                    payload.setdefault("forwarded_via", self.plane_id)
                return status, payload
            except (OSError, http.client.HTTPException, ValueError):
                continue             # dead/unreachable peer: try the next
        self.stats["forward_failed"] += 1
        return None

    async def close(self) -> None:
        """Nothing to release: every forward opens and closes its own
        connection (kept so the app's cleanup hook reads as the JAX one)."""

    # -- introspection ------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        return {
            "id": self.plane_id,
            "peers": list(self.peers),
            "forward_max_hops": self.forward_max_hops,
            "stats": dict(self.stats),
        }
