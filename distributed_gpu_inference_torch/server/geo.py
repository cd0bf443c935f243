"""Client IP → region detection with TTL cache and pluggable resolvers.

Behavioral parity with the reference's ``server/app/services/geo.py``:
- Country→region table (:11-36).
- In-memory TTL cache (:38-41).
- Primary + fallback external resolvers (:121, :144) — here pluggable async
  callables, network access gated off by default so tests and air-gapped
  deployments stay hermetic.
- Private/loopback IPs short-circuit to "unknown".

The port's copy of ``distributed_gpu_inference_tpu/server/geo.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import ipaddress
import time
from typing import Any, Awaitable, Callable, Dict, Optional

COUNTRY_TO_REGION: Dict[str, str] = {
    # north america
    "US": "us-west", "CA": "us-west", "MX": "us-west",
    # europe
    "GB": "eu-west", "IE": "eu-west", "FR": "eu-west", "ES": "eu-west",
    "PT": "eu-west", "NL": "eu-west", "BE": "eu-west",
    "DE": "eu-central", "AT": "eu-central", "CH": "eu-central",
    "PL": "eu-central", "CZ": "eu-central", "IT": "eu-central",
    "SE": "eu-central", "NO": "eu-central", "DK": "eu-central", "FI": "eu-central",
    # asia
    "CN": "asia-east", "JP": "asia-east", "KR": "asia-east", "TW": "asia-east",
    "HK": "asia-east",
    "SG": "asia-southeast", "TH": "asia-southeast", "VN": "asia-southeast",
    "MY": "asia-southeast", "ID": "asia-southeast", "PH": "asia-southeast",
    "IN": "asia-southeast", "AU": "asia-southeast", "NZ": "asia-southeast",
}
DEFAULT_REGION = "unknown"
CACHE_TTL_S = 3600.0

# An async resolver takes an IP string and returns {"country": "US", ...} or None.
Resolver = Callable[[str], Awaitable[Optional[Dict[str, Any]]]]


def region_for_country(country: Optional[str]) -> str:
    return COUNTRY_TO_REGION.get((country or "").upper(), DEFAULT_REGION)


def is_private_ip(ip: str) -> bool:
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return True
    return addr.is_private or addr.is_loopback or addr.is_link_local


class GeoService:
    def __init__(self, resolvers: Optional[list[Resolver]] = None,
                 cache_ttl_s: float = CACHE_TTL_S) -> None:
        # no resolvers by default: hermetic (reference reaches ip-api.com then
        # ipinfo.io; deployments inject HTTP resolvers via make_http_resolver)
        self._resolvers = resolvers or []
        self._ttl = cache_ttl_s
        self._cache: Dict[str, tuple[float, str]] = {}

    def cache_put(self, ip: str, region: str,
                  now: Optional[float] = None) -> None:
        self._cache[ip] = (time.time() if now is None else now, region)

    def cache_get(self, ip: str, now: Optional[float] = None) -> Optional[str]:
        hit = self._cache.get(ip)
        if hit is None:
            return None
        ts, region = hit
        now = time.time() if now is None else now
        if now - ts > self._ttl:
            del self._cache[ip]
            return None
        return region

    async def detect_client_region(self, ip: Optional[str]) -> str:
        """Reference ``geo.py:70`` — cache → resolver chain → unknown."""
        if not ip or is_private_ip(ip):
            return DEFAULT_REGION
        cached = self.cache_get(ip)
        if cached is not None:
            return cached
        for resolver in self._resolvers:
            try:
                info = await resolver(ip)
            except Exception:  # noqa: BLE001 — fall through to next resolver
                continue
            if info and info.get("country"):
                region = region_for_country(info["country"])
                self.cache_put(ip, region)
                return region
        return DEFAULT_REGION


def make_http_resolver(url_template: str, country_key: str = "country",
                       timeout_s: float = 3.0) -> Resolver:
    """Builds a resolver on ``urllib.request``, e.g.
    ``make_http_resolver("http://ip-api.com/json/{ip}", "countryCode")``.
    The blocking fetch runs on the loop's default executor, so a slow
    resolver never stalls the control plane."""

    def fetch(ip: str) -> Optional[Dict[str, Any]]:
        import json
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(url_template.format(ip=ip),
                                        timeout=timeout_s) as resp:
                if resp.status != 200:
                    return None
                return json.loads(resp.read())
        except urllib.error.HTTPError:
            return None

    async def resolve(ip: str) -> Optional[Dict[str, Any]]:
        import asyncio

        data = await asyncio.get_running_loop().run_in_executor(None, fetch, ip)
        if not isinstance(data, dict):
            return None
        country = data.get(country_key)
        return {"country": country} if country else None

    return resolve
