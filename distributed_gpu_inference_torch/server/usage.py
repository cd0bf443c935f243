"""Usage metering and billing.

Behavioral parity with the reference's ``server/app/services/usage.py``:
- Per-job usage records in units of tokens / pixels / seconds.
- Default price table (:178-186) with enterprise custom pricing and price
  plans overriding it (:171-175).
- Hourly aggregation (:323) and platform-wide stats (:387).
- Bill generation over a period with per-type line items.

The port's copy of ``distributed_gpu_inference_tpu/server/usage.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from .store import Store

# price per unit (reference usage.py:178-186); units per type below
DEFAULT_PRICES: Dict[str, float] = {
    "llm": 0.000002,         # per token
    "embedding": 0.0000001,  # per token
    "image_gen": 0.00000001,  # per pixel
    "vision": 0.000004,      # per token
    "whisper": 0.0001,       # per audio second
}

UNIT_KINDS: Dict[str, str] = {
    "llm": "tokens",
    "embedding": "tokens",
    "image_gen": "pixels",
    "vision": "tokens",
    "whisper": "seconds",
}


def units_from_result(job_type: str, params: Optional[Dict[str, Any]],
                      result: Optional[Dict[str, Any]]) -> float:
    """Derive billable units from a job's params/result payloads."""
    params = params or {}
    result = result or {}
    if job_type in ("llm", "vision", "embedding"):
        usage = result.get("usage") or {}
        total = usage.get("total_tokens")
        if total is None:
            total = (usage.get("prompt_tokens") or 0) + (
                usage.get("completion_tokens") or 0
            )
        return float(total or 0)
    if job_type == "image_gen":
        w = int(params.get("width") or 1024)
        h = int(params.get("height") or 1024)
        n = int(params.get("num_images") or 1)
        return float(w * h * n)
    if job_type == "whisper":
        return float(result.get("audio_seconds") or params.get("audio_seconds") or 0)
    return 0.0


class UsageService:
    def __init__(self, store: Store) -> None:
        self._store = store

    async def _price_for(self, enterprise_id: Optional[str],
                         job_type: str) -> float:
        if enterprise_id:
            ent = await self._store.get("enterprises", enterprise_id)
            if ent:
                custom = ent.get("custom_pricing") or {}
                if job_type in custom:
                    return float(custom[job_type])
                plan_id = ent.get("price_plan_id")
                if plan_id:
                    plan = await self._store.get("price_plans", plan_id)
                    if plan and job_type in (plan.get("prices") or {}):
                        return float(plan["prices"][job_type])
        return DEFAULT_PRICES.get(job_type, 0.0)

    async def record_job_usage(self, job: Dict[str, Any],
                               enterprise_id: Optional[str] = None
                               ) -> Dict[str, Any]:
        job_type = job["type"]
        params = job.get("params") or {}
        units = units_from_result(job_type, params, job.get("result"))
        price = await self._price_for(enterprise_id, job_type)
        cost = units * price
        rec = {
            "enterprise_id": enterprise_id,
            "job_id": job["id"],
            "job_type": job_type,
            "worker_id": job.get("worker_id"),
            # overload control: the tenant/tier the plane
            # admitted the job under — per-tenant accounting shares the
            # table billing reads, so admission fairness is auditable
            "tenant": params.get("tenant"),
            "tier": params.get("tier"),
            "units": units,
            "unit_kind": UNIT_KINDS.get(job_type, "units"),
            "cost": cost,
        }
        rec["id"] = await self._store.insert("usage_records", dict(rec))
        return rec

    # -- aggregation ---------------------------------------------------------

    async def hourly_summary(self, enterprise_id: Optional[str] = None,
                             since: Optional[float] = None
                             ) -> List[Dict[str, Any]]:
        since = since if since is not None else time.time() - 24 * 3600
        sql = (
            "SELECT CAST(created_at / 3600 AS INTEGER) * 3600 AS hour, "
            "job_type, COUNT(*) AS jobs, SUM(units) AS units, "
            "SUM(cost) AS cost FROM usage_records WHERE created_at >= ?"
        )
        params: List[Any] = [since]
        if enterprise_id is not None:
            sql += " AND enterprise_id = ?"
            params.append(enterprise_id)
        sql += " GROUP BY hour, job_type ORDER BY hour"
        return await self._store.query(sql, params)

    async def tenant_summary(self, since: Optional[float] = None
                             ) -> List[Dict[str, Any]]:
        """Per-tenant usage aggregation (overload control): the
        consumption side of the admission budgets — jobs, units, and cost
        grouped by the tenant/tier stamped at admission. Untenanted
        legacy records group under NULL."""
        since = since if since is not None else time.time() - 24 * 3600
        return await self._store.query(
            "SELECT tenant, tier, COUNT(*) AS jobs, SUM(units) AS units, "
            "SUM(cost) AS cost FROM usage_records WHERE created_at >= ? "
            "GROUP BY tenant, tier ORDER BY units DESC", (since,),
        )

    async def platform_stats(self) -> Dict[str, Any]:
        rows = await self._store.query(
            "SELECT job_type, COUNT(*) AS jobs, SUM(units) AS units, "
            "SUM(cost) AS cost FROM usage_records GROUP BY job_type"
        )
        total_cost = sum(float(r["cost"] or 0) for r in rows)
        return {"by_type": rows, "total_cost": total_cost}

    # -- billing --------------------------------------------------------------

    async def generate_bill(self, enterprise_id: str, period_start: float,
                            period_end: float) -> Dict[str, Any]:
        rows = await self._store.query(
            "SELECT job_type, COUNT(*) AS jobs, SUM(units) AS units, "
            "SUM(cost) AS cost FROM usage_records "
            "WHERE enterprise_id=? AND created_at>=? AND created_at<? "
            "GROUP BY job_type",
            (enterprise_id, period_start, period_end),
        )
        line_items = [
            {
                "job_type": r["job_type"],
                "jobs": r["jobs"],
                "units": float(r["units"] or 0),
                "cost": float(r["cost"] or 0),
            }
            for r in rows
        ]
        total = sum(li["cost"] for li in line_items)
        bill = {
            "enterprise_id": enterprise_id,
            "period_start": period_start,
            "period_end": period_end,
            "total_cost": total,
            "line_items": line_items,
            "status": "open",
        }
        bill["id"] = await self._store.insert("bills", dict(bill))
        return bill
