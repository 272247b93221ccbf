"""Multi-region deployment catalog + optimal-region scoring + failover.

Rebirth of reference globalization/deployment.py:17-488 (region catalog
with capabilities+compliance, optimal-region scoring, deployment records,
failover trigger) — regions are real TPU regions with their available
generations.

The port's copy of ``photonic_flash_attention_tpu/globalization/deployment.py``, which imports no
JAX: the port may not import the JAX package, so it keeps its own.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from .compliance import Regime


@dataclasses.dataclass(frozen=True)
class Region:
    name: str
    location: str
    tpu_generations: tuple
    regimes: tuple  # compliance regimes satisfiable in-region
    latency_ms_estimate: Dict[str, float]  # to major user geos


REGION_CATALOG: Dict[str, Region] = {
    "us-central1": Region(
        "us-central1", "US", ("v5e", "v5p"), (Regime.CCPA,),
        {"us": 20.0, "eu": 110.0, "apac": 150.0},
    ),
    "us-east5": Region(
        "us-east5", "US", ("v5p", "v6e"), (Regime.CCPA,),
        {"us": 25.0, "eu": 90.0, "apac": 180.0},
    ),
    "europe-west4": Region(
        "europe-west4", "EU", ("v5e", "v5p"), (Regime.GDPR,),
        {"us": 100.0, "eu": 15.0, "apac": 200.0},
    ),
    "asia-northeast1": Region(
        "asia-northeast1", "APAC", ("v5e",), (Regime.PDPA,),
        {"us": 140.0, "eu": 210.0, "apac": 30.0},
    ),
}


@dataclasses.dataclass
class DeploymentRecord:
    region: str
    deployed_at: float
    healthy: bool = True
    serving: bool = True


class RegionManager:
    """Region scoring + deployment records + failover (reference)."""

    def __init__(self, catalog: Optional[Dict[str, Region]] = None) -> None:
        self.catalog = dict(catalog or REGION_CATALOG)
        self._deployments: Dict[str, DeploymentRecord] = {}
        self._lock = threading.RLock()

    def score_region(
        self,
        region: Region,
        user_geo: str = "us",
        required_regime: Optional[Regime] = None,
        preferred_generation: Optional[str] = None,
    ) -> float:
        """Higher is better (reference optimal-region scoring)."""
        if required_regime is not None and required_regime not in region.regimes:
            return float("-inf")
        score = 100.0 - region.latency_ms_estimate.get(user_geo, 250.0)
        if preferred_generation and preferred_generation in region.tpu_generations:
            score += 25.0
        rec = self._deployments.get(region.name)
        if rec is not None and not rec.healthy:
            score -= 1000.0
        return score

    def optimal_region(
        self,
        user_geo: str = "us",
        required_regime: Optional[Regime] = None,
        preferred_generation: Optional[str] = None,
    ) -> Optional[str]:
        best, best_score = None, float("-inf")
        for name, region in self.catalog.items():
            s = self.score_region(region, user_geo, required_regime, preferred_generation)
            if s > best_score:
                best, best_score = name, s
        return best if best_score > float("-inf") else None

    def deploy(self, region: str) -> DeploymentRecord:
        if region not in self.catalog:
            raise ValueError(f"unknown region {region!r}")
        with self._lock:
            rec = DeploymentRecord(region, time.time())
            self._deployments[region] = rec
            return rec

    def mark_unhealthy(self, region: str) -> Optional[str]:
        """Failover trigger (reference :327-346): mark down, return the
        best healthy alternative."""
        with self._lock:
            rec = self._deployments.get(region)
            if rec is not None:
                rec.healthy = False
                rec.serving = False
        return self.optimal_region()

    def status(self) -> Dict:
        with self._lock:
            return {
                "regions": list(self.catalog),
                "deployments": {
                    name: dataclasses.asdict(rec)
                    for name, rec in self._deployments.items()
                },
            }
