"""Data-compliance bookkeeping: record registry, consent, retention.

Rebirth of reference globalization/compliance.py:20-568 (GDPR/CCPA/PDPA
regimes, data-record registry, consent tracking, anonymization, retention
cleanup, export/delete user data) — the serving-relevant subset, honest:
what a serving stack actually registers are request/prompt records.

The port's copy of ``photonic_flash_attention_tpu/globalization/compliance.py``, which imports no
JAX: the port may not import the JAX package, so it keeps its own.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import threading
import time
from typing import Dict, List, Optional


class Regime(str, enum.Enum):
    GDPR = "gdpr"
    CCPA = "ccpa"
    PDPA = "pdpa"


#: retention ceilings per regime (days)
RETENTION_DAYS = {Regime.GDPR: 30, Regime.CCPA: 365, Regime.PDPA: 90}


@dataclasses.dataclass
class DataRecord:
    record_id: str
    user_id: str
    category: str  # "prompt" | "generation" | "telemetry"
    created_at: float
    payload_digest: str
    anonymized: bool = False


class ComplianceManager:
    """Registry + consent + retention (reference ComplianceManager)."""

    def __init__(self, regime: Regime = Regime.GDPR) -> None:
        self.regime = regime
        self._records: Dict[str, DataRecord] = {}
        self._consent: Dict[str, bool] = {}
        self._lock = threading.RLock()

    # -- consent ----------------------------------------------------------

    def set_consent(self, user_id: str, granted: bool) -> None:
        with self._lock:
            self._consent[user_id] = granted

    def has_consent(self, user_id: str) -> bool:
        return self._consent.get(user_id, False)

    # -- registry ---------------------------------------------------------

    def register(self, user_id: str, category: str, payload: bytes | str) -> str:
        if not self.has_consent(user_id):
            raise PermissionError(f"no consent on file for user {user_id}")
        data = payload.encode() if isinstance(payload, str) else payload
        digest = hashlib.sha256(data).hexdigest()[:16]
        rid = f"{user_id}:{digest}:{int(time.time() * 1e3)}"
        with self._lock:
            self._records[rid] = DataRecord(
                rid, user_id, category, time.time(), digest
            )
        return rid

    def anonymize_user(self, user_id: str) -> int:
        """Strip user linkage (reference anonymization)."""
        n = 0
        with self._lock:
            for rec in self._records.values():
                if rec.user_id == user_id:
                    rec.user_id = "anon-" + hashlib.sha256(
                        user_id.encode()
                    ).hexdigest()[:12]
                    rec.anonymized = True
                    n += 1
        return n

    def export_user_data(self, user_id: str) -> List[Dict]:
        """Data portability (reference export_user_data)."""
        with self._lock:
            return [
                dataclasses.asdict(r)
                for r in self._records.values()
                if r.user_id == user_id
            ]

    def delete_user_data(self, user_id: str) -> int:
        """Right to erasure (reference delete_user_data)."""
        with self._lock:
            doomed = [rid for rid, r in self._records.items() if r.user_id == user_id]
            for rid in doomed:
                del self._records[rid]
            return len(doomed)

    # -- retention ----------------------------------------------------------

    def retention_cleanup(self, now: Optional[float] = None) -> int:
        limit_s = RETENTION_DAYS[self.regime] * 86400
        now = now or time.time()
        with self._lock:
            doomed = [
                rid
                for rid, r in self._records.items()
                if now - r.created_at > limit_s
            ]
            for rid in doomed:
                del self._records[rid]
            return len(doomed)

    def report(self) -> Dict:
        with self._lock:
            return {
                "regime": self.regime.value,
                "records": len(self._records),
                "users_with_consent": sum(1 for v in self._consent.values() if v),
                "anonymized": sum(1 for r in self._records.values() if r.anonymized),
                "retention_days": RETENTION_DAYS[self.regime],
            }
