"""Security: input sanitization, rate limiting, audit logging.

The rebirth of the reference's security stack (reference
utils/security.py:22-633, utils/simple_security.py:56-622,
security/advanced_validation.py:68-793), trimmed to the mechanisms that
protect a real TPU serving path:

* tensor/input sanitization — size caps, dtype allow-list, NaN/Inf
  screening (the reference's "optical safety limits" become resource
  safety limits: a hostile request can't OOM the chip or poison caches),
* string/dict request validation with injection screening,
* sliding-window rate limiting with client blocking
  (advanced_validation.py's limiter),
* an audit logger with risk scoring.

Port of ``photonic_flash_attention_tpu/utils/security.py``. The string,
dict, PII, rate-limit, audit and config-integrity parts are copies. Two
parts take tensors: ``InputSanitizer.sanitize_tensor`` sizes a
``torch.Tensor`` by its element size and screens it for NaN/Inf on its own
device, reading one bool on the host; ``sanitize_state_dict`` walks a
``state_dict`` (or an ``nn.Module``'s, or any nest of dicts, lists and
tuples) where JAX flattens a pytree, and names a bad leaf by its dotted
key (``h.0.attn.c_attn.weight``; a list index is a key), where JAX renders
``['h']['0']...``. Dtype names are JAX's (``"bfloat16"``, ``"float32"``).
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from collections import defaultdict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .exceptions import SecurityError
from .logging import get_logger

logger = get_logger("security")

_SUSPICIOUS_PATTERNS = (
    re.compile(r"<\s*script", re.I),
    re.compile(r"[;&|`$]\s*\w+"),  # shell metacharacters + command
    re.compile(r"\.\./"),  # path traversal
    re.compile(r"__\w+__"),  # python dunder smuggling
)

_ALLOWED_DTYPES = ("float32", "bfloat16", "float16", "int32", "int8", "bool")


def _dtype_name(dtype: Any) -> str:
    """JAX's name of a dtype: ``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class SecurityPolicy:
    """Caps (reference SecurityPolicy advanced_validation.py:68)."""

    max_tensor_bytes: int = 8 * 1024 * 1024 * 1024  # 8 GB
    max_string_len: int = 64 * 1024
    max_dict_depth: int = 8
    max_requests_per_window: int = 600
    window_s: float = 60.0
    block_duration_s: float = 300.0
    reject_nonfinite: bool = True


class InputSanitizer:
    """Tensor/string/dict validation (reference InputValidator)."""

    def __init__(self, policy: Optional[SecurityPolicy] = None) -> None:
        self.policy = policy or SecurityPolicy()

    def sanitize_tensor(self, x: Any, name: str = "tensor") -> Any:
        """``x`` unchanged if it is a tensor (or array) under the size cap,
        of an allowed dtype and, for float dtypes, finite; else
        ``SecurityError``. A tensor's finiteness is reduced on its device."""
        if not hasattr(x, "shape") or not hasattr(x, "dtype"):
            raise SecurityError(f"{name} is not an array")
        dtype = _dtype_name(x.dtype)
        itemsize = x.element_size() if isinstance(x, torch.Tensor) else np.dtype(dtype).itemsize
        nbytes = int(np.prod(tuple(x.shape))) * itemsize
        if nbytes > self.policy.max_tensor_bytes:
            raise SecurityError(
                f"{name} exceeds size cap", bytes=nbytes,
                cap=self.policy.max_tensor_bytes,
            )
        if dtype not in _ALLOWED_DTYPES:
            raise SecurityError(f"{name} dtype {dtype} not allowed")
        if self.policy.reject_nonfinite and dtype.startswith(("float", "bfloat")):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            if not bool(torch.isfinite(t).all()):
                raise SecurityError(f"{name} contains NaN/Inf")
        return x

    def sanitize_string(self, s: str, name: str = "string") -> str:
        if len(s) > self.policy.max_string_len:
            raise SecurityError(f"{name} exceeds length cap", length=len(s))
        for pat in _SUSPICIOUS_PATTERNS:
            if pat.search(s):
                raise SecurityError(
                    f"{name} matched suspicious pattern", pattern=pat.pattern
                )
        return s

    def sanitize_dict(self, d: Dict, name: str = "payload", _depth: int = 0) -> Dict:
        if _depth > self.policy.max_dict_depth:
            raise SecurityError(f"{name} nesting too deep")
        for k, v in d.items():
            if isinstance(k, str):
                self.sanitize_string(k, f"{name}.key")
            if isinstance(v, str):
                self.sanitize_string(v, f"{name}.{k}")
            elif isinstance(v, dict):
                self.sanitize_dict(v, f"{name}.{k}", _depth + 1)
        return d


class RateLimiter:
    """Sliding window + client blocking (advanced_validation.py limiter)."""

    def __init__(self, policy: Optional[SecurityPolicy] = None) -> None:
        self.policy = policy or SecurityPolicy()
        self._events: Dict[str, Deque[float]] = defaultdict(deque)
        self._blocked: Dict[str, float] = {}
        self._lock = threading.RLock()

    def check(self, client_id: str) -> None:
        """Record one request; raise SecurityError when over budget."""
        now = time.time()
        with self._lock:
            until = self._blocked.get(client_id)
            if until is not None:
                if now < until:
                    raise SecurityError(
                        "client blocked", client=client_id,
                        retry_after_s=round(until - now, 1),
                    )
                del self._blocked[client_id]
            q = self._events[client_id]
            cutoff = now - self.policy.window_s
            while q and q[0] < cutoff:
                q.popleft()
            if len(q) >= self.policy.max_requests_per_window:
                self._blocked[client_id] = now + self.policy.block_duration_s
                logger.warning("rate limit: blocking client %s", client_id)
                raise SecurityError("rate limit exceeded", client=client_id)
            q.append(now)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "clients": len(self._events),
                "blocked": len(self._blocked),
            }


class AuditLogger:
    """Risk-scored audit events (reference auditor :advanced_validation)."""

    RISK = {"rejected_input": 3, "rate_limited": 2, "blocked": 5, "ok": 0}

    def __init__(self, capacity: int = 2048) -> None:
        self._events: Deque[Dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, event: str, client: str = "-", **detail: Any) -> None:
        with self._lock:
            self._events.append(
                {
                    "time": time.time(),
                    "event": event,
                    "client": client,
                    "risk": self.RISK.get(event, 1),
                    **detail,
                }
            )

    def risk_score(self, client: str, window_s: float = 300.0) -> int:
        cutoff = time.time() - window_s
        with self._lock:
            return sum(
                e["risk"]
                for e in self._events
                if e["client"] == client and e["time"] >= cutoff
            )

    def recent(self, n: int = 20) -> List[Dict]:
        with self._lock:
            return list(self._events)[-n:]


class SecurityManager:
    """Request gate (reference SecurityManager.validate_request :588)."""

    def __init__(self, policy: Optional[SecurityPolicy] = None) -> None:
        self.policy = policy or SecurityPolicy()
        self.sanitizer = InputSanitizer(self.policy)
        self.limiter = RateLimiter(self.policy)
        self.audit = AuditLogger()
        self._lockdown = False

    def validate_request(
        self,
        client_id: str,
        tensors: Tuple = (),
        payload: Optional[Dict] = None,
    ) -> None:
        if self._lockdown:
            raise SecurityError("emergency lockdown active")
        try:
            self.limiter.check(client_id)
        except SecurityError:
            self.audit.record("rate_limited", client_id)
            raise
        try:
            for i, t in enumerate(tensors):
                self.sanitizer.sanitize_tensor(t, f"tensor[{i}]")
            if payload:
                self.sanitizer.sanitize_dict(payload)
        except SecurityError as e:
            self.audit.record("rejected_input", client_id, reason=str(e)[:120])
            raise
        self.audit.record("ok", client_id)

    def emergency_lockdown(self, on: bool = True) -> None:
        self._lockdown = on
        logger.critical("emergency lockdown %s", "ENGAGED" if on else "lifted")

    def stats(self) -> Dict:
        return {
            "lockdown": self._lockdown,
            "rate_limiter": self.limiter.stats(),
            "recent_audit": self.audit.recent(5),
        }


# ---------------------------------------------------------------------------
# PII scan/redaction, state-dict sanitization, config integrity
# (reference utils/security.py:22-633's remaining surfaces)
# ---------------------------------------------------------------------------

_PII_PATTERNS = {
    "email": r"[\w.+-]+@[\w-]+\.[\w.-]+",
    "phone": r"(?<!\d)(?:\+?\d{1,3}[ .-]?)?(?:\(\d{2,4}\)[ .-]?)?\d{3,4}[ .-]?\d{4}(?!\d)",
    "ssn": r"(?<!\d)\d{3}-\d{2}-\d{4}(?!\d)",
    "credit_card": r"(?<!\d)(?:\d[ -]?){13,16}(?!\d)",
    "ip_address": r"(?<!\d)(?:\d{1,3}\.){3}\d{1,3}(?!\d)",
}


def scan_pii(text: str) -> Dict[str, List[str]]:
    """Find PII-looking spans by category (reference PII scan)."""
    import re

    found: Dict[str, List[str]] = {}
    for kind, pattern in _PII_PATTERNS.items():
        hits = re.findall(pattern, text)
        if hits:
            found[kind] = hits
    return found


def redact_pii(text: str, replacement: str = "[REDACTED-{kind}]") -> str:
    """Replace PII-looking spans with typed placeholders."""
    import re

    for kind, pattern in _PII_PATTERNS.items():
        text = re.sub(pattern, replacement.format(kind=kind.upper()), text)
    return text


def _leaves(tree: Any, prefix: str = ""):
    """(dotted key, leaf) of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


def sanitize_state_dict(params: Any) -> Any:
    """Validate parameters before loading (reference model state-dict
    sanitizer): every leaf of a ``state_dict`` (an ``nn.Module``'s is read
    from the module, buffers included) must be numeric, and a float leaf
    finite — NaN/Inf smuggled into checkpoints is the classic poisoning
    vector. A tensor is screened on its device, one bool read a leaf.
    Returns ``params`` unchanged; raises SecurityError naming the leaf's
    dotted key otherwise.
    """
    tree = params.state_dict() if isinstance(params, torch.nn.Module) else params
    for path, leaf in _leaves(tree):
        if leaf is None:  # no leaf, as in a JAX pytree
            continue
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                raise SecurityError(f"non-finite values in parameter at {path}")
            continue
        arr = np.asarray(leaf)
        if arr.dtype == object:
            raise SecurityError(f"non-numeric leaf at {path}")
        if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
            raise SecurityError(f"non-finite values in parameter at {path}")
    return params


class ConfigIntegrity:
    """Tamper detection for config dicts (reference config integrity
    hashing): seal a config snapshot, verify it later."""

    def __init__(self) -> None:
        self._seals: Dict[str, str] = {}

    @staticmethod
    def _digest(config: Dict) -> str:
        import hashlib
        import json

        blob = json.dumps(config, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()

    def seal(self, name: str, config: Dict) -> str:
        d = self._digest(config)
        self._seals[name] = d
        return d

    def verify(self, name: str, config: Dict) -> bool:
        expected = self._seals.get(name)
        if expected is None:
            raise SecurityError(f"no seal recorded for {name!r}")
        return self._digest(config) == expected

    def assert_unchanged(self, name: str, config: Dict) -> None:
        if not self.verify(name, config):
            raise SecurityError(f"config {name!r} modified since sealing")
