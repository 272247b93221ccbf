"""Port parity: ``utils/security.py``.

Every case of ``tests/unit/test_security.py`` runs on both packages with
the same numpy-seeded inputs (a torch tensor on the port's side, a JAX
array on JAX's): each accepts and rejects alike, and the audit trail, PII
scan and redaction, and config seals are equal. ``sanitize_state_dict``
walks a state_dict or an ``nn.Module`` and names a bad leaf by its dotted
key where JAX renders the pytree path.
"""

import re
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import photonic_flash_attention_tpu.utils.exceptions as jax_exc
import photonic_flash_attention_tpu.utils.security as jax_sec
import photonic_flash_attention_tpu_torch.utils.exceptions as port_exc
import photonic_flash_attention_tpu_torch.utils.security as port_sec

PORT = types.SimpleNamespace(s=port_sec, SecurityError=port_exc.SecurityError,
                             arr=lambda a: torch.from_numpy(np.ascontiguousarray(a)))
JAX = types.SimpleNamespace(s=jax_sec, SecurityError=jax_exc.SecurityError, arr=jnp.asarray)


def _verdict(m, fn):
    """"ok" or the SecurityError's message."""
    try:
        fn()
    except m.SecurityError as e:
        return f"rejected: {e}"
    return "ok"


def _tensor_cases(rng):
    x = rng.standard_normal((8, 8)).astype(np.float32)
    nan = np.array([np.nan, 1.0], np.float32)
    inf = np.array([1.0, -np.inf], np.float32)
    return {
        "valid_float32": (x, {}),
        "valid_bfloat16": (x.astype(ml_dtypes.bfloat16), {}),
        "valid_int32": (np.arange(12, dtype=np.int32), {}),
        "valid_bool": (x > 0, {}),
        "oversized": (np.zeros((64, 64), np.float32), dict(max_tensor_bytes=64)),
        "nan": (nan, {}),
        "inf": (inf, {}),
        "nan_allowed_when_not_rejecting": (nan, dict(reject_nonfinite=False)),
        "nan_bfloat16": (nan.astype(ml_dtypes.bfloat16), {}),
        "int8_allowed": (np.arange(3, dtype=np.int8), {}),
    }


@pytest.mark.parametrize("case", list(_tensor_cases(np.random.default_rng(0))))
def test_sanitize_tensor_as_jax(rng, case):
    arr, policy = _tensor_cases(rng)[case]
    verdicts = []
    for m in (PORT, JAX):
        if m is PORT and arr.dtype == ml_dtypes.bfloat16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = m.arr(arr)
        s = m.s.InputSanitizer(m.s.SecurityPolicy(**policy))
        verdicts.append(_verdict(m, lambda: s.sanitize_tensor(t)))
        if verdicts[-1] == "ok":
            assert s.sanitize_tensor(t) is t
    assert verdicts[0] == verdicts[1]
    assert (verdicts[0] == "ok") == (case.startswith("valid") or case.endswith(("not_rejecting", "_allowed")))


def test_non_array_rejected():
    for m in (PORT, JAX):
        with pytest.raises(m.SecurityError):
            m.s.InputSanitizer().sanitize_tensor("not a tensor")


STRINGS = ["<script>alert(1)</script>", "x; rm -rf /", "../../etc/passwd", "__import__",
           "hello world-42", "a" * (64 * 1024 + 1), "plain text, with commas."]


@pytest.mark.parametrize("text", STRINGS, ids=range(len(STRINGS)))
def test_sanitize_string_as_jax(text):
    v = [_verdict(m, lambda m=m: m.s.InputSanitizer().sanitize_string(text)) for m in (PORT, JAX)]
    assert v[0] == v[1]


@pytest.mark.parametrize("depth", [3, 8, 9, 12])
def test_sanitize_dict_depth_as_jax(depth):
    d = cur = {}
    for _ in range(depth):
        cur["x"] = {}
        cur = cur["x"]
    v = [_verdict(m, lambda m=m: m.s.InputSanitizer().sanitize_dict(d)) for m in (PORT, JAX)]
    assert v[0] == v[1] and (v[0] == "ok") == (depth <= 8)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64, torch.uint8])
def test_dtypes_outside_the_allow_list_rejected(dtype):
    """JAX (x64 off) never holds these; the port names them as JAX would."""
    with pytest.raises(port_exc.SecurityError, match=str(dtype).removeprefix("torch.")):
        port_sec.InputSanitizer().sanitize_tensor(torch.zeros(3, dtype=dtype))


def _rate_limits(m):
    rl = m.s.RateLimiter(m.s.SecurityPolicy(max_requests_per_window=3, window_s=60))
    out = [_verdict(m, lambda: rl.check("c1")) for _ in range(5)]
    out.append(_verdict(m, lambda: rl.check("c2")))
    return [re.sub(r"retry_after_s=[\d.]+", "", o) for o in out] + [rl.stats()]


def test_rate_limiter_as_jax():
    out = _rate_limits(PORT)
    assert out == _rate_limits(JAX)
    assert out[:3] == ["ok"] * 3 and out[3] != "ok" and out[4] != "ok" and out[5] == "ok"


def test_window_slides():
    import time

    for m in (PORT, JAX):
        rl = m.s.RateLimiter(m.s.SecurityPolicy(max_requests_per_window=2, window_s=0.05))
        rl.check("c")
        rl.check("c")
        time.sleep(0.06)
        rl.check("c")  # window expired, allowed again


def _manager(m, rng):
    mgr = m.s.SecurityManager()
    x = m.arr(rng.standard_normal((4, 4)).astype(np.float32))
    out = [_verdict(m, lambda: mgr.validate_request("client", tensors=(x,),
                                                    payload={"model": "gpt2"}))]
    out.append(_verdict(m, lambda: mgr.validate_request("evil", payload={"cmd": "x; rm -rf /"})))
    bad = m.arr(np.array([np.nan], np.float32))
    out.append(_verdict(m, lambda: mgr.validate_request("evil", tensors=(bad,))))
    mgr.emergency_lockdown()
    out.append(_verdict(m, lambda: mgr.validate_request("anyone")))
    mgr.emergency_lockdown(False)
    out.append(_verdict(m, lambda: mgr.validate_request("anyone")))
    out.append([(e["event"], e["client"], e["risk"]) for e in mgr.audit.recent(10)])
    out.append(mgr.audit.risk_score("evil"))
    return out


def test_security_manager_as_jax():
    port = _manager(PORT, np.random.default_rng(1))
    assert port == _manager(JAX, np.random.default_rng(1))
    assert port[0] == "ok" and port[1] != "ok" and port[3] != "ok" and port[4] == "ok"
    assert port[-1] >= 3


PII_TEXTS = [
    "mail me at alice@example.com from 10.0.0.1, ssn 123-45-6789",
    "contact bob@corp.io now",
    "call +1 415-555-0100 or (020) 7946 0958",
    "card 4111 1111 1111 1111 expires soon",
    "flash attention block sizes are tuned per chip",
]


@pytest.mark.parametrize("text", PII_TEXTS, ids=range(len(PII_TEXTS)))
def test_pii_scan_and_redact_as_jax(text):
    assert port_sec.scan_pii(text) == jax_sec.scan_pii(text)
    assert port_sec.redact_pii(text) == jax_sec.redact_pii(text)
    if "@" in text:
        assert "[REDACTED-EMAIL]" in port_sec.redact_pii(text)


def test_pii_categories():
    found = port_sec.scan_pii(PII_TEXTS[0])
    assert {"email", "ip_address", "ssn"} <= set(found)
    assert port_sec.scan_pii(PII_TEXTS[-1]) == {}


def test_sanitize_state_dict_passes_finite_trees():
    tree = {"a": {"w": torch.ones(2, 2)}, "b": torch.zeros(3), "c": [torch.ones(1), None]}
    assert port_sec.sanitize_state_dict(tree) is tree
    module = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.LayerNorm(4))
    assert port_sec.sanitize_state_dict(module) is module
    jtree = {"a": {"w": jnp.ones((2, 2))}, "b": jnp.zeros(3)}
    assert jax_sec.sanitize_state_dict(jtree) is jtree


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_sanitize_state_dict_names_the_leaf(bad):
    """The same poisoned leaf is caught by both, named by its dotted key on
    the port and by its pytree path on JAX."""
    tree = {"h": {"0": {"w": np.array([1.0, bad], np.float32)}}, "b": np.zeros(2, np.float32)}
    port_tree = {"h": {"0": {"w": torch.from_numpy(tree["h"]["0"]["w"])}},
                 "b": torch.zeros(2)}
    with pytest.raises(port_exc.SecurityError, match=r"at h\.0\.w$"):
        port_sec.sanitize_state_dict(port_tree)
    with pytest.raises(jax_exc.SecurityError, match=r"\['h'\]\['0'\]\['w'\]"):
        jax_sec.sanitize_state_dict(tree)
    module = torch.nn.Linear(2, 2)
    with torch.no_grad():
        module.bias[1] = bad
    with pytest.raises(port_exc.SecurityError, match=r"at bias$"):
        port_sec.sanitize_state_dict(module)


def test_sanitize_state_dict_rejects_non_numeric():
    for m in (port_sec, jax_sec):
        with pytest.raises((port_exc.SecurityError, jax_exc.SecurityError)):
            m.sanitize_state_dict({"w": np.array([object()], dtype=object)})


def _seals(m):
    ci = m.s.ConfigIntegrity()
    cfg = {"flash_threshold": 512, "quant_mode": "fp8"}
    digest = ci.seal("engine", cfg)
    out = [digest, ci.verify("engine", cfg)]
    cfg["flash_threshold"] = 1
    out.append(ci.verify("engine", cfg))
    out.append(_verdict(m, lambda: ci.assert_unchanged("engine", cfg)))
    out.append(_verdict(m, lambda: ci.assert_unchanged("unknown", {})))
    return out


def test_config_integrity_as_jax():
    out = _seals(PORT)
    assert out == _seals(JAX)
    assert out[1] is True and out[2] is False and out[3] != "ok" and out[4] != "ok"
