"""Port parity: ``globalization`` (i18n, compliance, regional deployment).

The port's modules are copies of JAX's (they import no JAX). Every case of
``tests/unit/test_globalization.py`` runs on both packages and its result
must be equal; besides, every catalog message in every locale is
translated alike, and the compliance records (ids, digests, regimes,
retention) and region choices are the same for the same calls.
"""

import time
import types

import pytest

import photonic_flash_attention_tpu.globalization as jax_glob
import photonic_flash_attention_tpu_torch.globalization as port_glob
from photonic_flash_attention_tpu.globalization import i18n as jax_i18n
from photonic_flash_attention_tpu_torch.globalization import i18n as port_i18n

PORT = types.SimpleNamespace(g=port_glob, i18n=port_i18n)
JAX = types.SimpleNamespace(g=jax_glob, i18n=jax_i18n)
LOCALES = ("en", "es", "fr", "de", "ja", "zh")


def _both(scenario):
    port, ref = scenario(PORT), scenario(JAX)
    assert port == ref
    return port


def test_exports_match_jax():
    assert port_glob.__all__ == jax_glob.__all__


@pytest.mark.parametrize("lang", LOCALES)
def test_every_message_translates_as_jax(lang):
    def run(m):
        i = m.g.I18n(lang)
        keys = sorted(m.i18n._CATALOG["en"])
        return {k: i.t(k, kernel="flash", reason="hbm", tokens_per_s=12.5) for k in keys}

    out = _both(run)
    assert "flash" in out["engine.kernel_selected"]


def _missing_key(m):
    return m.g.I18n("es").t("no.such.key")


def _bad_locale(m):
    i = m.g.I18n("en")
    try:
        i.set_language("tlh")
    except ValueError:
        return "rejected"
    return "accepted"


def _numbers(m):
    return [m.g.I18n.format_number(v, loc) for v in (1234.5, 0.125, 1e6) for loc in LOCALES]


def _bytes(m):
    return [m.g.I18n.format_bytes(n) for n in (512, 2048, 5 * 1024**2, 2 * 1024**3, 3 * 1024**4)]


def _translate(m):
    return ([m.g.I18n(lang).t("engine.fallback", kernel="fused") for lang in LOCALES]
            + [m.g.translate("engine.fallback", kernel="fused")])


I18N_CASES = {
    "missing_key_falls_back": (_missing_key, lambda o: o == "no.such.key"),
    "bad_locale_rejected": (_bad_locale, lambda o: o == "rejected"),
    "number_formatting": (_numbers, lambda o: "1,234.50" in o and "1.234,50" in o),
    "bytes_formatting": (_bytes, lambda o: o[0] == "512 B" and "2.0 GB" in o),
    "translate": (_translate, lambda o: all("fused" in t for t in o)),
}


@pytest.mark.parametrize("case", list(I18N_CASES))
def test_i18n_case_matches_jax(case):
    scenario, check = I18N_CASES[case]
    assert check(_both(scenario))


def _records(m):
    """Every compliance call, with the records' content (no timestamps)."""
    mgr = m.g.ComplianceManager(m.g.Regime.GDPR)
    out = []
    try:
        mgr.register("alice", "prompt", "hello")
    except PermissionError:
        out.append("consent required")
    for user in ("alice", "bob", "carol", "dave"):
        mgr.set_consent(user, True)
    ids = [mgr.register(u, cat, text) for u, cat, text in (
        ("alice", "prompt", "hello"), ("bob", "prompt", "a"), ("bob", "generation", "b"),
        ("carol", "prompt", "x"), ("dave", "telemetry", "y"))]
    out.append(len(set(ids)))
    out.append(sorted((r["user_id"], r["category"], r["payload_digest"], r["anonymized"])
                      for r in mgr.export_user_data("bob")))
    out.append(mgr.delete_user_data("bob"))
    out.append(mgr.export_user_data("bob"))
    out.append(mgr.anonymize_user("carol"))
    out.append(mgr.export_user_data("carol"))
    out.append(mgr.retention_cleanup(now=time.time() + 31 * 86400))
    report = mgr.report()
    out.append({k: v for k, v in report.items() if not isinstance(v, float)})
    return out


def test_compliance_records_match_jax():
    out = _both(_records)
    assert out[0] == "consent required" and out[1] == 5
    assert out[3] == 2 and out[4] == [] and out[5] == 1 and out[6] == []


@pytest.mark.parametrize("regime", ["GDPR", "CCPA", "PDPA"])
def test_retention_by_regime_matches_jax(regime):
    def run(m):
        mgr = m.g.ComplianceManager(m.g.Regime[regime])
        mgr.set_consent("u", True)
        mgr.register("u", "prompt", "x")
        return [mgr.retention_cleanup(now=time.time() + d * 86400) for d in (29, 91, 366)]

    assert sum(_both(run)) == 1


def _geo(m):
    rm = m.g.RegionManager()
    return [rm.optimal_region(user_geo=g) for g in ("us", "eu", "apac", None)]


def _regime(m):
    rm = m.g.RegionManager()
    return [rm.optimal_region(user_geo=g, required_regime=r)
            for g in ("us", "eu", "apac") for r in m.g.Regime]


def _generation(m):
    rm = m.g.RegionManager()
    return [rm.optimal_region(user_geo=g, preferred_generation=gen)
            for g in ("us", "eu") for gen in ("v5e", "v5p", "v6e")]


def _failover(m):
    rm = m.g.RegionManager()
    rm.deploy("us-central1")
    alt = rm.mark_unhealthy("us-central1")
    return alt, rm.status()["deployments"]["us-central1"]["healthy"]


REGION_CASES = {
    "optimal_region_by_geo": (_geo, lambda o: o[1] == "europe-west4" and o[2] == "asia-northeast1"),
    "regime_constraint": (_regime, lambda o: o[0 * 3 + 0] == "europe-west4"),
    "preferred_generation": (_generation, lambda o: len(o) == 6),
    "failover": (_failover, lambda o: o[0] not in (None, "us-central1") and o[1] is False),
}


@pytest.mark.parametrize("case", list(REGION_CASES))
def test_region_case_matches_jax(case):
    scenario, check = REGION_CASES[case]
    assert check(_both(scenario))


def test_unknown_region_rejected():
    for m in (PORT, JAX):
        with pytest.raises(ValueError):
            m.g.RegionManager().deploy("mars-north1")
