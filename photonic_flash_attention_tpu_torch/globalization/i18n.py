"""Internationalization: message catalog, locale detection, formatting.

Rebirth of reference globalization/i18n.py:16-366 (6-language JSON
catalog, locale detect, number/bytes formatting) — same surface,
engine-relevant message set.

The port's copy of ``photonic_flash_attention_tpu/globalization/i18n.py``, which imports no
JAX: the port may not import the JAX package, so it keeps its own.
"""

from __future__ import annotations

import locale
import os
import threading
from typing import Dict, Optional

_CATALOG: Dict[str, Dict[str, str]] = {
    "en": {
        "engine.ready": "attention engine ready",
        "engine.kernel_selected": "kernel selected: {kernel}",
        "engine.fallback": "kernel failed; falling back to {kernel}",
        "cache.oom": "KV cache out of pages",
        "health.degraded": "system degraded: {reason}",
        "bench.complete": "benchmark complete: {tokens_per_s} tokens/s",
    },
    "es": {
        "engine.ready": "motor de atención listo",
        "engine.kernel_selected": "kernel seleccionado: {kernel}",
        "engine.fallback": "kernel falló; usando {kernel}",
        "cache.oom": "caché KV sin páginas",
        "health.degraded": "sistema degradado: {reason}",
        "bench.complete": "benchmark completado: {tokens_per_s} tokens/s",
    },
    "fr": {
        "engine.ready": "moteur d'attention prêt",
        "engine.kernel_selected": "noyau sélectionné : {kernel}",
        "engine.fallback": "échec du noyau ; bascule vers {kernel}",
        "cache.oom": "cache KV saturé",
        "health.degraded": "système dégradé : {reason}",
        "bench.complete": "benchmark terminé : {tokens_per_s} tokens/s",
    },
    "de": {
        "engine.ready": "Attention-Engine bereit",
        "engine.kernel_selected": "Kernel ausgewählt: {kernel}",
        "engine.fallback": "Kernel fehlgeschlagen; Fallback auf {kernel}",
        "cache.oom": "KV-Cache ohne freie Seiten",
        "health.degraded": "System beeinträchtigt: {reason}",
        "bench.complete": "Benchmark abgeschlossen: {tokens_per_s} Tokens/s",
    },
    "ja": {
        "engine.ready": "アテンションエンジン準備完了",
        "engine.kernel_selected": "カーネル選択: {kernel}",
        "engine.fallback": "カーネル失敗、{kernel} にフォールバック",
        "cache.oom": "KVキャッシュのページ不足",
        "health.degraded": "システム劣化: {reason}",
        "bench.complete": "ベンチマーク完了: {tokens_per_s} トークン/秒",
    },
    "zh": {
        "engine.ready": "注意力引擎就绪",
        "engine.kernel_selected": "已选择内核: {kernel}",
        "engine.fallback": "内核失败，回退到 {kernel}",
        "cache.oom": "KV 缓存页面耗尽",
        "health.degraded": "系统降级: {reason}",
        "bench.complete": "基准测试完成: {tokens_per_s} tokens/s",
    },
}

SUPPORTED_LOCALES = tuple(_CATALOG)


def detect_locale() -> str:
    """Env/system locale -> supported language code (reference :120-160)."""
    for var in ("PFA_LOCALE", "LC_ALL", "LANG"):
        raw = os.environ.get(var)
        if raw:
            code = raw.split("_")[0].split(".")[0].lower()
            if code in _CATALOG:
                return code
    try:
        loc = locale.getlocale()[0]
        if loc:
            code = loc.split("_")[0].lower()
            if code in _CATALOG:
                return code
    except (ValueError, locale.Error):
        pass
    return "en"


class I18n:
    """Translator singleton surface (reference PhotonicI18n)."""

    def __init__(self, language: Optional[str] = None) -> None:
        self.language = language or detect_locale()

    def set_language(self, language: str) -> None:
        if language not in _CATALOG:
            raise ValueError(f"unsupported locale {language!r}")
        self.language = language

    def t(self, key: str, **fields) -> str:
        msg = _CATALOG.get(self.language, {}).get(key) or _CATALOG["en"].get(key, key)
        try:
            return msg.format(**fields)
        except (KeyError, IndexError):
            return msg

    @staticmethod
    def format_number(value: float, language: str = "en") -> str:
        s = f"{value:,.2f}"
        if language in ("de", "es", "fr"):
            s = s.replace(",", " ").replace(".", ",").replace(" ", ".")
        return s

    @staticmethod
    def format_bytes(n: int) -> str:
        for unit in ("B", "KB", "MB", "GB", "TB"):
            if abs(n) < 1024:
                return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
            n /= 1024
        return f"{n:.1f} PB"


_i18n: Optional[I18n] = None
_lock = threading.Lock()


def get_i18n() -> I18n:
    global _i18n
    if _i18n is None:
        with _lock:
            if _i18n is None:
                _i18n = I18n()
    return _i18n


def translate(key: str, **fields) -> str:
    return get_i18n().t(key, **fields)
