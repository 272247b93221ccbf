"""Globalization: i18n, compliance bookkeeping, multi-region deployment."""

from .compliance import ComplianceManager, DataRecord, Regime
from .deployment import REGION_CATALOG, Region, RegionManager
from .i18n import I18n, detect_locale, get_i18n, translate

__all__ = [
    "ComplianceManager",
    "DataRecord",
    "I18n",
    "REGION_CATALOG",
    "Region",
    "RegionManager",
    "Regime",
    "detect_locale",
    "get_i18n",
    "translate",
]
