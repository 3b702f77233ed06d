"""Config discovery and bootstrap checks.

A copy of ``sutro_tpu/validation.py`` (its version lookup over
``urllib``, not ``requests``). The engine is local-first: an
API key is optional (only needed when a client points at a remote
``base_url``), so discovery never errors — it returns ``None`` and the
SDK runs against the in-process engine. The PyPI version check is kept
but disabled by default; set ``SUTRO_CHECK_VERSION=1`` to enable it.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

from .engine.config import sutro_home


def config_dir() -> Path:
    d = sutro_home()
    d.mkdir(parents=True, exist_ok=True)
    return d


def load_config() -> Dict[str, Any]:
    """Load ``$SUTRO_HOME/config.json``, tolerating absence and
    corruption. Reading creates nothing (importing the package reads
    it: the import must leave no state directory behind)."""
    path = sutro_home() / "config.json"
    if not path.exists():
        return {}
    try:
        return json.loads(path.read_text())
    except Exception:
        return {}


def save_config(cfg: Dict[str, Any]) -> None:
    path = config_dir() / "config.json"
    path.write_text(json.dumps(cfg, indent=2))


def check_for_api_key() -> Optional[str]:
    """API-key discovery: env ``SUTRO_API_KEY`` first, then the config
    file. Returns None when absent — the local backend needs no key."""
    key = os.environ.get("SUTRO_API_KEY")
    if key:
        return key
    return load_config().get("api_key")


def check_version(timeout: float = 2.0) -> Optional[str]:
    """Best-effort PyPI latest-version lookup; fail-silent. No-op unless
    SUTRO_CHECK_VERSION=1 (zero-egress environments)."""
    if os.environ.get("SUTRO_CHECK_VERSION") != "1":
        return None
    try:  # pragma: no cover - requires network
        import urllib.request

        with urllib.request.urlopen(
            "https://pypi.org/pypi/sutro/json", timeout=timeout
        ) as resp:
            return json.loads(resp.read())["info"]["version"]
    except Exception:
        return None
