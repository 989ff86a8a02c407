"""App configuration: flat KEY = value config file + logging setup (port of
``zonos_tpu/serving/app_config.py``).

``configmodel.txt`` is a flat file with typed parsing; missing default keys
are appended to it. Logging goes to the console and, when asked, to a
rotating file. The port logs under ``zonos_tpu_torch``.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Any

DEFAULT_CONFIG: dict[str, Any] = {
    "PATH_MODEL_TRANSFORMER": "",
    "PATH_MODEL_HYBRID": "",
    "PATH_NEEDED_HFHOME": "",
    "ZONOS_COMPILE": True,
    "ZONOS_QUANTIZE": True,
    "ZONOS_BATCHING": False,
    "ZONOS_DEBUG": False,
    "ZONOS_LOG_TO_FILE": False,
    "ZONOS_LOG_DIR": "logs",
}

_TRUE = {"1", "true", "yes", "on"}


def _parse(value: str, default: Any) -> Any:
    value = value.strip()
    if isinstance(default, bool):
        return value.lower() in _TRUE
    if isinstance(default, int):
        try:
            return int(value)
        except ValueError:
            return default
    if isinstance(default, float):
        try:
            return float(value)
        except ValueError:
            return default
    return value


def load_config(path: str = "configmodel.txt") -> dict[str, Any]:
    """Read KEY = value lines; append any missing default keys to the file."""
    cfg = dict(DEFAULT_CONFIG)
    existing: set[str] = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, val = line.partition("=")
                key = key.strip()
                existing.add(key)
                default = cfg.get(key, val.strip())
                cfg[key] = _parse(val, default)
    missing = [k for k in DEFAULT_CONFIG if k not in existing]
    if missing:
        try:
            with open(path, "a") as f:
                for k in missing:
                    f.write(f"{k} = {DEFAULT_CONFIG[k]}\n")
        except OSError:
            pass
    if cfg.get("PATH_NEEDED_HFHOME"):
        os.environ.setdefault("HF_HOME", str(cfg["PATH_NEEDED_HFHOME"]))
    return cfg


_LOGGING_DONE = False


def setup_logging(cfg: dict[str, Any] | None = None) -> logging.Logger:
    """Console + optional rotating file sink, configured once."""
    global _LOGGING_DONE
    logger = logging.getLogger("zonos_tpu_torch")
    if _LOGGING_DONE:
        return logger
    cfg = cfg or {}
    level = logging.DEBUG if cfg.get("ZONOS_DEBUG") else logging.INFO
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s | %(levelname)-7s | %(name)s - %(message)s")

    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)

    if cfg.get("ZONOS_LOG_TO_FILE"):
        log_dir = str(cfg.get("ZONOS_LOG_DIR", "logs"))
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, "zonos_tpu_torch.log"), maxBytes=10 * 2**20, backupCount=3
        )
        fh.setFormatter(fmt)
        logger.addHandler(fh)

    _LOGGING_DONE = True
    return logger
