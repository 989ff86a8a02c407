"""Model lifecycle: lazy load, switch, capability listing (port of
``zonos_tpu/serving/model_manager.py``).

One process-wide current model, reloaded when another name is asked for.
Models load onto the card; ``ZONOS_PLATFORM=cpu`` asks for the CPU (the
tests do), and without it a missing card raises. The resolution order is
JAX's: the local checkpoint named in ``configmodel.txt``, then the local hub
cache, then (with a warning) a seeded random model at the preset's size;
``ZONOS_TINY_MODEL`` gives a tiny random model instead. With
``ZONOS_QUANTIZE`` (the default) the model is quantized to int8, so decode
runs through K1-K3, and a failure of ``quantize()`` is raised: the port
never serves around its kernels.
"""

from __future__ import annotations

import logging
import os
import threading

import torch

from zonos_tpu_torch import resolve_device
from zonos_tpu_torch.serving import constants as C

logger = logging.getLogger("zonos_tpu_torch")

_LOCK = threading.Lock()
_CURRENT_NAME: str | None = None
_CURRENT_MODEL = None


def serving_device() -> torch.device:
    """The card, or the CPU when ``ZONOS_PLATFORM=cpu`` asks for it; raises
    when there is no card and the CPU was not asked for."""
    platform = os.environ.get("ZONOS_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda", "gpu"):
        raise ValueError(f"ZONOS_PLATFORM={platform!r}: the port runs on 'cuda' (default) or 'cpu'")
    return resolve_device(None)


def load_model_if_needed(model_name: str = C.MODEL_TRANSFORMER, config: dict | None = None, device=None):
    """Return the current model, (re)loading when the requested name changes.
    A model is loaded onto ``device``, by default ``serving_device()``'s."""
    global _CURRENT_NAME, _CURRENT_MODEL
    with _LOCK:
        if _CURRENT_MODEL is not None and _CURRENT_NAME == model_name:
            return _CURRENT_MODEL

        from zonos_tpu_torch.models.zonos import Zonos

        device = serving_device() if device is None else resolve_device(device)
        config = config or {}
        hybrid = "hybrid" in model_name
        local_path = str(config.get("PATH_MODEL_HYBRID" if hybrid else "PATH_MODEL_TRANSFORMER", "") or "")
        model = None
        if local_path:
            cfg_path = os.path.join(local_path, "config.json")
            st_path = os.path.join(local_path, "model.safetensors")
            if os.path.exists(cfg_path) and os.path.exists(st_path):
                logger.info(f"loading {model_name} from {local_path}")
                model = Zonos.from_local(cfg_path, st_path, device=device)
        if model is None:
            if os.environ.get("ZONOS_TINY_MODEL"):
                from zonos_tpu_torch.config import tiny_hybrid_config, tiny_transformer_config

                logger.warning("ZONOS_TINY_MODEL set: using tiny random-init model")
                preset = tiny_hybrid_config() if hybrid else tiny_transformer_config()
                model = Zonos.from_config(preset, dtype=torch.float32, device=device)
            else:
                try:
                    logger.info(f"loading {model_name} from the local hub cache")
                    model = Zonos.from_pretrained(model_name, device=device)
                except FileNotFoundError as e:
                    logger.warning(f"pretrained load failed ({e}); using random-init preset")
                    from zonos_tpu_torch.config import zonos_v01_hybrid_config, zonos_v01_transformer_config

                    preset = zonos_v01_hybrid_config() if hybrid else zonos_v01_transformer_config()
                    model = Zonos.from_config(preset, device=device)

        if _as_bool(config.get("ZONOS_QUANTIZE", True)):
            model = model.quantize()  # a failure propagates: no serving around K1-K3
            logger.info("serving with the int8-quantized decode path (K1-K3)")

        _CURRENT_MODEL, _CURRENT_NAME = model, model_name
        return model


def _as_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def current_model_name() -> str | None:
    return _CURRENT_NAME


def get_supported_models() -> list[str]:
    """Both backbones are always available."""
    return list(C.SUPPORTED_MODELS)
