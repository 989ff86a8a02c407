"""System report, device inventory and model check (port of ``zonos_tpu/utils/sysinfo.py``).

The server's ``--sysreport`` and ``--checkmodels``. Device information comes
from ``torch.cuda`` and ``nvidia-smi`` (name, memory, power limit), where
the JAX package asks ``jax.devices()``. The model check looks for a local
checkpoint and the local hub cache by path (``utils.hub``), where JAX's
asks ``huggingface_hub``.
"""

from __future__ import annotations

import os
import platform
import shutil
import subprocess
import sys


def get_memory_info() -> dict:
    try:
        import psutil
    except ImportError:  # the card's host may lack it: the page counts give the total
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        avail = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
        return {"total_gb": round(total / 2**30, 1), "available_gb": round(avail / 2**30, 1)}
    vm = psutil.virtual_memory()
    return {"total_gb": round(vm.total / 2**30, 1), "available_gb": round(vm.available / 2**30, 1)}


def get_disk_info(path: str = ".") -> dict:
    du = shutil.disk_usage(path)
    return {"total_gb": round(du.total / 2**30, 1), "free_gb": round(du.free / 2**30, 1)}


def nvidia_smi(query: str = "name,power.limit") -> list[str]:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` lines, or [] without it."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()] if out.returncode == 0 else []


def get_device_info() -> list[dict]:
    """The CUDA devices torch sees: name, memory, and nvidia-smi's power limit."""
    try:
        import torch

        if not torch.cuda.is_available():
            return [{"id": 0, "platform": "cpu", "kind": platform.processor() or platform.machine()}]
        smi = nvidia_smi("power.limit")
        out = []
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            info = {"id": i, "platform": "gpu", "kind": props.name, "hbm_gb": round(props.total_memory / 2**30, 1),
                    "sm_count": props.multi_processor_count, "capability": f"{props.major}.{props.minor}"}
            info["hbm_used_gb"] = round(torch.cuda.memory_allocated(i) / 2**30, 2)
            if i < len(smi):
                info["power_limit"] = smi[i]
            out.append(info)
        return out
    except Exception as e:
        return [{"error": str(e)}]


def check_models(config: dict | None = None) -> str:
    """Which supported models have a local checkpoint or a local hub-cache copy."""
    from zonos_tpu_torch.serving import constants as C
    from zonos_tpu_torch.utils.hub import cached_snapshot

    lines = ["Model availability check:"]
    config = config or {}
    for name in C.SUPPORTED_MODELS:
        key = "PATH_MODEL_TRANSFORMER" if "transformer" in name else "PATH_MODEL_HYBRID"
        local = str(config.get(key, "") or "")
        status = []
        if local and os.path.exists(os.path.join(local, "model.safetensors")):
            status.append(f"local: {local}")
        status.append("hf-cache: yes" if cached_snapshot(name, ("config.json",)) else "hf-cache: no")
        lines.append(f"  {name}: {', '.join(status) or 'NOT FOUND'}")
    return "\n".join(lines)


def generate_report(config: dict | None = None) -> str:
    """Anonymized troubleshooting report."""
    lines = [
        "=== Zonos PyTorch/CUDA system report ===",
        f"python: {sys.version.split()[0]}  platform: {platform.platform()}",
        f"memory: {get_memory_info()}",
        f"disk: {get_disk_info()}",
        f"devices: {get_device_info()}",
    ]
    try:
        import torch

        lines.append(f"torch: {torch.__version__}  cuda: {torch.version.cuda}  available: {torch.cuda.is_available()}")
    except Exception as e:
        lines.append(f"torch: unavailable ({e})")
    for pkg in ("numpy", "triton"):
        try:
            mod = __import__(pkg)
            lines.append(f"{pkg}: {getattr(mod, '__version__', '?')}")
        except Exception:
            lines.append(f"{pkg}: not installed")
    env_keys = [k for k in os.environ if k.startswith(("CUDA_", "HF_", "ZONOS_"))]
    lines.append("env: " + ", ".join(f"{k}={os.environ[k]}" for k in sorted(env_keys)))
    if config:
        redacted = {k: ("<set>" if v else "") if "PATH" in k else v for k, v in config.items()}
        lines.append(f"config: {redacted}")
    lines.append(check_models(config))
    return "\n".join(lines)
