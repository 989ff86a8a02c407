"""Persistent derived-state caches: speaker embeddings and DAC prefix codes.

Copy of ``zonos_tpu/serving/caches.py``, with the same on-disk layout and
format, so either backend reads the other's entries: a thread-locked two-tier
cache — in-memory dict + on-disk ``.npz`` files under
``cache/{embeds/<model>,prefixes}/`` relative to the working directory —
keyed by the audio file stem, plus timestamped wav output directories.

Several server processes may share one working directory (one per card
behind ``serving/router.py``): each writer of an entry writes a temporary
file of its own (process and thread in its name) and renames it into place,
so a reader never sees a half-written entry, and each process's output
directory carries its process id. The JAX package's copy uses one temporary
name per key and a directory named to the second.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

import numpy as np


class TensorCacheManager:
    """Two-tier (memory + disk) numpy cache, thread-safe."""

    def __init__(self, cache_type: str, base_dir: str = "cache", model_name: str | None = None):
        assert cache_type in ("embeds", "prefixes")
        self.cache_type = cache_type
        sub = os.path.join(cache_type, _sanitize(model_name)) if model_name else cache_type
        self.dir = Path(base_dir) / sub
        self._mem: dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    def _path(self, key: str) -> Path:
        return self.dir / f"{_sanitize(key)}.npz"

    def get(self, key: str) -> np.ndarray | None:
        with self._lock:
            if key in self._mem:
                return self._mem[key]
        path = self._path(key)
        if path.exists():
            try:
                arr = np.load(path)["data"]
            except Exception:
                return None
            with self._lock:
                self._mem[key] = arr
            return arr
        return None

    def put(self, key: str, value: np.ndarray, persist: bool = True) -> None:
        value = np.asarray(value)
        with self._lock:
            self._mem[key] = value
        if persist:
            self.dir.mkdir(parents=True, exist_ok=True)
            tmp = self.dir / f"{_sanitize(key)}.{writer_tag()}.tmp.npz"
            np.savez(tmp, data=value)
            os.replace(tmp, self._path(key))

    def contains(self, key: str) -> bool:
        with self._lock:
            if key in self._mem:
                return True
        return self._path(key).exists()

    def clear_memory(self) -> None:
        with self._lock:
            self._mem.clear()

    def size(self) -> int:
        with self._lock:
            return len(self._mem)


def writer_tag() -> str:
    """This process and thread: in a temporary file's name, one no other
    writer in the working directory shares."""
    return f"{os.getpid()}-{threading.get_ident()}"


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in str(name))


# Module-level singletons, one per process as in the JAX package.
_EMBED_CACHES: dict[str, TensorCacheManager] = {}
_PREFIX_CACHE: TensorCacheManager | None = None
_CACHE_LOCK = threading.Lock()


def get_embed_cache(model_name: str, base_dir: str = "cache") -> TensorCacheManager:
    with _CACHE_LOCK:
        if model_name not in _EMBED_CACHES:
            _EMBED_CACHES[model_name] = TensorCacheManager("embeds", base_dir, model_name)
        return _EMBED_CACHES[model_name]


def get_prefix_cache(base_dir: str = "cache") -> TensorCacheManager:
    global _PREFIX_CACHE
    with _CACHE_LOCK:
        if _PREFIX_CACHE is None:
            _PREFIX_CACHE = TensorCacheManager("prefixes", base_dir)
        return _PREFIX_CACHE


_OUTPUT_ROOT: str | None = None


def get_output_dir(base: str = "output_temp") -> str:
    """Timestamped per-process output directory, ``<base>/<time>-<pid>``:
    processes started in the same second write apart."""
    global _OUTPUT_ROOT
    with _CACHE_LOCK:
        if _OUTPUT_ROOT is None:
            _OUTPUT_ROOT = os.path.join(base, f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}")
            os.makedirs(_OUTPUT_ROOT, exist_ok=True)
        return _OUTPUT_ROOT
