"""Files of a local Hugging Face hub cache, found by path: nothing is
downloaded and ``huggingface_hub`` is not imported.

The cache is ``HF_HUB_CACHE``, else ``HF_HOME/hub``, else
``~/.cache/huggingface/hub``; a repo's files live under
``models--<org>--<name>/snapshots/<commit>/``, and ``refs/<branch>`` names
the commit of a branch.
"""

from __future__ import annotations

import os
from pathlib import Path


def hub_cache_dir(cache_dir: str | os.PathLike | None = None) -> Path:
    if cache_dir is not None:
        return Path(cache_dir)
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    home = os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache", "huggingface")
    return Path(home) / "hub"


def repo_dir(repo_id: str, cache_dir=None) -> Path:
    return hub_cache_dir(cache_dir) / f"models--{repo_id.replace('/', '--')}"


def cached_snapshot(repo_id: str, filenames: tuple[str, ...], revision: str | None = None,
                    cache_dir=None) -> Path | None:
    """The snapshot directory of ``repo_id`` that holds every one of
    ``filenames``, or None. ``revision`` is a branch (resolved through
    ``refs/``) or a commit; without one, ``refs/main``'s commit is tried
    first, then every snapshot in name order."""
    root = repo_dir(repo_id, cache_dir)
    snapshots = root / "snapshots"
    if not snapshots.is_dir():
        return None
    ref = root / "refs" / (revision or "main")
    commit = ref.read_text().strip() if ref.is_file() else revision
    candidates = [snapshots / commit] if commit else []
    if revision is None:
        candidates += sorted(p for p in snapshots.iterdir() if p not in candidates)
    for snap in candidates:
        if all((snap / name).is_file() for name in filenames):
            return snap
    return None
