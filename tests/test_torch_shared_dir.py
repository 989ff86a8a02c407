"""Server processes that share one working directory (one per card behind
``serving/router.py``, as docs/DEPLOYMENT.md runs them).

Every file a server writes there is either its own or appears whole: the
speaker-embedding cache's entries, the uploaded voices (``POST /speakers``
and inline ``speaker_wav_base64``) and the request wavs. Each test holds
writers at a barrier or an event at the moment the race would strike, so it
needs no sleeps.
"""

import base64
import hashlib
import threading

import numpy as np
import pytest

from zonos_tpu_torch.serving import caches
from zonos_tpu_torch.serving import pipeline as TP
from zonos_tpu_torch.serving import server as S


def test_two_writers_of_one_cache_key_both_land(tmp_path, monkeypatch):
    """Two writers of one key (two processes that embed the same voice), both
    held after np.savez until the other has written too: each renames its
    own temporary file, the entry loads whole, and no temporary is left."""
    cache = caches.TensorCacheManager("embeds", str(tmp_path), "model-a")
    barrier = threading.Barrier(2, timeout=10)
    savez = np.savez

    def held(file, **arrays):
        savez(file, **arrays)
        barrier.wait()

    monkeypatch.setattr(np, "savez", held)
    values = [np.full((1, 1, 128), i, np.float32) for i in (1, 2)]
    errors = []

    def put(value):
        try:
            cache.put("voice", value)
        except Exception as e:  # noqa: BLE001  reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=put, args=(v,)) for v in values]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    got = np.load(cache._path("voice"))["data"]
    assert any(np.array_equal(got, v) for v in values)
    assert [p.name for p in cache.dir.iterdir()] == ["voice.npz"]


class _FakeModel:
    """What generate_and_save_audio calls: 10 ms of silence per request."""

    class autoencoder:  # noqa: N801
        sampling_rate = 44100

    def prepare_conditioning(self, cond_dict, use_cache=True, cfg_scale=2.0):
        return None

    def generate_audio(self, conditioning, **kw):
        return np.zeros((1, 441), np.int16), [1]


def test_request_wavs_never_share_a_path(tmp_path, monkeypatch):
    """Two processes started in the same second, each writing two requests
    in one millisecond: four files on four paths."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(caches.time, "strftime", lambda fmt: "20261017-120000")
    monkeypatch.setattr(TP.time, "time_ns", lambda: 1_760_000_000_000_000_000)
    params = TP.GenerationParams(seed=1, max_new_tokens=86)
    paths = []
    for pid in (4101, 4102):
        monkeypatch.setattr(caches.os, "getpid", lambda pid=pid: pid)
        monkeypatch.setattr(caches, "_OUTPUT_ROOT", None)
        for _ in range(2):
            paths.append(TP.generate_and_save_audio(_FakeModel(), {}, params)[0])
    assert len(set(paths)) == 4
    assert all((tmp_path / p).stat().st_size > 0 for p in paths)


@pytest.mark.parametrize("route", ["save_speaker", "inline"])
def test_a_voice_file_is_never_seen_half_written(tmp_path, monkeypatch, route):
    """A voice upload (``POST /speakers``, or an inline ``speaker_wav_base64``
    that another backend may read at once) held halfway through its write:
    its final path holds nothing yet, and afterwards the whole file, with no
    temporary left beside it."""
    monkeypatch.chdir(tmp_path)
    raw = bytes(range(256)) * 64
    halfway, release = threading.Event(), threading.Event()
    real_open = open

    class HalfThenWait:
        def __init__(self, f):
            self.f = f

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return self.f.__exit__(*exc)

        def write(self, data):
            self.f.write(data[:len(data) // 2])
            self.f.flush()
            halfway.set()
            assert release.wait(10)
            return self.f.write(data[len(data) // 2:])

    def opening(path, mode="r", *args, **kw):
        f = real_open(path, mode, *args, **kw)
        return HalfThenWait(f) if "w" in mode else f

    monkeypatch.setattr(S, "open", opening, raising=False)
    if route == "save_speaker":
        final = tmp_path / "speakers" / "uploads" / "npc.wav"
        write = lambda: S.save_speaker("npc", raw)  # noqa: E731
    else:
        final = tmp_path / "cache" / "uploads" / f"{hashlib.sha1(raw).hexdigest()[:16]}.wav"
        write = lambda: S.resolve_speaker_path({"speaker_wav_base64": base64.b64encode(raw).decode()})  # noqa: E731
    writer = threading.Thread(target=write)
    writer.start()
    try:
        assert halfway.wait(10)
        seen = final.read_bytes() if final.exists() else None
    finally:
        release.set()
        writer.join(timeout=30)
    assert seen is None
    assert final.read_bytes() == raw
    assert [p.name for p in final.parent.iterdir()] == [final.name]
