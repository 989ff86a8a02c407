"""The port's dynamic batcher (``serving/batcher.DynamicBatcher``).

Tiny transformer, tiny DAC, float32 on the CPU. Coalesced requests run as
one ``generate_audio`` (or ``generate_stream``); signatures are not mixed,
nor stream and generate requests; a stream closes at its own EOS. Each
request's PCM equals the solo run of its own conditioning rows at its own
seed.
"""

import threading

import numpy as np
import pytest
import torch

from zonos_tpu_torch.runtime import streaming
from zonos_tpu_torch.serving.batcher import DynamicBatcher, TTSRequest

from tests.test_torch_engine import tiny_model


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def _run(fn, args_list):
    threads = [threading.Thread(target=fn, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)


def _solo_pcm(model, batcher, reqs, i):
    """Request i's PCM from a batch-1 ``generate_audio`` of its own rows of the batched conditioning."""
    cond = model.prepare_conditioning(batcher._batched_cond_dict(reqs), cfg_scale=reqs[i].cfg_scale)
    b = len(reqs)
    rows = torch.cat([cond[i:i + 1], cond[b + i:b + i + 1]])
    wav, lengths = model.generate_audio(rows, max_new_tokens=max(r.max_new_tokens for r in reqs),
                                        cfg_scale=reqs[i].cfg_scale, sampling_params=reqs[i].sampling,
                                        seed=[reqs[i].seed], pcm_int16=True)
    return wav[0][: int(lengths[0]) * model.autoencoder.config.hop_length]


def test_concurrent_requests_coalesce_and_equal_their_solo_runs(model):
    batcher = DynamicBatcher(model, max_batch=4, window_ms=300)
    try:
        reqs = [TTSRequest(text=f"request number {i}", max_new_tokens=12, seed=10 + i) for i in range(3)]
        results = {}
        _run(lambda i: results.__setitem__(i, batcher.submit(reqs[i])), [(i,) for i in range(3)])
        assert len(results) == 3
        assert batcher.stats["requests"] == 3 and batcher.stats["batches"] == 1
        for i in range(3):
            wav, sr = results[i]
            assert sr == 44100 and wav.ndim == 1 and wav.dtype == np.int16 and wav.shape[0] > 0
            np.testing.assert_array_equal(wav, _solo_pcm(model, batcher, reqs, i))
    finally:
        batcher.close()


def test_different_signatures_not_mixed(model):
    batcher = DynamicBatcher(model, max_batch=4, window_ms=200)
    try:
        results = {}
        _run(lambda i, c: results.__setitem__(i, batcher.submit(TTSRequest(text=f"t{i}", max_new_tokens=12,
                                                                           cfg_scale=c, seed=1))),
             [(0, 2.0), (1, 3.0)])
        assert len(results) == 2 and batcher.stats["batches"] == 2
    finally:
        batcher.close()


def test_concurrent_streams_coalesce_mixed_lengths(model):
    batcher = DynamicBatcher(model, max_batch=4, window_ms=300)
    try:
        chunks = {}

        def consume(i, text, max_new):
            chunks[i] = [w for w, sr in batcher.submit_stream(TTSRequest(text=text, max_new_tokens=max_new, seed=1))]

        _run(consume, [(0, "short one", 10), (1, "a rather longer request text", 40), (2, "medium text here", 24)])
        assert set(chunks) == {0, 1, 2}
        for got in chunks.values():
            total = np.concatenate(got)
            assert total.size > 0 and np.isfinite(total).all()
        assert batcher.stats["requests"] == 3 and batcher.stats["batches"] == 1
    finally:
        batcher.close()


def test_stream_closes_at_own_eos_before_batch_ends(model, monkeypatch):
    orig = streaming._make_bias

    def biased(statics, device):
        bias = orig(statics, device)
        eos = statics.cfg.eos_token_id
        bias[0, 0] = -torch.inf
        bias[0, 0, eos] = 0.0  # sample 0: EOS at once
        bias[1:, 0, eos] = -torch.inf  # sample 1: runs to its cap
        return bias

    monkeypatch.setattr(streaming, "_make_bias", biased)
    batcher = DynamicBatcher(model, max_batch=4, window_ms=50)
    try:
        reqs = [TTSRequest(text=t, max_new_tokens=32, seed=5, stream=True)
                for t in ("early stopper", "keeps on talking")]
        batcher._run_stream_batch(reqs)

        def drain(req):
            items = []
            while (item := req.chunks.get_nowait()) is not None:
                items.append(item[0])
            return items

        got0, got1 = drain(reqs[0]), drain(reqs[1])
        n0, n1 = sum(p.size for p in got0), sum(p.size for p in got1)
        hop = model.autoencoder.config.hop_length
        assert n0 % hop == 0 and n1 % hop == 0 and n1 > n0
        assert len(got0) < len(got1)
    finally:
        batcher.close()


def test_stream_and_generate_requests_do_not_mix(model):
    batcher = DynamicBatcher(model, max_batch=4, window_ms=250)
    try:
        results = {}

        def gen():
            results["gen"] = batcher.submit(TTSRequest(text="plain generate", max_new_tokens=12, seed=1))

        def stream():
            results["stream"] = [w for w, _ in batcher.submit_stream(TTSRequest(text="streamed words",
                                                                                 max_new_tokens=12, seed=1))]

        threads = [threading.Thread(target=gen), threading.Thread(target=stream)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert results["gen"][0].size > 0 and sum(w.size for w in results["stream"]) > 0
        assert batcher.stats["batches"] == 2
    finally:
        batcher.close()
