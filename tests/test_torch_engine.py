"""The port's continuous serving engine (``serving/continuous.ContinuousEngine``) end to end.

Tiny transformer and hybrid, tiny DAC, float32 on the CPU. Covered: requests
coalescing into one epoch, a mid-epoch join into a recycled slot, stream
chunks, an oversized request, mixed sampling groups in one epoch and
structural groups split, the submit timeout, staggered load through the KV
and frame rolls and the attend ladder, the hybrid, depth 1, greedy codes
against ``generate`` and against chip_smoke's engine-shaped reference, and a
short fuzz of random schedules against solo runs.
"""

import logging
import random
import threading
import time

import numpy as np
import pytest
import torch

from zonos_tpu_torch.codec.dac import DACAutoencoder, init_dac_params
from zonos_tpu_torch.config import DACConfig, tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime.generate import generate
from zonos_tpu_torch.serving.batcher import DynamicBatcher, TTSRequest
from zonos_tpu_torch.serving.continuous import ContinuousEngine, _SingleView

from chip_smoke import CodeTap, EngineReference, JoinTap, _greedy_parity  # phase 10's taps, reference and gates

DAC_KW = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
              upsampling_ratios=(4, 2), n_codebooks=9, codebook_size=1024, codebook_dim=4, hidden_size=24)


def tiny_dac():
    cfg = DACConfig(**DAC_KW)
    gen = torch.Generator().manual_seed(0)
    return DACAutoencoder(params=init_dac_params(gen, cfg, device="cpu"), cfg=cfg, dtype=torch.float32,
                          frame_bucket=8, device="cpu")


def tiny_model(config=None):
    m = Zonos.from_config(config or tiny_transformer_config(), seed=0, dtype=torch.float32, device="cpu").quantize()
    m._autoencoder = tiny_dac()
    return m


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def _engine(model, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("prefill_len", 64)
    kw.setdefault("max_new_cap", 200)
    kw.setdefault("segment_frames", 16)
    kw.setdefault("first_chunk_frames", 8)
    return ContinuousEngine(model, **kw)


def _run_threads(fn, args_list):
    threads = [threading.Thread(target=fn, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)


def test_concurrent_submits_coalesce_one_epoch(model):
    eng = _engine(model, window_ms=300)
    try:
        results = {}
        _run_threads(lambda i: results.__setitem__(i, eng.submit(TTSRequest(text=f"request {i}", max_new_tokens=24,
                                                                            seed=i))), [(0,), (1,)])
        assert set(results) == {0, 1}
        hop = model.autoencoder.config.hop_length
        for wav, sr in results.values():
            assert sr == 44100 and wav.ndim == 1 and wav.dtype == np.int16
            assert 0 < wav.shape[0] <= 24 * hop and wav.shape[0] % hop == 0
        assert eng.stats["requests"] == 2 and eng.stats["epochs"] == 1 and eng.stats["joins"] == 2
        assert eng.stats["prefills"] == 3  # the batch start and two joiners
        assert eng.stats["steps"] >= 24
    finally:
        eng.close()


def test_mid_epoch_join_and_slot_recycle(model):
    eng = _engine(model, slots=1, window_ms=30)
    try:
        results = {}

        def go(i, delay, tokens):
            time.sleep(delay)
            results[i] = eng.submit(TTSRequest(text=f"req {i}", max_new_tokens=tokens, seed=i))

        _run_threads(go, [(0, 0.0, 64), (1, 0.3, 24)])
        assert set(results) == {0, 1}
        assert all(w.shape[0] > 0 for w, _ in results.values())
        assert eng.stats["epochs"] == 1 and eng.stats["slot_recycles"] >= 1 and eng.stats["mid_epoch_joins"] >= 1
    finally:
        eng.close()


def test_stream_chunks_arrive_incrementally(model):
    eng = _engine(model, window_ms=20)
    try:
        chunks = list(eng.submit_stream(TTSRequest(text="stream through the engine", max_new_tokens=48, seed=3)))
        assert len(chunks) >= 2
        total = np.concatenate([c[0] for c in chunks])
        hop = model.autoencoder.config.hop_length
        assert total.shape[0] % hop == 0 and 0 < total.shape[0] <= 48 * hop
        wav, _ = eng.submit(TTSRequest(text="stream through the engine", max_new_tokens=48, seed=3))
        np.testing.assert_array_equal(total, wav)  # the same request, streamed or not
    finally:
        eng.close()


def test_oversized_request_rejected(model):
    eng = _engine(model, max_new_cap=100)
    try:
        with pytest.raises(ValueError, match="exceeds engine capacity"):
            eng.submit(TTSRequest(text="too long", max_new_tokens=10_000, seed=0))
    finally:
        eng.close()


def test_mixed_sampling_groups_coalesce_one_epoch(model):
    eng = _engine(model, window_ms=300)
    specs = {0: dict(cfg_scale=2.0),
             1: dict(cfg_scale=3.0, sampling=SamplingParams(top_p=0.9, temperature=0.8, repetition_penalty=1.0))}
    try:
        results = {}
        _run_threads(lambda i: results.__setitem__(i, eng.submit(TTSRequest(text=f"g{i}", max_new_tokens=16, seed=1,
                                                                            **specs[i]))), [(0,), (1,)])
        assert set(results) == {0, 1} and eng.stats["epochs"] == 1
        for i, spec in specs.items():  # each equals the same request served alone
            wav, _ = eng.submit(TTSRequest(text=f"g{i}", max_new_tokens=16, seed=1, **spec))
            assert wav.shape == results[i][0].shape
    finally:
        eng.close()


def test_structural_sampling_groups_split_epochs(model):
    eng = _engine(model, window_ms=150)
    try:
        results = {}
        _run_threads(lambda i, k: results.__setitem__(i, eng.submit(TTSRequest(
            text=f"g{i}", max_new_tokens=16, seed=1, sampling=SamplingParams(top_k=k)))), [(0, 0), (1, 24)])
        assert set(results) == {0, 1} and eng.stats["epochs"] == 2
    finally:
        eng.close()


def test_submit_timeout_raises_timeouterror(model):
    eng = _engine(model)
    eng.close()
    with pytest.raises(TimeoutError):
        eng.submit(TTSRequest(text="never served", max_new_tokens=16), timeout=0.3)
    with pytest.raises(TimeoutError):
        list(eng.submit_stream(TTSRequest(text="never served", max_new_tokens=16), timeout=0.3))


def test_staggered_load_rolls_and_attend_ladder(model, monkeypatch, caplog):
    """Small roll quanta: staggered joiners' dead gaps roll out of the cache,
    the shipped head of the frame timeline is reclaimed, segments switch
    attend rungs, and every request still gets its solo sample count."""
    caplog.set_level(logging.WARNING, logger="zonos_tpu_torch")
    monkeypatch.setenv("ZONOS_ENGINE_ROLL_QUANTUM", "8")
    monkeypatch.setenv("ZONOS_ENGINE_ATTEND_QUANTUM", "64")
    monkeypatch.setenv("ZONOS_ENGINE_FRAME_QUANTUM", "32")
    eng = _engine(model, slots=2, window_ms=50, max_new_cap=300)
    eng.frame_margin = 64
    assert (eng.roll_quantum, eng.attend_quantum, eng.frame_quantum) == (8, 64, 32)
    specs = [dict(text=f"req {i}", max_new_tokens=48 + 16 * (i % 3), seed=i) for i in range(4)]
    try:
        oracle = [eng.submit(TTSRequest(**s))[0].shape[0] for s in specs]
        rungs = []
        seg_attend = __import__("zonos_tpu_torch.serving.continuous", fromlist=["x"]).compiled_segment_attend

        def spy(statics, rung):
            rungs.append(rung)
            return seg_attend(statics, rung)

        monkeypatch.setattr("zonos_tpu_torch.serving.continuous.compiled_segment_attend", spy)
        results = {}

        def go(i, delay):
            time.sleep(delay)
            results[i] = eng.submit(TTSRequest(**specs[i]))[0].shape[0]

        _run_threads(go, [(i, 0.4 * i) for i in range(4)])
        assert [results[i] for i in range(4)] == oracle
        assert eng.stats["mid_epoch_joins"] >= 1 and eng.stats["rolls"] >= 1
        assert eng.stats["rolled_steps"] > 0 and eng.stats["rolled_frames"] > 0
        assert len(set(rungs)) >= 2 and min(rungs) < eng.cache_len
        assert not [r for r in caplog.records if "emitted" in r.getMessage()]
    finally:
        eng.close()


def test_hybrid_engine_serves_staggered_load(monkeypatch):
    monkeypatch.setenv("ZONOS_ENGINE_ROLL_QUANTUM", "8")
    m = tiny_model(tiny_hybrid_config())
    eng = _engine(m, slots=2, window_ms=50, max_new_cap=300)
    try:
        results = {}

        def go(i, delay):
            time.sleep(delay)
            results[i] = eng.submit(TTSRequest(text=f"hybrid req {i}", max_new_tokens=64, seed=i))

        _run_threads(go, [(i, 0.15 * i) for i in range(3)])
        assert set(results) == {0, 1, 2}
        hop = m.autoencoder.config.hop_length
        assert all(0 < w.shape[0] <= 64 * hop for w, _ in results.values())
        assert eng.stats["mid_epoch_joins"] >= 1 and eng.stats["rolls"] >= 1
    finally:
        eng.close()


def test_depth1_engine_still_serves(model, monkeypatch):
    monkeypatch.setenv("ZONOS_ENGINE_DEPTH", "1")
    eng = _engine(model, window_ms=50)
    assert eng.depth == 1
    try:
        wav, _ = eng.submit(TTSRequest(text="depth one", max_new_tokens=24, seed=7))
        assert wav.shape[0] > 0
    finally:
        eng.close()


def test_greedy_codes_equal_generate(model):
    """Greedy requests, the second joining mid-epoch: the codes each was
    decoded from equal ``generate``'s for the same conditioning at the
    engine's prefill bucket and cache length (another prefill bucket moves
    greedy tokens of the tiny random model, in JAX as in the port)."""
    eng = _engine(model, window_ms=20, slots=2)
    tap = CodeTap(eng)
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.0)
    reqs = [TTSRequest(text="the first greedy request", max_new_tokens=40, seed=1, sampling=greedy),
            TTSRequest(text="a second one joins later", max_new_tokens=32, seed=2, sampling=greedy)]
    try:
        _run_threads(lambda i, d: (time.sleep(d), eng.submit(reqs[i])), [(0, 0.0), (1, 0.25)])
        assert eng.stats["mid_epoch_joins"] >= 1
        for r in reqs:
            cond = model.prepare_conditioning(DynamicBatcher._batched_cond_dict(_SingleView(model), [r]))
            ref = generate(model.params, model.config, cond, max_new_tokens=r.max_new_tokens, sampling_params=greedy,
                           seed=r.seed, prefill_bucket=eng.prefill_len, audio_bucket=eng.delayed_len,
                           dtype=torch.float32, kv_int8=True, device="cpu")[0]
            np.testing.assert_array_equal(tap.of(r), ref)
    finally:
        eng.close()


@pytest.mark.parametrize("join_late", [False, True])
def test_engine_reference_gives_engine_codes(model, join_late):
    """chip_smoke's EngineReference (generate's prefill at 2 rows, its decode
    at the engine's 2·slots rows from the recorded join step) gives a greedy
    request's engine codes, joined at step 0 or mid-epoch, and teacher
    forcing those codes agrees at every (step, codebook); forcing another
    request's codes does not."""
    eng = _engine(model, window_ms=20, slots=3)
    tap = CodeTap(eng)
    greedy = SamplingParams(temperature=0.0)
    filler = TTSRequest(text="a filler that runs first", max_new_tokens=60, seed=4, sampling=greedy)
    req = TTSRequest(text="the greedy request", max_new_tokens=32, seed=1, sampling=greedy)
    try:
        with JoinTap() as joins:
            if join_late:
                _run_threads(lambda r, d: (time.sleep(d), eng.submit(r)), [(filler, 0.0), (req, 0.25)])
            else:
                eng.submit(req)
        j = joins.of(req, "cpu")
        assert (j > 0) == join_late and eng.stats["rolled_steps"] == 0
        ref = EngineReference(model, eng)
        np.testing.assert_array_equal(tap.of(req), ref.codes(req, j))
        hit = ref.forced(req, tap.of(req), j)
        assert hit["compared"] > 200 and hit["agree"] == hit["compared"] and hit["worst_gap"] == 0.0
        other = ref.forced(req, ref.codes(TTSRequest(text="other words", max_new_tokens=32, seed=1, sampling=greedy)),
                           j)
        assert other["agree"] < 0.5 * other["compared"] and other["worst_gap"] > 0.1
    finally:
        eng.close()


def test_phase10_greedy_gates_pass(model):
    """chip_smoke's greedy gates of phase 10 on the tiny model (requests cut
    to 40 frames): a 1-slot engine equals generate, and a 3-slot engine's
    codes, three at once and one joining mid-epoch, equal EngineReference's."""
    eng = _engine(model, slots=3)
    try:
        out = _greedy_parity(model, eng, max_new_tokens=40)
    finally:
        eng.close()
    assert [p["first_differing_frame"] for p in out["one_slot_engine"]] == [None] * 3
    wide = out["eight_slot_engine"]
    assert [p["vs_reference"] for p in wide] == [None] * 4 and wide[-1]["join_step"] > 0
    assert all(p["generate_2_rows_forced"]["agree"] == p["generate_2_rows_forced"]["compared"] for p in wide[:3])


def test_fuzz_random_schedules_vs_solo(model, caplog):
    """A few random schedules (mixed groups, no_batch, an abandoned stream):
    every request's sample count equals its solo run's."""
    caplog.set_level(logging.WARNING, logger="zonos_tpu_torch")
    eng = _engine(model, slots=2, window_ms=30, segment_frames=8, first_chunk_frames=8)
    eng.roll_quantum, eng.attend_quantum = 8, 64
    pool = [dict(text="alpha", seed=3, max_new_tokens=16),
            dict(text="beta request somewhat longer", seed=5, max_new_tokens=24),
            dict(text="gamma", seed=7, max_new_tokens=12, cfg_scale=3.0),
            dict(text="delta mixed sampler", seed=9, max_new_tokens=20,
                 sampling=SamplingParams(top_p=0.9, temperature=0.8, repetition_penalty=1.0)),
            dict(text="epsilon isolated", seed=11, max_new_tokens=16, no_batch=True)]
    try:
        oracle = [eng.submit(TTSRequest(**spec))[0].shape[0] for spec in pool]
        for s in range(3):
            rng = random.Random(1000 + s)
            picks = [rng.randrange(len(pool)) for _ in range(rng.randint(2, 4))]
            results, failures = {}, []

            def go(j, i, delay, abandon):
                time.sleep(delay)
                try:
                    if abandon:
                        next(eng.submit_stream(TTSRequest(**pool[i])), None)
                        results[j] = ("abandoned", i)
                    else:
                        results[j] = (eng.submit(TTSRequest(**pool[i]))[0].shape[0], i)
                except Exception as e:  # reported below
                    failures.append((j, i, repr(e)))

            _run_threads(go, [(j, i, rng.random() * 0.5, rng.random() < 0.15) for j, i in enumerate(picks)])
            assert not failures and len(results) == len(picks), (s, failures, results)
            for j, (val, i) in results.items():
                assert val == "abandoned" or val == oracle[i], (s, j, i, val, oracle[i])
        assert not [r for r in caplog.records if "emitted" in r.getMessage()]
    finally:
        eng.close()
