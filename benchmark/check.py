"""The comparison that decides ``correct``, run once the server has exited.

For every greedy request the run finished (``min_p`` 1.0: the served token
is the sampler's best), or the run's sample of them (``run.check_sample``),
the reference (the configuration's module of ``benchmark/reference``,
``spec.reference``) works out again from the seed and the run's inputs what
the program derived: the weights, the speaker embedding of the request's
voice, the conditioning, and the backbone over the prompt and the served
frames (teacher forcing).
It reads two numbers:

* ``token_gap``: the widest gap by which a served token's logit lies below
  the reference's best, over every (position, codebook) whose input and
  target are served frames, in the sampler's view (guidance, EOS rule,
  repetition penalty);
* ``pcm_err``: the widest 512-sample frame's RMS difference between the PCM
  the client received and the reference codec's decode of the codes window
  that produced that frame, over the request's reference RMS. Every sent
  frame is compared, the seams between a stream's pieces too: the engine
  decodes each piece over a window of codes of its own, and the reference
  decodes the same window, padded as the codec pads it.

Codes are read back from what the server sent: each sent frame is matched to
the DAC decode (its codes window and its frame there) that produced it
(``serve.served_codes``); a frame that no decode produced makes the run not
correct.

The phoneme ids are the program's own (its text front end, held to its
golden snapshot by the repository's tests): the reference works out all
that follows them.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import spec
from benchmark.reference.codec import DACReference, SpeakerReference
from benchmark.reference.model import compared_mask, delay, sampler_logits
from benchmark.weights import checksum, make_voice, make_weights

HOP = 512
BUCKET = 128


def cond_values(doc: dict) -> dict:
    """The conditioning values the server gives a request that sets none but
    the text, voice and language (``make_cond_dict``'s defaults; vqscore_8
    and dnsmos_ovrl unconditional)."""
    names = {c["name"] for c in doc["config"]["prefix_conditioner"]["conditioners"]}
    v = dict(doc["serving"]["cond"])
    e = np.asarray(v["emotion"], np.float64)
    v["emotion"] = (e / e.sum()).astype(np.float32)
    return {k: val for k, val in v.items() if k in names}


def frame_errors(served: np.ndarray, ref: np.ndarray) -> np.ndarray:
    n = min(served.shape[0], ref.shape[0]) // HOP
    d = (served[: n * HOP] - ref[: n * HOP]).reshape(n, HOP)
    rms = float(np.sqrt(np.mean(ref[: n * HOP] ** 2))) or 1.0
    return np.sqrt(np.mean(d**2, axis=1)) / rms


def decode_window(codec, codes: np.ndarray) -> np.ndarray:
    """A codes window [n_q, T] decoded as the served codec decodes it: padded
    with code 0 to a whole number of ``BUCKET`` frames (at least one), then
    cut back to T frames."""
    t = codes.shape[1]
    padded = np.pad(codes, ((0, 0), (0, max(BUCKET, -(-t // BUCKET) * BUCKET) - t)))
    return codec.decode(padded)[: t * HOP].cpu().numpy()


def assemble(decoded: list, where: list) -> np.ndarray:
    """The waveform of a request's sent frames, each frame taken from the
    decode of the window that produced it: ``decoded[w]`` is window w's
    waveform, ``where`` each frame's [window, frame]."""
    return np.concatenate([decoded[w][f * HOP: (f + 1) * HOP] for w, f in where]) if where else \
        np.zeros(0, np.float32)


@torch.no_grad()
def run(doc: dict, seed: int, device, served: dict, phonemes: dict, results: dict, texts: dict, voices: dict,
        control: bool = False) -> dict:
    """``served``: the wrapper's bench_id → {codes, chunks, unmatched, windows, where};
    ``results``: bench_id → the client's record (PCM); ``texts``/``voices``:
    bench_id → the request's text and voice. Returns the readings, with the
    digest of the weights made again (``weight_checksum``), which every
    backend's has to equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = doc["config"]
    s = doc["serving"]
    w = make_weights(doc, seed, device)
    model = spec.reference(doc).Reference
    zref = model(doc, w["zonos"], device, bits=8)
    zctl = model(doc, w["zonos"], device, bits=4) if control else None
    dref = DACReference(doc, w["dac"], device)
    dctl = DACReference(doc, w["dac"], device, fp8=True) if control else None
    sref = SpeakerReference(doc, w["speaker"], w["lda"], device)
    values = cond_values(doc)
    embeds: dict = {}
    out = {"token_gap": 0.0, "pcm_err": 0.0, "unmatched": 0, "requests": 0, "tokens": 0, "frames": 0,
           "control_token_gap": 0.0, "control_pcm_err": 0.0, "weight_checksum": checksum(w)}
    n_q, masked, eos = cfg["codebook_dimension"], cfg["masked_token_id"], cfg["eos_token_id"]
    for rid, sv in sorted(served.items(), key=lambda kv: int(kv[0])):
        rid = int(rid)
        out["unmatched"] += sv["unmatched"]
        codes = np.asarray(sv["codes"], np.int64)
        n = codes.shape[1]
        if sv["unmatched"] or n < 2:
            continue
        voice = voices[rid]
        if voice not in embeds:
            embeds[voice] = sref.embed(make_voice(seed, voice, sr=doc["speaker"]["sample_rate"])).cpu().numpy()
        ids = phonemes[texts[rid]]
        delayed = torch.as_tensor(delay(codes, masked), device=device)
        o_n = n + 1
        # [O, n_q]: the token served at each predicted position (masked ones fall outside ``mask``)
        target = delayed[:, 1: o_n + 1].T.clamp(max=eos)
        mask = compared_mask(n, n_q, o_n, device)

        def gaps(model):
            cond = model.conditioning(ids, dict(values, speaker=embeds[voice]))
            lg = model.guided_logits(cond, delayed[:, :o_n], s["cfg_scale"])
            return sampler_logits(lg, delayed, eos, s["repetition_penalty"], s["repetition_penalty_window"])

        ref = gaps(zref)
        best = ref.max(dim=-1).values
        gap = (best - ref.gather(-1, target[..., None])[..., 0])[mask]
        out["token_gap"] = max(out["token_gap"], float(gap.max()))
        out["tokens"] += int(mask.sum())
        if zctl is not None:
            pick = gaps(zctl).argmax(dim=-1)
            cgap = (best - ref.gather(-1, pick[..., None])[..., 0])[mask]
            out["control_token_gap"] = max(out["control_token_gap"], float(cgap.max()))

        windows = [np.asarray(c, np.int64) for c in sv["windows"]]
        ref_wav = assemble([decode_window(dref, c) for c in windows], sv["where"])
        got = np.frombuffer(results[rid]["pcm"], "<i2").astype(np.float32) / 32767.0
        err = frame_errors(got, ref_wav)
        worst = int(np.argmax(err))
        print(f"checked request {rid}: {n} frames in pieces {sv['chunks']} from {len(windows)} decode windows, "
              f"token gap {float(gap.max()):.5f}, pcm err {float(err[worst]):.5f} at frame {worst}", file=sys.stderr)
        out["pcm_err"] = max(out["pcm_err"], float(err.max()))
        out["frames"] += int(err.shape[0])
        if dctl is not None:
            cwav = assemble([decode_window(dctl, c) for c in windows], sv["where"])
            out["control_pcm_err"] = max(out["control_pcm_err"], float(frame_errors(cwav, ref_wav).max()))
        out["requests"] += 1
    del w, zref, zctl, dref, dctl, sref
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out
