"""The plain reference against the program at tiny sizes on the CPU: the
same seeded weights through both, teacher-forced on the program's greedy
codes; the codec and the speaker tower on the same inputs. (The test imports
the program to compare; the reference itself imports nothing of it.)"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.check import cond_values
from benchmark.reference.codec import DACReference, SpeakerReference
from benchmark.reference.model import ZonosReference, compared_mask, delay, sampler_logits
from benchmark.weights import make_voice, make_weights

HERE = os.path.dirname(os.path.abspath(__file__))


def tiny(name):
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["tiny-transformer", "tiny-hybrid"])
def test_greedy_codes_are_the_references_best(name):
    from zonos_tpu_torch.conditioning import espeak
    from zonos_tpu_torch.conditioning import text as T
    from zonos_tpu_torch.config import ZonosConfig
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.serving.pipeline import build_cond_dict
    from zonos_tpu_torch.utils.loading import torch_state_dict_to_params

    doc = tiny(name)
    w = make_weights(doc, 11, "cpu")
    cfg = ZonosConfig.from_dict(doc["config"])
    model = Zonos(cfg, torch_state_dict_to_params(dict(w["zonos"]), cfg, torch.bfloat16, "cpu"),
                  torch.bfloat16, "cpu").quantize()
    spk = np.random.default_rng(0).standard_normal((1, 1, 128)).astype(np.float32)
    text = "Well met, traveler."
    cond = model.prepare_conditioning(build_cond_dict(model, text=text, speaker=spk), cfg_scale=2.0)
    codes = np.asarray(model.generate(cond, max_new_tokens=30, cfg_scale=2.0,
                                      sampling_params=SamplingParams(min_p=1.0), seed=3))[0]
    old = T.PAD_BUCKET
    ids = T.tokenize_phonemes(espeak.phonemize([text], ["en-us"]))[0][0]
    T.PAD_BUCKET = old
    n = codes.shape[1]
    delayed = torch.as_tensor(delay(codes, cfg.masked_token_id))
    mask = compared_mask(n, 9, n + 1, "cpu")
    target = delayed[:, 1: n + 2].T.clamp(max=cfg.eos_token_id)
    gaps = {}
    for bits in (8, 4):
        ref = ZonosReference(doc, w["zonos"], "cpu", bits=bits)
        c = ref.conditioning(ids, dict(cond_values(doc), speaker=spk[0, 0]))
        assert torch.allclose(c, cond.float(), atol=0.03)
        lg = sampler_logits(ref.guided_logits(c, delayed[:, : n + 1], 2.0), delayed, cfg.eos_token_id, 3.0, 2)
        gaps[bits] = float((lg.max(-1).values - lg.gather(-1, target[..., None])[..., 0])[mask].max())
    assert gaps[8] < 0.3
    assert gaps[4] > 3 * gaps[8]


def test_codec_matches_the_programs_decoder():
    from zonos_tpu_torch.codec.dac import DACAutoencoder, convert_hf_dac_state_dict
    from zonos_tpu_torch.config import DACConfig

    doc = tiny("tiny-transformer")
    w = make_weights(doc, 11, "cpu")
    cfg = DACConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in doc["dac"].items()})
    ae = DACAutoencoder(params=convert_hf_dac_state_dict(dict(w["dac"]), cfg), cfg=cfg, dtype=torch.float32,
                        device="cpu")
    codes = np.random.default_rng(0).integers(0, 1024, (1, 9, 128))
    got = ae.decode_device(torch.as_tensor(codes))[0].numpy()
    ref = DACReference(doc, w["dac"], "cpu").decode(codes[0]).numpy()
    assert np.abs(got - ref).max() < 1e-3
    fp8 = DACReference(doc, w["dac"], "cpu", fp8=True).decode(codes[0]).numpy()
    assert np.abs(fp8 - ref).max() > 1e-2


def test_speaker_tower_matches_the_programs():
    from zonos_tpu_torch.speaker.embedding import SpeakerEmbeddingLDA
    from zonos_tpu_torch.speaker.resnet import speaker_state_dict_to_params

    doc = tiny("tiny-transformer")
    w = make_weights(doc, 11, "cpu")
    tower = SpeakerEmbeddingLDA(params=speaker_state_dict_to_params(dict(w["speaker"])),
                                lda={"w": w["lda"]["weight"], "b": w["lda"]["bias"]}, device="cpu")
    pcm = make_voice(11, 0)
    _, got = tower(pcm.astype(np.float32) / 32768.0, 16000)
    ref = SpeakerReference(doc, w["speaker"], w["lda"], "cpu").embed(pcm).numpy()
    assert np.allclose(got[0], ref, rtol=1e-3, atol=1e-3)


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    doc = tiny("tiny-hybrid")
    a, b, c = make_weights(doc, 2**31 + 5, "cpu"), make_weights(doc, 2**31 + 5, "cpu"), make_weights(doc, 6, "cpu")
    for k in a:
        for name in a[k]:
            assert torch.equal(a[k][name], b[k][name])
    assert not torch.equal(a["zonos"]["heads.0.weight"], c["zonos"]["heads.0.weight"])
    assert float(a["zonos"]["heads.0.weight"][doc["config"]["eos_token_id"]].abs().max()) == 0.0
