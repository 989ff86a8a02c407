"""Seeded weights in the published layouts, made on the device in a few calls.

``make_weights(doc, seed, device)`` returns four state dicts named as the
published checkpoints name them:

* ``zonos``: the model's state dict in the layout of its reference module
  (``spec.reference``; by default Zonos-v0.1's: ``embeddings.N``, ``heads.N``,
  ``backbone.layers.N.*``, ``prefix_conditioner.*``), bf16;
* ``dac``: transformers' ``DacModel`` state dict of descript/dac_44khz
  (weight-norm pairs ``weight_g``/``weight_v``), float32;
* ``speaker``: the ResNet293-SimAM-ASP tower (``front.*``, ``pooling.*``,
  ``bottleneck.*``, BatchNorm with running statistics), float32;
* ``lda``: the LDA-128 projection (``weight``, ``bias``), float32.

The same ``doc`` (a configuration file of ``benchmark/configs``) and seed give
the same tensors in every process on the same device: the server wrapper
hands them to the program and the reference makes them again. Nothing here
imports the program.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from benchmark import spec

# A spec entry: (name, shape, init) with init ("normal", std), ("const", value)
# or ("fn", callable(generator, shape, device) -> float32 tensor). The model's
# specs are its reference module's ``weight_specs`` (``spec.reference``).


def _conv(specs, prefix, shape, std, bias=True):
    """A weight-normed conv: weight_v drawn, weight_g its norm over all but dim 0."""
    specs.append((f"{prefix}.weight_v", shape, ("normal", std)))
    specs.append((f"{prefix}.weight_g", (shape[0], 1, 1), ("wnorm", f"{prefix}.weight_v")))
    if bias:
        specs.append((f"{prefix}.bias", (shape[1] if prefix.endswith("conv_t1") else shape[0],), ("const", 0.0)))


def _dac_specs(dac: dict) -> list:
    specs = []
    hidden, dh = dac["hidden_size"], dac["decoder_hidden_size"]

    def alpha(name, c):
        specs.append((name, (1, c, 1), ("const", 1.0)))

    def res(p, c):
        alpha(f"{p}.snake1.alpha", c)
        _conv(specs, f"{p}.conv1", (c, c, 7), 1 / math.sqrt(7 * c))
        alpha(f"{p}.snake2.alpha", c)
        _conv(specs, f"{p}.conv2", (c, c, 1), 0.5 / math.sqrt(c))

    _conv(specs, "decoder.conv1", (dh, hidden, 7), 1 / math.sqrt(7 * hidden))
    for i, stride in enumerate(dac["upsampling_ratios"]):
        cin, cout = dh // 2**i, dh // 2 ** (i + 1)
        alpha(f"decoder.block.{i}.snake1.alpha", cin)
        _conv(specs, f"decoder.block.{i}.conv_t1", (cin, cout, 2 * stride), 1 / math.sqrt(2 * cin))
        for r in range(3):
            res(f"decoder.block.{i}.res_unit{r + 1}", cout)
    c_last = dh // 2 ** len(dac["upsampling_ratios"])
    alpha("decoder.snake1.alpha", c_last)
    _conv(specs, "decoder.conv2", (1, c_last, 7), 0.03 / math.sqrt(7 * c_last))

    eh = dac["encoder_hidden_size"]
    _conv(specs, "encoder.conv1", (eh, 1, 7), 1 / math.sqrt(7))
    for i, stride in enumerate(dac["downsampling_ratios"]):
        c = eh * 2**i
        for r in range(3):
            res(f"encoder.block.{i}.res_unit{r + 1}", c)
        alpha(f"encoder.block.{i}.snake1.alpha", c)
        _conv(specs, f"encoder.block.{i}.conv1", (2 * c, c, 2 * stride), 1 / math.sqrt(2 * stride * c))
    c_enc = eh * 2 ** len(dac["downsampling_ratios"])
    alpha("encoder.snake1.alpha", c_enc)
    _conv(specs, "encoder.conv2", (hidden, c_enc, 3), 1 / math.sqrt(3 * c_enc))

    cd = dac["codebook_dim"]
    for i in range(dac["n_codebooks"]):
        q = f"quantizer.quantizers.{i}"
        specs.append((f"{q}.codebook.weight", (dac["codebook_size"], cd), ("normal", 1.0)))
        _conv(specs, f"{q}.in_proj", (cd, hidden, 1), 1 / math.sqrt(hidden))
        _conv(specs, f"{q}.out_proj", (hidden, cd, 1), 1 / math.sqrt(cd))
    return specs


def _bn(specs, prefix, c, scale=1.0):
    specs += [(f"{prefix}.weight", (c,), ("const", scale)), (f"{prefix}.bias", (c,), ("const", 0.0)),
              (f"{prefix}.running_mean", (c,), ("const", 0.0)), (f"{prefix}.running_var", (c,), ("const", 1.0))]


def speaker_feat_dim(sp: dict) -> int:
    return sp["in_planes"] * 8 * (sp["acoustic_dim"] // 8)


def _speaker_specs(sp: dict) -> list:
    specs = []
    p0 = sp["in_planes"]

    def conv(name, co, ci, k):
        specs.append((name, (co, ci, k, k), ("normal", math.sqrt(2.0 / (k * k * ci)))))

    conv("front.conv1.weight", p0, 1, 3)
    _bn(specs, "front.bn1", p0)
    ci = p0
    for li, n_blocks in enumerate(sp["layer_plan"]):
        co = p0 * 2**li
        for j in range(n_blocks):
            bp = f"front.layer{li + 1}.{j}"
            cin = ci if j == 0 else co
            conv(f"{bp}.conv1.weight", co, cin, 3)
            _bn(specs, f"{bp}.bn1", co)
            conv(f"{bp}.conv2.weight", co, co, 3)
            # A small residual branch keeps 97 stacked blocks from blowing up.
            _bn(specs, f"{bp}.bn2", co, 0.2)
            if j == 0 and li > 0:
                conv(f"{bp}.downsample.0.weight", co, cin, 1)
                _bn(specs, f"{bp}.downsample.1", co)
        ci = co
    feat = speaker_feat_dim(sp)
    specs += [("pooling.attention.0.weight", (128, feat, 1), ("normal", 1 / math.sqrt(feat))),
              ("pooling.attention.0.bias", (128,), ("const", 0.0))]
    _bn(specs, "pooling.attention.2", 128)
    specs += [("pooling.attention.3.weight", (feat, 128, 1), ("normal", 1 / math.sqrt(128))),
              ("pooling.attention.3.bias", (feat,), ("const", 0.0)),
              ("bottleneck.weight", (sp["embd_dim"], 2 * feat), ("normal", 1 / math.sqrt(2 * feat))),
              ("bottleneck.bias", (sp["embd_dim"],), ("const", 0.0))]
    return specs


def _lda_specs(sp: dict) -> list:
    return [("weight", (sp["lda_dim"], sp["embd_dim"]), ("normal", 1 / math.sqrt(sp["embd_dim"]))),
            ("bias", (sp["lda_dim"],), ("const", 0.0))]


def _materialize(groups: list, gen: torch.Generator, device, dtype) -> list:
    """Every spec of every group from one normal draw (cast to ``dtype``),
    scaled in place per tensor; constants and special draws after it."""
    numels = [math.prod(shape) for specs in groups for _, shape, init in specs if init[0] == "normal"]
    flat = torch.randn(sum(numels), generator=gen, dtype=dtype, device=device)
    out, pos = [], 0
    for specs in groups:
        sd = {}
        for name, shape, init in specs:
            if init[0] == "normal":
                n = math.prod(shape)
                t = flat[pos:pos + n].view(shape)
                pos += n
                t.mul_(init[1])
            elif init[0] == "const":
                t = torch.full(shape, float(init[1]), dtype=dtype, device=device)
            elif init[0] == "fn":
                t = init[1](gen, shape, device).to(dtype)
            else:  # "wnorm": the norm of a weight_v over every dim but the first
                v = sd[init[1]]
                t = v.float().reshape(v.shape[0], -1).norm(dim=1).reshape(shape).to(dtype)
            sd[name] = t
        out.append(sd)
    return out


@torch.no_grad()
def make_weights(doc: dict, seed: int, device) -> dict:
    """The four state dicts of ``doc`` (a configuration file's contents) at ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    cfg = doc["config"]
    (zonos,) = _materialize([spec.reference(doc).weight_specs(cfg, doc["phoneme_vocab_size"])], gen, device,
                            torch.bfloat16)
    # A line runs to its budget: EOS is never codebook 0's best token.
    zonos["heads.0.weight"][cfg["eos_token_id"]].zero_()
    dac, speaker, lda = _materialize([_dac_specs(doc["dac"]), _speaker_specs(doc["speaker"]),
                                      _lda_specs(doc["speaker"])], gen, device, torch.float32)
    return {"zonos": zonos, "dac": dac, "speaker": speaker, "lda": lda}


@torch.no_grad()
def checksum(weights: dict) -> str:
    """A digest of every tensor's bits in ``make_weights``'s result, made on the
    device: a server has to serve the weights that the reference makes again."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    sums = []
    for group in sorted(weights):
        for name in sorted(weights[group]):
            t = weights[group][name]
            v = t.contiguous().view(ints[t.element_size()]).to(torch.int64)
            sums.append(torch.stack([v.sum(), (v * v).sum()]))
    return hashlib.sha256(torch.stack(sums).cpu().numpy().tobytes()).hexdigest()


def make_voice(seed: int, index: int, seconds: float = 10.0, sr: int = 16000) -> np.ndarray:
    """A seeded 10 s voice: a gliding harmonic source under a few formants,
    syllable-rate amplitude and breath noise; int16 PCM."""
    rng = np.random.default_rng([int(seed) % (2**63), index])
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 240) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t + rng.uniform(0, 6)))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    formants = rng.uniform([500, 1200, 2400], [900, 2000, 3200])
    src = np.zeros(n)
    for h in range(1, 30):
        fh = h * f0
        amp = sum(np.exp(-((fh - f) / 180.0) ** 2) for f in formants) + 0.02
        src += amp * np.sin(h * phase) / h
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, 6))
    wav = env * src + 0.02 * rng.standard_normal(n)
    wav = 0.3 * wav / np.abs(wav).max()
    return (wav * 32767).astype(np.int16)
