"""Descript Audio Codec (44.1 kHz) (port of ``zonos_tpu/codec/dac.py``).

The Snake-activated conv encoder with downsampling ratios (2, 4, 8, 8), the
residual VQ (9 codebooks of dim 8 over a 1024-d latent: ``quantizer_encode``
and ``quantizer_from_codes``) and the transposed-conv decoder with
upsampling ratios (8, 8, 4, 2) → hop 512. The public functions keep the JAX
package's channels-last [B, T, C] layout; inside ``encoder_forward`` and
``decoder_forward`` the activations run channels-first, PyTorch's
convolution layout, and are transposed once on the way in or out. Weights
are in PyTorch's layout: conv [Cout, Cin, K], conv-transpose [Cin, Cout, K]
(``bridge.dac_params_from_jax`` converts the JAX ones); the quantizer's
projections keep the JAX layout, in_proj [n_q, hidden, d] and out_proj
[n_q, d, hidden]. The encoder and the RVQ run in float32, as in JAX. The
convolutions are plain ``torch.nn.functional`` calls: JAX leaves them to XLA.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.nn.functional as F

from zonos_tpu_torch import resolve_device
from zonos_tpu_torch.audio.resample import resample_poly
from zonos_tpu_torch.config import DACConfig
from zonos_tpu_torch.utils import profiling

logger = logging.getLogger("zonos_tpu_torch")
HF_REPO_ID = "descript/dac_44khz"


# ---------------------------------------------------------------------------
# Primitive ops: channels-last public forms, channels-first internals
# ---------------------------------------------------------------------------

def _snake_ncw(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a = alpha.to(x.dtype)[None, :, None]
    return x + torch.sin(a * x).square() / (a + 1e-9)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation on [B, T, C]: x + sin²(αx)/α, α per channel."""
    a = alpha.to(x.dtype)
    return x + torch.sin(a * x).square() / (a + 1e-9)


def _conv_ncw(x, w, b, stride=1, dilation=1, padding=0):
    return F.conv1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation)


def _conv_t_ncw(x, w, b, stride, padding):
    return F.conv_transpose1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                              stride=stride, padding=padding)


def conv1d(x, w, b, stride: int = 1, dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """x [B, T, Cin], w [Cout, Cin, K] → [B, T', Cout]."""
    return _conv_ncw(x.transpose(1, 2), w, b, stride, dilation, padding).transpose(1, 2)


def conv_transpose1d(x, w, b, stride: int, padding: int) -> torch.Tensor:
    """x [B, T, Cin], w [Cin, Cout, K] → [B, (T-1)*stride - 2*padding + K, Cout]."""
    return _conv_t_ncw(x.transpose(1, 2), w, b, stride, padding).transpose(1, 2)


def _res_unit_ncw(p: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """Snake → dilated conv k7 → Snake → conv k1, centre-trimmed residual."""
    y = _snake_ncw(x, p["snake1"])
    y = _conv_ncw(y, p["conv1"]["w"], p["conv1"]["b"], dilation=dilation, padding=((7 - 1) * dilation) // 2)
    y = _snake_ncw(y, p["snake2"])
    y = _conv_ncw(y, p["conv2"]["w"], p["conv2"]["b"])
    trim = (x.shape[-1] - y.shape[-1]) // 2
    if trim > 0:
        x = x[..., trim:-trim]
    return x + y


# ---------------------------------------------------------------------------
# Decoder / encoder / quantizer
# ---------------------------------------------------------------------------

def decoder_forward(params: dict, z: torch.Tensor, ratios: tuple[int, ...]) -> torch.Tensor:
    """z [B, T, 1024] → waveform [B, T * hop] in (-1, 1)."""
    h = _conv_ncw(z.transpose(1, 2), params["conv1"]["w"], params["conv1"]["b"], padding=3)
    for blk, stride in zip(params["blocks"], ratios):
        h = _snake_ncw(h, blk["snake1"])
        h = _conv_t_ncw(h, blk["conv_t"]["w"], blk["conv_t"]["b"], stride=stride, padding=math.ceil(stride / 2))
        for i, dil in enumerate((1, 3, 9)):
            h = _res_unit_ncw(blk["res"][i], h, dil)
    h = _snake_ncw(h, params["snake_out"])
    h = _conv_ncw(h, params["conv2"]["w"], params["conv2"]["b"], padding=3)
    return torch.tanh(h)[:, 0]


def encoder_forward(params: dict, wav: torch.Tensor, ratios: tuple[int, ...]) -> torch.Tensor:
    """wav [B, T] → latent [B, T / hop, hidden]."""
    h = _conv_ncw(wav[:, None], params["conv1"]["w"], params["conv1"]["b"], padding=3)
    for blk, stride in zip(params["blocks"], ratios):
        for i, dil in enumerate((1, 3, 9)):
            h = _res_unit_ncw(blk["res"][i], h, dil)
        h = _snake_ncw(h, blk["snake1"])
        h = _conv_ncw(h, blk["conv"]["w"], blk["conv"]["b"], stride=stride, padding=math.ceil(stride / 2))
    h = _snake_ncw(h, params["snake_out"])
    return _conv_ncw(h, params["conv2"]["w"], params["conv2"]["b"], padding=1).transpose(1, 2)


def quantizer_encode(params: dict, z: torch.Tensor) -> torch.Tensor:
    """Latent z [B, T, hidden] → codes [B, n_q, T] int32 (residual VQ, eval mode):
    for each codebook in turn, the L2-normalised nearest neighbour of the
    residual's projection, then the chosen entry's reconstruction subtracted."""
    n_q = params["codebooks"].shape[0]
    residual = z.float()
    codes = []
    for i in range(n_q):
        lat = residual @ params["in_proj_w"][i].float() + params["in_proj_b"][i].float()
        cb = params["codebooks"][i].float()  # [V, d]
        e = lat / lat.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        c = cb / cb.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        # -(|e|^2 - 2 e.c + |c|^2), the JAX package's form; argmax over V
        dist = 2 * (e @ c.T) - (e * e).sum(-1, keepdim=True) + (c * c).sum(-1)[None, None]
        idx = dist.argmax(dim=-1)  # [B, T]
        codes.append(idx)
        residual = residual - (cb[idx] @ params["out_proj_w"][i].float() + params["out_proj_b"][i].float())
    return torch.stack(codes, dim=1).to(torch.int32)


def quantizer_from_codes(params: dict, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """codes [B, n_q, T] → latent z [B, T, hidden] (HF from_codes semantics)."""
    cb = params["codebooks"].to(dtype)  # [n_q, V, d]
    n_q = cb.shape[0]
    emb = torch.stack([cb[i][codes[:, i].long()] for i in range(n_q)], dim=1)  # [B, n_q, T, d]
    z = torch.einsum("bqtd,qdh->bth", emb, params["out_proj_w"].to(dtype))
    return z + params["out_proj_b"].sum(dim=0).to(dtype)


def init_dac_params(generator: torch.Generator, cfg: DACConfig = DACConfig(), dtype=torch.float32,
                    device=None) -> dict:
    """Random encoder, quantizer and decoder params with the exact shapes of
    descript/dac_44khz.

    Conv taps are N(0, 0.02²) clipped at ±2σ (JAX draws them truncated at
    ±2σ); biases zero, snake α one. No pretrained weights are loaded. The
    decoder and the quantizer's codebooks and out-projections are drawn first,
    then the encoder and the in-projections, so a seed gives the same decoder
    whether or not the encoder exists.
    """
    def normal(shape, std=0.02):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return w * std

    def conv(shape, cout):  # [Cout, Cin, K] for a conv, [Cin, Cout, K] for a transposed one
        w = torch.clamp(normal(shape, 1.0), -2.0, 2.0) * 0.02
        return {"w": w.to(dtype), "b": torch.zeros((cout,), dtype=dtype, device=device)}

    def ones(c):
        return torch.ones((c,), dtype=dtype, device=device)

    def res(c):
        return {"snake1": ones(c), "conv1": conv((c, c, 7), c), "snake2": ones(c), "conv2": conv((c, c, 1), c)}

    dh = cfg.decoder_hidden_size
    blocks = []
    for si, stride in enumerate(cfg.upsampling_ratios):
        cin, cout = dh // 2**si, dh // 2 ** (si + 1)
        blocks.append({"snake1": ones(cin), "conv_t": conv((cin, cout, 2 * stride), cout),
                       "res": [res(cout) for _ in range(3)]})
    c_last = dh // 2 ** len(cfg.upsampling_ratios)
    decoder = {
        "conv1": conv((dh, cfg.hidden_size, 7), dh),
        "blocks": blocks,
        "snake_out": ones(c_last),
        "conv2": conv((1, c_last, 7), 1),
    }
    quantizer = {
        "codebooks": normal((cfg.n_codebooks, cfg.codebook_size, cfg.codebook_dim)).to(dtype),
        "out_proj_w": normal((cfg.n_codebooks, cfg.codebook_dim, cfg.hidden_size)).to(dtype),
        "out_proj_b": torch.zeros((cfg.n_codebooks, cfg.hidden_size), dtype=dtype, device=device),
    }
    eh = cfg.encoder_hidden_size
    enc_blocks = []
    for si, stride in enumerate(cfg.downsampling_ratios):
        c = eh * 2**si
        enc_blocks.append({"res": [res(c) for _ in range(3)], "snake1": ones(c),
                           "conv": conv((2 * c, c, 2 * stride), 2 * c)})
    c_enc = eh * 2 ** len(cfg.downsampling_ratios)
    encoder = {
        "conv1": conv((eh, 1, 7), eh),
        "blocks": enc_blocks,
        "snake_out": ones(c_enc),
        "conv2": conv((cfg.hidden_size, c_enc, 3), cfg.hidden_size),
    }
    quantizer["in_proj_w"] = normal((cfg.n_codebooks, cfg.hidden_size, cfg.codebook_dim)).to(dtype)
    quantizer["in_proj_b"] = torch.zeros((cfg.n_codebooks, cfg.codebook_dim), dtype=dtype, device=device)
    return {"decoder": decoder, "encoder": encoder, "quantizer": quantizer}


# ---------------------------------------------------------------------------
# Pretrained weights: transformers' DacModel state dict
# ---------------------------------------------------------------------------

def _hf_conv_weight(sd, prefix: str) -> torch.Tensor:
    """A conv's folded weight: ``weight`` as saved, or folded from a weight-norm
    pair (``weight_g``/``weight_v``, or the parametrization's
    ``original0``/``original1``) as torch's weight_norm computes it (dim 0)."""
    for g, v in ((f"{prefix}.weight_g", f"{prefix}.weight_v"),
                 (f"{prefix}.parametrizations.weight.original0", f"{prefix}.parametrizations.weight.original1")):
        if g in sd and v in sd:
            return torch._weight_norm(torch.as_tensor(sd[v]).float(), torch.as_tensor(sd[g]).float(), 0)
    return torch.as_tensor(sd[f"{prefix}.weight"])


def convert_hf_dac_state_dict(sd, cfg: DACConfig = DACConfig(), dtype=torch.float32, device="cpu") -> dict:
    """A ``transformers.DacModel`` state dict (tensors or arrays) → the port's
    params. Conv weights are already in PyTorch's layout ([Cout, Cin, K],
    transposed convs [Cin, Cout, K]); weight-norm pairs are folded; the
    quantizer's 1x1-conv projections become in_proj [n_q, hidden, d] and
    out_proj [n_q, d, hidden]; snake α [1, C, 1] becomes [C]."""
    def arr(x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def conv(prefix):
        return {"w": arr(_hf_conv_weight(sd, prefix)), "b": arr(sd[f"{prefix}.bias"])}

    def alpha(key):
        return arr(sd[key]).reshape(-1)

    def res(p):
        return {"snake1": alpha(f"{p}.snake1.alpha"), "conv1": conv(f"{p}.conv1"),
                "snake2": alpha(f"{p}.snake2.alpha"), "conv2": conv(f"{p}.conv2")}

    decoder = {
        "conv1": conv("decoder.conv1"),
        "blocks": [{"snake1": alpha(f"decoder.block.{i}.snake1.alpha"), "conv_t": conv(f"decoder.block.{i}.conv_t1"),
                    "res": [res(f"decoder.block.{i}.res_unit{r + 1}") for r in range(3)]}
                   for i in range(len(cfg.upsampling_ratios))],
        "snake_out": alpha("decoder.snake1.alpha"),
        "conv2": conv("decoder.conv2"),
    }
    encoder = {
        "conv1": conv("encoder.conv1"),
        "blocks": [{"res": [res(f"encoder.block.{i}.res_unit{r + 1}") for r in range(3)],
                    "snake1": alpha(f"encoder.block.{i}.snake1.alpha"), "conv": conv(f"encoder.block.{i}.conv1")}
                   for i in range(len(cfg.downsampling_ratios))],
        "snake_out": alpha("encoder.snake1.alpha"),
        "conv2": conv("encoder.conv2"),
    }
    qs = [f"quantizer.quantizers.{i}" for i in range(cfg.n_codebooks)]
    quantizer = {
        "codebooks": torch.stack([arr(sd[f"{q}.codebook.weight"]) for q in qs]),
        "in_proj_w": torch.stack([arr(_hf_conv_weight(sd, f"{q}.in_proj"))[:, :, 0].T for q in qs]),
        "in_proj_b": torch.stack([arr(sd[f"{q}.in_proj.bias"]) for q in qs]),
        "out_proj_w": torch.stack([arr(_hf_conv_weight(sd, f"{q}.out_proj"))[:, :, 0].T for q in qs]),
        "out_proj_b": torch.stack([arr(sd[f"{q}.out_proj.bias"]) for q in qs]),
    }
    return {"decoder": decoder, "encoder": encoder, "quantizer": quantizer}


def load_cached_dac(cfg: DACConfig = DACConfig(), device="cpu") -> dict | None:
    """descript/dac_44khz's weights from the local hub cache (``utils.hub``),
    converted, or None when the cache does not hold them. A file that is
    there but cannot be read or converted raises."""
    from zonos_tpu_torch.utils.hub import cached_snapshot
    from zonos_tpu_torch.utils.safetensors_io import load_file

    snap = cached_snapshot(HF_REPO_ID, ("model.safetensors",))
    if snap is None:
        return None
    try:
        return convert_hf_dac_state_dict(load_file(str(snap / "model.safetensors")), cfg, device=device)
    except (KeyError, ValueError, RuntimeError) as e:
        raise ValueError(f"{snap / 'model.safetensors'}: not a {HF_REPO_ID} checkpoint this codec reads ({e!r})") from e


def _bucket(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class DACAutoencoder:
    """Codec handle on one device: ``preprocess`` + ``encode`` (wav → codes, f32)
    and ``decode`` (codes → 44.1 kHz PCM, padded to a frame bucket as in JAX).

    Without ``params`` it loads descript/dac_44khz from the local hub cache
    (``load_cached_dac``), else draws seeded random weights with a warning.
    """

    def __init__(self, params: dict | None = None, cfg: DACConfig = DACConfig(), dtype=torch.bfloat16,
                 frame_bucket: int = 128, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.config = cfg
        self.dtype = dtype
        self.frame_bucket = frame_bucket
        self.sampling_rate = cfg.sampling_rate
        if params is None:
            params = load_cached_dac(cfg, device=self.device)
        if params is None:
            logger.warning("no local %s checkpoint: the DAC uses random weights (seed %d)", HF_REPO_ID, seed)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_dac_params(gen, cfg, dtype=torch.float32, device=self.device)
        self.params = params

    def preprocess(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """Resample to the codec's rate and left-pad to a multiple of the hop (host numpy)."""
        wav = np.asarray(wav, np.float32)
        if sr != self.sampling_rate:
            wav = resample_poly(wav, sr, self.sampling_rate)
        hop = self.config.hop_length
        left_pad = math.ceil(wav.shape[-1] / hop) * hop - wav.shape[-1]
        return np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(left_pad, 0)])

    @torch.no_grad()
    def encode_device(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [B, T] (codec rate, a multiple of the hop) → codes [B, n_q, T / hop] int32 on the device."""
        z = encoder_forward(self.params["encoder"], wav.to(self.device, torch.float32),
                            self.config.downsampling_ratios)
        return quantizer_encode(self.params["quantizer"], z)

    def encode(self, wav) -> np.ndarray:
        """wav [B, T] or [B, 1, T] → codes [B, n_q, T / hop] int32 (numpy)."""
        wav = torch.as_tensor(np.atleast_2d(np.asarray(wav, np.float32)))
        if wav.dim() == 3:
            wav = wav[:, 0]
        return self.encode_device(wav).cpu().numpy()

    @torch.no_grad()
    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        z = quantizer_from_codes(self.params["quantizer"], codes, dtype=self.dtype)
        return decoder_forward(self.params["decoder"], z.to(self.dtype), self.config.upsampling_ratios).float()

    @profiling.traced("codec.decode")
    def decode_device(self, codes, to_int16: bool = False) -> torch.Tensor:
        """[B, n_q, T] → PCM [B, T * hop] on the device: float32 in (-1, 1), or
        int16 (clip to ±32767 and truncate, as the JAX package does)."""
        codes = torch.as_tensor(codes)
        t = codes.shape[-1]
        padded = F.pad(codes.to(self.device, torch.int32), (0, _bucket(t, self.frame_bucket) - t))
        wav = self._decode(padded)[:, : t * self.config.hop_length]
        if to_int16:
            wav = torch.clamp(wav * 32767.0, -32767.0, 32767.0).to(torch.int16)
        return wav

    def decode(self, codes) -> np.ndarray:
        """codes [B, n_q, T] → float32 waveform [B, 1, T * hop] (numpy)."""
        return self.decode_device(codes).cpu().numpy()[:, None, :]

    def decode_to_int16(self, codes) -> np.ndarray:
        """codes [B, n_q, T] → the first row's 16-bit PCM, [T * hop, 1] (clipped
        to ±32767 and truncated on the device, as ``decode_device`` does)."""
        return self.decode_device(codes, to_int16=True).cpu().numpy()[0][:, None]
