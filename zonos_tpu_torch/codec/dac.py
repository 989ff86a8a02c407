"""Descript Audio Codec (44.1 kHz), decoder half (port of ``zonos_tpu/codec/dac.py``).

Residual-VQ ``from_codes`` (9 codebooks of dim 8 into a 1024-d latent) and
the transposed-conv decoder with upsampling ratios (8, 8, 4, 2) → hop 512.
The public functions keep the JAX package's channels-last [B, T, C] layout;
inside ``decoder_forward`` the activations run channels-first, PyTorch's
convolution layout, and are transposed once on the way in. Weights are in
PyTorch's layout: conv [Cout, Cin, K], conv-transpose [Cin, Cout, K]
(``bridge.dac_params_from_jax`` converts the JAX ones). The convolutions are
plain ``torch.nn.functional`` calls: JAX leaves them to XLA too.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from zonos_tpu_torch import resolve_device
from zonos_tpu_torch.config import DACConfig


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
# Decoder / quantizer
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


def quantizer_from_codes(params: dict, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """codes [B, n_q, T] → latent z [B, T, hidden] (HF from_codes semantics)."""
    cb = params["codebooks"].to(dtype)  # [n_q, V, d]
    n_q = cb.shape[0]
    emb = torch.stack([cb[i][codes[:, i].long()] for i in range(n_q)], dim=1)  # [B, n_q, T, d]
    z = torch.einsum("bqtd,qdh->bth", emb, params["out_proj_w"].to(dtype))
    return z + params["out_proj_b"].sum(dim=0).to(dtype)


def init_dac_params(generator: torch.Generator, cfg: DACConfig = DACConfig(), dtype=torch.float32,
                    device=None) -> dict:
    """Random decoder + quantizer params with the exact shapes of descript/dac_44khz.

    Conv taps are N(0, 0.02²) clipped at ±2σ (JAX draws them truncated at
    ±2σ); biases zero, snake α one. No pretrained weights are loaded.
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
    return {"decoder": decoder, "quantizer": quantizer}


def _bucket(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class DACAutoencoder:
    """Decoder handle: codes → 44.1 kHz PCM, padded to a frame bucket as in JAX."""

    def __init__(self, params: dict | None = None, cfg: DACConfig = DACConfig(), dtype=torch.bfloat16,
                 frame_bucket: int = 128, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.config = cfg
        self.dtype = dtype
        self.frame_bucket = frame_bucket
        self.sampling_rate = cfg.sampling_rate
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_dac_params(gen, cfg, dtype=torch.float32, device=self.device)
        self.params = params

    @torch.no_grad()
    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        z = quantizer_from_codes(self.params["quantizer"], codes, dtype=self.dtype)
        return decoder_forward(self.params["decoder"], z.to(self.dtype), self.config.upsampling_ratios).float()

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
