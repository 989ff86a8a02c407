"""Plain float32 reference of descript/dac_44khz's decoder and of the
ResNet293-SimAM-ASP speaker tower with its LDA, from the state dicts that
``benchmark.weights`` makes (the published names). ``fp8=True`` is the
codec's control: every convolution's input and weight rounded to float8
(e4m3, one scale per tensor), the precision below the bf16 the configuration
serves the codec in. Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _wn(sd: dict, prefix: str) -> torch.Tensor:
    """A weight-normed conv's weight: v scaled to norm g over every dim but the first."""
    v, g = sd[f"{prefix}.weight_v"].float(), sd[f"{prefix}.weight_g"].float()
    return v * (g / v.reshape(v.shape[0], -1).norm(dim=1).reshape(g.shape))


class DACReference:
    def __init__(self, doc: dict, sd: dict, device, fp8: bool = False):
        self.dac, self.sd, self.device, self.fp8 = doc["dac"], sd, device, fp8

    def _conv(self, x, prefix, transpose=False, **kw):
        w = _wn(self.sd, prefix).to(self.device)
        b = self.sd[f"{prefix}.bias"].to(self.device).float()
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return (F.conv_transpose1d if transpose else F.conv1d)(x, w, b, **kw)

    def _snake(self, x, name):
        a = self.sd[name].to(self.device).float().reshape(1, -1, 1)
        return x + torch.sin(a * x).square() / (a + 1e-9)

    def _res(self, p, x, dil):
        y = self._conv(self._snake(x, f"{p}.snake1.alpha"), f"{p}.conv1", dilation=dil, padding=3 * dil)
        y = self._conv(self._snake(y, f"{p}.snake2.alpha"), f"{p}.conv2")
        trim = (x.shape[-1] - y.shape[-1]) // 2
        return (x[..., trim:-trim] if trim > 0 else x) + y

    @torch.no_grad()
    def decode(self, codes: np.ndarray) -> torch.Tensor:
        """Codes [n_q, T] → waveform [T · hop] in (-1, 1)."""
        c = torch.as_tensor(np.asarray(codes, np.int64), device=self.device)
        z = 0
        for i in range(c.shape[0]):
            q = f"quantizer.quantizers.{i}"
            e = self.sd[f"{q}.codebook.weight"].to(self.device).float()[c[i]]  # [T, d]
            w = _wn(self.sd, f"{q}.out_proj").to(self.device)[:, :, 0]  # [hidden, d]
            z = z + e @ w.T + self.sd[f"{q}.out_proj.bias"].to(self.device).float()
        h = self._conv(z.T[None], "decoder.conv1", padding=3)
        for i, stride in enumerate(self.dac["upsampling_ratios"]):
            b = f"decoder.block.{i}"
            h = self._snake(h, f"{b}.snake1.alpha")
            h = self._conv(h, f"{b}.conv_t1", transpose=True, stride=stride, padding=math.ceil(stride / 2))
            for r, dil in enumerate((1, 3, 9)):
                h = self._res(f"{b}.res_unit{r + 1}", h, dil)
        h = self._snake(h, "decoder.snake1.alpha")
        return torch.tanh(self._conv(h, "decoder.conv2", padding=3))[0, 0]


def _mel_filterbank(n_freqs: int, n_mels: int, sr: int) -> np.ndarray:
    """HTK-scale triangular filters, no normalization (torchaudio's defaults)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, sr // 2, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    slopes = f_pts[None, :] - freqs[:, None]
    diff = np.diff(f_pts)
    down = -slopes[:, :-2] / diff[None, :-1]
    up = slopes[:, 2:] / diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


class SpeakerReference:
    """16 kHz wav → log-mel (n_fft 512, 400-sample Hann, hop 160, 80 bands,
    log1p, mean over time removed) → ResNet293 with SimAM → attentive
    statistics pooling → bottleneck → LDA, in float32."""

    def __init__(self, doc: dict, sd: dict, lda: dict, device):
        self.sp, self.sd, self.lda, self.device = doc["speaker"], sd, lda, device

    def _bn(self, x, name, eps=1e-5):
        g = lambda k: self.sd[f"{name}.{k}"].to(self.device).float()  # noqa: E731
        scale = g("weight") / torch.sqrt(g("running_var") + eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.reshape(shape) + (g("bias") - g("running_mean") * scale).reshape(shape)

    def _conv(self, x, name, stride=1, padding=1):
        return F.conv2d(x, self.sd[name].to(self.device).float(), stride=stride, padding=padding)

    @staticmethod
    def _simam(x, lam=1e-4):
        n = x.shape[2] * x.shape[3] - 1
        d = (x - x.mean(dim=(2, 3), keepdim=True)).square()
        return x * torch.sigmoid(d / (4 * (d.sum(dim=(2, 3), keepdim=True) / n + lam)) + 0.5)

    def fbank(self, wav: torch.Tensor) -> torch.Tensor:
        n_fft, win, hop = 512, 400, 160
        x = F.pad(wav[None, None], (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
        window = torch.as_tensor(np.hanning(win + 1)[:-1], dtype=torch.float32, device=self.device)
        window = F.pad(window, ((n_fft - win) // 2, n_fft - win - (n_fft - win) // 2))
        power = torch.fft.rfft(x.unfold(0, n_fft, hop) * window, dim=-1).abs().square()
        fb = torch.as_tensor(_mel_filterbank(n_fft // 2 + 1, self.sp["acoustic_dim"], self.sp["sample_rate"]),
                             device=self.device)
        out = torch.log1p(power @ fb).T
        return out - out.mean(dim=1, keepdim=True)

    @torch.no_grad()
    def embed(self, pcm16: np.ndarray) -> torch.Tensor:
        """int16 16 kHz mono → the 128-d LDA embedding. The wav is zero-padded
        (or cut) to (frames - 1) · 160 samples with frames a multiple of 256,
        as the serving tower does before its features."""
        wav = pcm16.astype(np.float32) / 32768.0
        frames = 1 + wav.shape[0] // 160
        bucket = max(256, -(-frames // 256) * 256)
        target = (bucket - 1) * 160
        wav = wav[:target] if wav.shape[0] >= target else np.pad(wav, (0, target - wav.shape[0]))
        h = self.fbank(torch.as_tensor(wav, device=self.device))[None, None]
        h = torch.relu(self._bn(self._conv(h, "front.conv1.weight"), "front.bn1"))
        for li, n_blocks in enumerate(self.sp["layer_plan"]):
            for j in range(n_blocks):
                bp = f"front.layer{li + 1}.{j}"
                stride = 2 if (j == 0 and li > 0) else 1
                out = torch.relu(self._bn(self._conv(h, f"{bp}.conv1.weight", stride=stride), f"{bp}.bn1"))
                out = self._simam(self._bn(self._conv(out, f"{bp}.conv2.weight"), f"{bp}.bn2"))
                if f"{bp}.downsample.0.weight" in self.sd:
                    h = self._bn(self._conv(h, f"{bp}.downsample.0.weight", stride=stride, padding=0),
                                 f"{bp}.downsample.1")
                h = torch.relu(out + h)
        b, c, hh, w = h.shape
        feat = h.reshape(b, c * hh, w)
        g = lambda k: self.sd[k].to(self.device).float()  # noqa: E731
        a = torch.einsum("bfw,kf->bkw", feat, g("pooling.attention.0.weight")[:, :, 0]) + \
            g("pooling.attention.0.bias")[:, None]
        a = self._bn(torch.relu(a), "pooling.attention.2")
        a = torch.einsum("bkw,fk->bfw", a, g("pooling.attention.3.weight")[:, :, 0]) + \
            g("pooling.attention.3.bias")[:, None]
        wgt = torch.softmax(a, dim=2)
        mu = (feat * wgt).sum(dim=2)
        sg = torch.sqrt(torch.clamp((feat.square() * wgt).sum(dim=2) - mu.square(), min=1e-5))
        emb = torch.cat([mu, sg], dim=1) @ g("bottleneck.weight").T + g("bottleneck.bias")
        return (emb @ self.lda["weight"].to(self.device).float().T + self.lda["bias"].to(self.device).float())[0]
