"""Plain float32 reference of granite-4.0-h-micro's block stack as a Zonos TTS backbone.

Granite 4.0-H (``granitemoehybrid``; ibm-granite/granite-4.0-h-micro's
config.json) between Zonos-v0.1's prefix conditioner, nine code embeddings
and nine heads, on the state dict that ``benchmark.weights`` draws from
``weight_specs`` (mamba-ssm's names, as Zonos's hybrid checkpoints have
them). With r = ``residual_multiplier``, layer i is

    h  = x + r · mixer(rms(x))      Mamba-2, or GQA attention at ``attn_layer_idx``
    x' = h + r · mlp(rms(h))        a SiLU-gated MLP after every layer

The backbone's input, the conditioning prefix and the summed code embeddings
alike, is multiplied by ``embedding_multiplier``; after the last layer an
RMSNorm, the heads, and the logits divided by ``logits_scaling``. Attention
has no positional encoding (NoPE) and scores q·k · ``attention_multiplier``
(in place of 1/sqrt(head_dim)). The Mamba-2 mixer: in_proj (no bias) → z,
xBC, dt; a causal depthwise conv with its bias, SiLU; dt = softplus(dt +
dt_bias), unclamped (dt limit (0, ∞)); the SSD scan with A = -exp(A_log)
and the skip D; Granite's gated RMSNorm rms(y · silu(z)) · w over all
d_inner channels (one group); out_proj (no bias). Every norm's epsilon is
``norm_epsilon`` (1e-5), the gated norm's too.

Departures from Granite, each what the system is:

* the vocabulary: Zonos's nine DAC codebooks (embeddings of 1026 rows,
  summed, and nine untied heads of 1025), in place of 100,352 tied text
  tokens;
* the input: Zonos's LayerNorm'd conditioning prefix before the codes;
* the MLP's fc1 holds [y | gate] and computes y · silu(gate) (Zonos's
  order), where Granite's input_linear chunks [gate | up]: the same function
  under a permutation of random weights;
* the weights as served: int8 per output row (``bits=8``) for in_proj,
  out_proj, fc1, fc2 and the heads, and an int8 KV cache per (position, KV
  head), computed in float32 as ``reference/model.py`` computes them;
  ``bits=4`` is the control (int4 groups of 128, int4 KV), ``bits=None`` the
  float model with a float cache.

Computed in float32 with TF32 off (``check.run`` sets it), over the whole
sequence without a cache. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import model
from benchmark.reference.model import kv_quant, ssd_scan


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal GQA without positions: q [L, Hq, D], k/v [L, Hkv, D] → [L, Hq·D]."""
    n, hq, d = q.shape
    g = hq // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * scale
    causal = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v).reshape(n, hq * d)


def weight_specs(cfg: dict, phoneme_vocab: int) -> list:
    """Zonos-v0.1's embeddings, heads and prefix conditioner
    (``model.weight_specs``; the heads' std times ``logits_scaling``) around
    Granite's layers: RMSNorms without biases, every layer with an MLP, the
    Mamba-2 conv with a bias."""
    bb = cfg["backbone"]
    d = bb["d_model"]
    a, s = bb["attn_cfg"], bb["ssm_cfg"]
    hq, hkv = a["num_heads"], a["num_heads_kv"]
    dh = a.get("head_dim") or d // hq
    d_inner = s["expand"] * d
    nheads = d_inner // s["headdim"]
    gn = s["ngroups"] * s["d_state"]
    conv_dim = d_inner + 2 * gn
    # The heads at logits_scaling x Zonos's std: the logits / logits_scaling
    # then spread as the transformer's do, and EOS (a zero row in codebook 0,
    # ``weights.make_weights``) stays out of min-p's reach, as a trained
    # model's heads would be drawn large against the division.
    specs = [(n, shape, ("normal", init[1] * bb["logits_scaling"]) if n.startswith("heads.") else init)
             for n, shape, init in model.weight_specs(cfg, phoneme_vocab) if not n.startswith("backbone.")]
    attn_idx = set(bb["attn_layer_idx"])
    for i in range(bb["n_layer"]):
        base = f"backbone.layers.{i}"
        m = f"{base}.mixer"
        specs.append((f"{base}.norm.weight", (d,), ("const", 1.0)))
        if i in attn_idx:
            f = bb["attn_mlp_d_intermediate"]
            specs += [(f"{m}.in_proj.weight", ((hq + 2 * hkv) * dh, d), ("normal", 1 / math.sqrt(d))),
                      (f"{m}.out_proj.weight", (d, hq * dh), ("normal", 1 / math.sqrt(hq * dh)))]
        else:
            f = bb["d_intermediate"]
            specs += [
                (f"{m}.in_proj.weight", (2 * d_inner + 2 * gn + nheads, d), ("normal", 1 / math.sqrt(d))),
                (f"{m}.conv1d.weight", (conv_dim, 1, s["d_conv"]), ("normal", 0.2)),
                (f"{m}.conv1d.bias", (conv_dim,), ("normal", 0.1)),
                (f"{m}.dt_bias", (nheads,), ("fn", model._dt_bias)),
                (f"{m}.A_log", (nheads,), ("fn", model._a_log)),
                (f"{m}.D", (nheads,), ("const", 1.0)),
                (f"{m}.norm.weight", (d_inner,), ("const", 1.0)),
                (f"{m}.out_proj.weight", (d, d_inner), ("normal", 1 / math.sqrt(d_inner))),
            ]
        specs += [(f"{base}.norm2.weight", (d,), ("const", 1.0)),
                  (f"{base}.mlp.fc1.weight", (2 * f, d), ("normal", 1 / math.sqrt(d))),
                  (f"{base}.mlp.fc2.weight", (d, f), ("normal", 1 / math.sqrt(f)))]
    specs.append(("backbone.norm_f.weight", (d,), ("const", 1.0)))
    return specs


class Reference(model.ZonosReference):
    """The configuration's model on one device, weights dequantized layer by
    layer; the conditioning and the code embeddings are Zonos-v0.1's."""

    def __init__(self, doc: dict, sd: dict, device, bits: int | None = 8):
        super().__init__(doc, sd, device, bits)
        self.eps = self.bb["norm_epsilon"]

    def w(self, name: str) -> torch.Tensor:
        if self.bits is None:
            return self.sd[name].to(self.device).float()
        return super().w(name)

    def _rms(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps) * self.w(name)

    def _mlp(self, base: str, x: torch.Tensor) -> torch.Tensor:
        y, gate = (x @ self.w(f"{base}.mlp.fc1.weight").T).chunk(2, dim=-1)
        return (y * F.silu(gate)) @ self.w(f"{base}.mlp.fc2.weight").T

    def _attn(self, base: str, x: torch.Tensor) -> torch.Tensor:
        a = self.bb["attn_cfg"]
        hq, hkv = a["num_heads"], a["num_heads_kv"]
        dh = a.get("head_dim") or self.bb["d_model"] // hq
        q, k, v = (x @ self.w(f"{base}.mixer.in_proj.weight").T).split([hq * dh, hkv * dh, hkv * dh], dim=-1)
        q, k, v = q.reshape(-1, hq, dh), k.reshape(-1, hkv, dh), v.reshape(-1, hkv, dh)
        if self.bits is not None:
            k, v = kv_quant(k, self.bits), kv_quant(v, self.bits)
        return attention(q, k, v, self.bb["attention_multiplier"]) @ self.w(f"{base}.mixer.out_proj.weight").T

    def _mamba(self, base: str, x: torch.Tensor) -> torch.Tensor:
        s = self.bb["ssm_cfg"]
        d_inner = s["expand"] * self.bb["d_model"]
        nh, gn = d_inner // s["headdim"], s["ngroups"] * s["d_state"]
        m = f"{base}.mixer"
        z, xbc, dt = (x @ self.w(f"{m}.in_proj.weight").T).split([d_inner, d_inner + 2 * gn, nh], dim=-1)
        n = x.shape[0]
        xbc = F.conv1d(xbc.T[None], self.w(f"{m}.conv1d.weight"), self.w(f"{m}.conv1d.bias"),
                       padding=s["d_conv"] - 1, groups=xbc.shape[1])[0, :, :n].T
        xs, B, C = F.silu(xbc).split([d_inner, gn, gn], dim=-1)
        xs = xs.reshape(n, nh, s["headdim"])
        rep = nh // s["ngroups"]
        B = B.reshape(n, s["ngroups"], s["d_state"]).repeat_interleave(rep, dim=1)
        C = C.reshape(n, s["ngroups"], s["d_state"]).repeat_interleave(rep, dim=1)
        dt = F.softplus(dt + self.w(f"{m}.dt_bias"))
        y = ssd_scan(xs, dt, -torch.exp(self.w(f"{m}.A_log")), B, C)
        y = (y + xs * self.w(f"{m}.D")[None, :, None]).reshape(n, d_inner)
        return self._rms(y * F.silu(z), f"{m}.norm.weight") @ self.w(f"{m}.out_proj.weight").T

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The final RMSNorm's output over the backbone's input x [L, D]."""
        r = self.bb["residual_multiplier"]
        attn_idx = set(self.bb["attn_layer_idx"])
        x = x * self.bb["embedding_multiplier"]
        for i in range(self.bb["n_layer"]):
            base = f"backbone.layers.{i}"
            h = self._rms(x, f"{base}.norm.weight")
            x = x + r * (self._attn(base, h) if i in attn_idx else self._mamba(base, h))
            x = x + r * self._mlp(base, self._rms(x, f"{base}.norm2.weight"))
        return self._rms(x, "backbone.norm_f.weight")

    def guided_logits(self, cond: torch.Tensor, delayed: torch.Tensor, cfg_scale: float) -> torch.Tensor:
        """Logits [O, n_q, V] predicting delayed positions 1..O from the prefix
        cond [2, Lc, D] and delayed[:, :O], each divided by ``logits_scaling``,
        then guided (cond and uncond rows)."""
        lc = cond.shape[1]
        emb = self.embed(delayed)
        heads = torch.cat([self.w(f"heads.{k}.weight") for k in range(self.n_q)])  # [n_q·V, D]
        out = []
        for row in range(2):
            h = self.hidden(torch.cat([cond[row], emb]))[lc: lc + delayed.shape[1]]
            out.append((h @ heads.T / self.bb["logits_scaling"]).reshape(h.shape[0], self.n_q, -1))
        return out[1] + (out[0] - out[1]) * cfg_scale
