"""Plain float32 reference of Zonos-v0.1 (transformer and Mamba2 hybrid).

Written from the published architecture, on the reference state dict that
``benchmark.weights`` makes from ``weight_specs``: the prefix conditioner, the backbone over the
whole sequence without a cache, the nine heads, classifier-free guidance and
the serving sampler's logit rules (EOS only in codebook 0 at -log 2 after the
first frame, the repetition penalty over the last two delayed positions).
The configuration serves int8 weights (one scale per output channel) and an
int8 KV cache (one scale per position and KV head); the reference computes
those quantized values in float32 with TF32 off. ``bits=4`` is the control:
the same model with group-wise int4 weights (groups of 128 along the input)
and an int4 KV cache. Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

QUANTIZED = ("in_proj.weight", "out_proj.weight", "fc1.weight", "fc2.weight")


def fake_quant(w: torch.Tensor, bits: int, group: int = 128) -> torch.Tensor:
    """Symmetric weight quantization of a [out, in] matrix, returned as float32
    values: int8 per output row, int4 per (output row, group of inputs)."""
    w = w.float()
    if bits == 8:
        amax = w.abs().amax(dim=1, keepdim=True)
        s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        return torch.clamp(torch.round(w / s), -127, 127) * s
    n_out, n_in = w.shape
    g = min(group, n_in)
    wg = w.reshape(n_out, n_in // g, g)
    amax = wg.abs().amax(dim=2, keepdim=True)
    s = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    return (torch.clamp(torch.round(wg / s), -7, 7) * s).reshape(n_out, n_in)


def kv_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x [L, H, D] quantized per (position, head) over D, as float32 values."""
    top = 127.0 if bits == 8 else 7.0
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return torch.clamp(torch.round(x / s), -top, top) * s


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w.float(), None if b is None else b.float(), eps)


def rope(x: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on x [L, H, D], dimensions rotating as (even, odd) pairs."""
    n, _, d = x.shape
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device)[: d // 2] / d))
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * inv  # [L, D/2]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).reshape(x.shape)


def attention(q, k, v):
    """Causal grouped-query attention: q [L, Hq, D], k/v [L, Hkv, D] → [L, Hq·D]."""
    n, hq, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    causal = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v).reshape(n, hq * d)


def ssd_scan(x, dt, A, B, C, chunk: int = 64):
    """Mamba2's selective state space over a sequence, exact in float32:
    state_t = exp(dt_t A) state_{t-1} + dt_t B_t x_t^T, y_t = C_t state_t.
    x [L, H, P], dt [L, H], A [H], B/C [L, H, N] → y [L, H, P]. Computed a
    chunk at a time: inside a chunk through the decay matrix, across chunks
    through the carried state."""
    n, h, p = x.shape
    y = torch.empty_like(x)
    state = torch.zeros((h, B.shape[-1], p), dtype=torch.float32, device=x.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        a = dt[lo:hi] * A  # [T, H]
        cum = torch.cumsum(a, dim=0)
        t = hi - lo
        seg = cum[:, None, :] - cum[None, :, :]  # [T(t), T(s), H]
        tri = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(torch.where(tri[..., None], seg, torch.full_like(seg, float("-inf"))))
        xdt = x[lo:hi] * dt[lo:hi, :, None]
        scores = torch.einsum("thn,shn->tsh", C[lo:hi], B[lo:hi]) * decay
        y[lo:hi] = torch.einsum("tsh,shp->thp", scores, xdt) + \
            torch.einsum("thn,hnp->thp", C[lo:hi], state) * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[-1][None, :] - cum)  # [T, H]
        state = state * torch.exp(cum[-1])[:, None, None] + torch.einsum("thn,th,thp->hnp", B[lo:hi], to_end, xdt)
    return y


def weight_specs(cfg: dict, phoneme_vocab: int) -> list:
    """The reference state dict's tensors as ``benchmark.weights`` makes them:
    (name, shape, init) entries, init ("normal", std), ("const", value) or
    ("fn", callable(generator, shape, device) -> float32 tensor)."""
    bb = cfg["backbone"]
    d = bb["d_model"]
    n_q = cfg["codebook_dimension"]
    hq, hkv = bb["attn_cfg"]["num_heads"], bb["attn_cfg"]["num_heads_kv"]
    dh = bb["attn_cfg"].get("head_dim") or d // hq
    head_vocab = cfg["eos_token_id"] + 1
    specs = []
    for k in range(n_q):
        specs.append((f"embeddings.{k}.weight", (cfg["masked_token_id"] + 1, d), ("normal", 1.0)))
    for k in range(n_q):
        specs.append((f"heads.{k}.weight", (head_vocab, d), ("normal", 4.0 / math.sqrt(d))))

    def norm(prefix):
        return [(f"{prefix}.weight", (d,), ("const", 1.0)), (f"{prefix}.bias", (d,), ("const", 0.0))]

    def mlp(base, f):
        return norm(f"{base}.norm2") + [(f"{base}.mlp.fc1.weight", (2 * f, d), ("normal", 1 / math.sqrt(d))),
                                        (f"{base}.mlp.fc2.weight", (d, f), ("normal", 1 / math.sqrt(f)))]

    ssm = bb.get("ssm_cfg")
    attn_idx = set(bb["attn_layer_idx"])
    for i in range(bb["n_layer"]):
        base = f"backbone.layers.{i}"
        m = f"{base}.mixer"
        specs += norm(f"{base}.norm")
        if not ssm or i in attn_idx:
            specs += [(f"{m}.in_proj.weight", ((hq + 2 * hkv) * dh, d), ("normal", 1 / math.sqrt(d))),
                      (f"{m}.out_proj.weight", (d, hq * dh), ("normal", 1 / math.sqrt(hq * dh)))]
            specs += mlp(base, bb["attn_mlp_d_intermediate"])
            continue
        d_inner = ssm["expand"] * d
        nheads = d_inner // ssm["headdim"]
        conv_dim = d_inner + 2 * ssm["ngroups"] * ssm["d_state"]
        d_in_proj = 2 * d_inner + 2 * ssm["ngroups"] * ssm["d_state"] + nheads
        specs += [
            (f"{m}.in_proj.weight", (d_in_proj, d), ("normal", 1 / math.sqrt(d))),
            (f"{m}.conv1d.weight", (conv_dim, 1, ssm["d_conv"]), ("normal", 0.2)),
            (f"{m}.conv1d.bias", (conv_dim,), ("const", 0.0)),
            (f"{m}.dt_bias", (nheads,), ("fn", _dt_bias)),
            (f"{m}.A_log", (nheads,), ("fn", _a_log)),
            (f"{m}.D", (nheads,), ("const", 1.0)),
            (f"{m}.norm.weight", (d_inner,), ("const", 1.0)),
            (f"{m}.out_proj.weight", (d, d_inner), ("normal", 1 / math.sqrt(d_inner))),
        ]
        if bb["d_intermediate"]:
            specs += mlp(base, bb["d_intermediate"])
    specs += norm("backbone.norm_f")

    for i, c in enumerate(cfg["prefix_conditioner"]["conditioners"]):
        base = f"prefix_conditioner.conditioners.{i}"
        if c["type"] == "EspeakPhonemeConditioner":
            specs.append((f"{base}.phoneme_embedder.weight", (phoneme_vocab, d), ("normal", 1.0)))
        elif c["type"] == "FourierConditioner":
            specs.append((f"{base}.weight", (d // 2, c["input_dim"]), ("normal", c["std"])))
        elif c["type"] == "IntegerConditioner":
            specs.append((f"{base}.int_embedder.weight", (int(c["max_val"]) - int(c["min_val"]) + 1, d),
                          ("normal", 1.0)))
        if c["projection"] == "linear":
            cd = c["cond_dim"] or d
            specs += [(f"{base}.project.weight", (d, cd), ("normal", 1 / math.sqrt(cd))),
                      (f"{base}.project.bias", (d,), ("const", 0.0))]
        if c["uncond_type"] == "learned":
            specs.append((f"{base}.uncond_vector", (d,), ("normal", 1.0)))
    specs += [("prefix_conditioner.norm.weight", (d,), ("const", 1.0)),
              ("prefix_conditioner.norm.bias", (d,), ("const", 0.0))]
    return specs


def _dt_bias(gen, shape, device):
    """Mamba2's dt init: log-uniform in [0.001, 0.1], stored as its inverse softplus."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return dt + torch.log(-torch.expm1(-dt))


def _a_log(gen, shape, device):
    return torch.log(torch.linspace(1.0, 16.0, shape[0], dtype=torch.float32, device=device))


class ZonosReference:
    """The configuration's model on one device, weights dequantized layer by layer."""

    def __init__(self, doc: dict, sd: dict, device, bits: int = 8):
        self.doc, self.cfg, self.sd, self.device, self.bits = doc, doc["config"], sd, device, bits
        self.bb = self.cfg["backbone"]
        self.n_q = self.cfg["codebook_dimension"]

    def w(self, name: str) -> torch.Tensor:
        t = self.sd[name].to(self.device)
        if name.endswith(QUANTIZED) or name.startswith("heads."):
            return fake_quant(t, self.bits)
        return t.float()

    # -- conditioning -------------------------------------------------------

    def conditioning(self, phoneme_ids, values: dict) -> torch.Tensor:
        """[2, Lc, D]: the conditional prefix (``values`` by conditioner name;
        a missing name takes its learned unconditional vector) and the
        unconditional one (the phonemes alone)."""
        rows = []
        for given in (values, {}):
            parts = []
            for i, c in enumerate(self.cfg["prefix_conditioner"]["conditioners"]):
                base = f"prefix_conditioner.conditioners.{i}"
                name = c["name"]
                if c["type"] == "EspeakPhonemeConditioner":
                    ids = torch.as_tensor(np.asarray(phoneme_ids, np.int64), device=self.device)
                    parts.append(self.w(f"{base}.phoneme_embedder.weight")[ids])
                    continue
                if name not in given:
                    parts.append(self.w(f"{base}.uncond_vector")[None])
                    continue
                x = torch.as_tensor(np.asarray(given[name], np.float32).reshape(1, -1), device=self.device)
                if c["type"] == "FourierConditioner":
                    x = (x - c["min_val"]) / (c["max_val"] - c["min_val"])
                    f = 2 * math.pi * x @ self.w(f"{base}.weight").T
                    cond = torch.cat([torch.cos(f), torch.sin(f)], dim=-1)
                elif c["type"] == "IntegerConditioner":
                    cond = self.w(f"{base}.int_embedder.weight")[x.long()[:, 0] - int(c["min_val"])]
                else:  # Passthrough
                    cond = x
                if c["projection"] == "linear":
                    cond = cond @ self.w(f"{base}.project.weight").T + self.w(f"{base}.project.bias")
                parts.append(cond)
            out = torch.cat(parts, dim=0)
            rows.append(layer_norm(out, self.w("prefix_conditioner.norm.weight"),
                                   self.w("prefix_conditioner.norm.bias")))
        return torch.stack(rows)

    # -- backbone -----------------------------------------------------------

    def _mlp(self, base: str, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm(x, self.w(f"{base}.norm2.weight"), self.w(f"{base}.norm2.bias"))
        y, gate = (h @ self.w(f"{base}.mlp.fc1.weight").T).chunk(2, dim=-1)
        return x + (y * F.silu(gate)) @ self.w(f"{base}.mlp.fc2.weight").T

    def _attn(self, base: str, x: torch.Tensor, rotary: bool) -> torch.Tensor:
        a = self.bb["attn_cfg"]
        hq, hkv = a["num_heads"], a["num_heads_kv"]
        dh = a.get("head_dim") or self.bb["d_model"] // hq
        h = layer_norm(x, self.w(f"{base}.norm.weight"), self.w(f"{base}.norm.bias"))
        qkv = h @ self.w(f"{base}.mixer.in_proj.weight").T
        q, k, v = qkv.split([hq * dh, hkv * dh, hkv * dh], dim=-1)
        q, k, v = q.reshape(-1, hq, dh), k.reshape(-1, hkv, dh), v.reshape(-1, hkv, dh)
        if rotary:
            q, k = rope(q), rope(k)
        k, v = kv_quant(k, self.bits), kv_quant(v, self.bits)
        return x + attention(q, k, v) @ self.w(f"{base}.mixer.out_proj.weight").T

    def _mamba(self, base: str, x: torch.Tensor) -> torch.Tensor:
        s = self.bb["ssm_cfg"]
        d = self.bb["d_model"]
        d_inner = s["expand"] * d
        nh, gn = d_inner // s["headdim"], s["ngroups"] * s["d_state"]
        m = f"{base}.mixer"
        h = layer_norm(x, self.w(f"{base}.norm.weight"), self.w(f"{base}.norm.bias"))
        z, xbc, dt = (h @ self.w(f"{m}.in_proj.weight").T).split([d_inner, d_inner + 2 * gn, nh], dim=-1)
        conv_w = self.w(f"{m}.conv1d.weight")  # [C, 1, K]
        xbc = F.silu(F.conv1d(xbc.T[None], conv_w, self.w(f"{m}.conv1d.bias"), padding=s["d_conv"] - 1,
                              groups=xbc.shape[1])[0, :, : xbc.shape[0]].T)
        xs, B, C = xbc.split([d_inner, gn, gn], dim=-1)
        n = x.shape[0]
        xs = xs.reshape(n, nh, s["headdim"])
        rep = nh // s["ngroups"]
        B = B.reshape(n, s["ngroups"], s["d_state"]).repeat_interleave(rep, dim=1)
        C = C.reshape(n, s["ngroups"], s["d_state"]).repeat_interleave(rep, dim=1)
        dt = F.softplus(dt + self.w(f"{m}.dt_bias"))
        y = ssd_scan(xs, dt, -torch.exp(self.w(f"{m}.A_log")), B, C)
        y = (y + xs * self.w(f"{m}.D")[None, :, None]).reshape(n, d_inner)
        g = y * F.silu(z)
        g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + 1e-5) * self.w(f"{m}.norm.weight")
        return x + g @ self.w(f"{m}.out_proj.weight").T

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """Final-normed hidden states of the backbone over x [L, D]."""
        ssm = self.bb.get("ssm_cfg")
        attn_idx = set(self.bb["attn_layer_idx"])
        for i in range(self.bb["n_layer"]):
            base = f"backbone.layers.{i}"
            if not ssm or i in attn_idx:
                x = self._attn(base, x, rotary=not ssm)
                x = self._mlp(base, x)
            else:
                x = self._mamba(base, x)
                if self.bb["d_intermediate"]:
                    x = self._mlp(base, x)
        return layer_norm(x, self.w("backbone.norm_f.weight"), self.w("backbone.norm_f.bias"))

    # -- logits -------------------------------------------------------------

    def embed(self, delayed: torch.Tensor) -> torch.Tensor:
        """delayed codes [n_q, O] → the sum of the codebooks' embeddings [O, D]."""
        return sum(self.w(f"embeddings.{k}.weight")[delayed[k].long()] for k in range(self.n_q))

    def guided_logits(self, cond: torch.Tensor, delayed: torch.Tensor, cfg_scale: float) -> torch.Tensor:
        """Logits [O, n_q, V] predicting delayed positions 1..O from the prefix
        cond [2, Lc, D] and delayed[:, :O], guided (cond and uncond rows)."""
        lc = cond.shape[1]
        emb = self.embed(delayed)
        heads = torch.cat([self.w(f"heads.{k}.weight") for k in range(self.n_q)])  # [n_q·V, D]
        out = []
        for row in range(2):
            h = self.hidden(torch.cat([cond[row], emb]))[lc: lc + delayed.shape[1]]
            out.append((h @ heads.T).reshape(h.shape[0], self.n_q, -1))
        return out[1] + (out[0] - out[1]) * cfg_scale


Reference = ZonosReference


def delay(codes: np.ndarray, masked: int) -> np.ndarray:
    """Aligned codes [n_q, n] → delayed [n_q, n + n_q + 1]: codebook k shifted
    right by k + 1, masked before its start, 0 past its end."""
    n_q, n = codes.shape
    out = np.zeros((n_q, n + n_q + 1), np.int64)
    for k in range(n_q):
        out[k, : k + 1] = masked
        out[k, k + 1: k + 1 + n] = codes[k]
    return out


def sampler_logits(logits: torch.Tensor, delayed: torch.Tensor, eos: int, penalty: float, window: int):
    """The serving sampler's view of logits [O, n_q, V] for delayed positions
    1..O: position 1 (the prefill's sample) as it is; later positions with EOS
    at -log 2 in codebook 0 and forbidden elsewhere, then the repetition
    penalty over the last ``window`` delayed positions (masked tokens count
    as EOS, the vocabulary's last entry)."""
    o_n, n_q, v = logits.shape
    out = logits.clone()
    bias = torch.zeros((n_q, v), device=logits.device)
    bias[1:, eos] = float("-inf")
    bias[0, eos] = -math.log(2.0)
    out[1:] += bias
    for i in range(1, o_n):
        o = i + 1  # the delayed position predicted
        ctx = delayed[:, max(o - window, 0): o].clamp(max=v - 1)  # [n_q, W]
        counts = torch.zeros((n_q, v), device=logits.device)
        counts.scatter_add_(1, ctx.long(), torch.ones_like(ctx, dtype=torch.float32))
        f = penalty ** counts
        out[i] = torch.where(out[i] <= 0, out[i] * f, out[i] / f)
    return out


def compared_mask(n: int, n_q: int, o_n: int, device) -> torch.Tensor:
    """[O, n_q] bool: the (position, codebook) pairs whose target token and whole
    input are served frames (position o = i + 1 predicts codebook k's frame o-k-1)."""
    o = torch.arange(1, o_n + 1, device=device)[:, None]
    k = torch.arange(n_q, device=device)[None, :]
    return (o >= k + 1) & (o <= n + k) & (o <= n + 1)
