"""ResNet293 (SimAM) speaker-embedding tower (port of ``zonos_tpu/speaker/resnet.py``).

A 2-D ResNet with parameter-free SimAM attention in every block, layer plan
(10, 20, 64, 3) at widths 64·2^i, attentive statistics pooling (ASP) and a
linear bottleneck to the 256-d embedding.

PyTorch layout throughout: activations NCHW ([B, C, mel, frames]), conv
weights OIHW and linear weights [out, in], as in the reference checkpoint.
Inference BatchNorm is folded into a per-channel (scale, bias) when a state
dict is read (eps 1e-5). The N-1 identical stride-1 blocks of each stage
are stacked leaf by leaf ([N-1, ...]) as in the JAX package, and run as a
loop over the stack. The JAX package leaves the tower to XLA; here the
convolutions are plain ``torch.nn.functional`` calls.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LAYER_PLAN = (10, 20, 64, 3)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _affine(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Folded inference BatchNorm on [B, C, ...]: per-channel scale + bias."""
    shape = (-1,) + (1,) * (x.dim() - 2)
    return x * p["scale"].to(x.dtype).reshape(shape) + p["bias"].to(x.dtype).reshape(shape)


def simam(x: torch.Tensor, lambda_p: float = 1e-4) -> torch.Tensor:
    """Parameter-free attention over the spatial axes (2, 3) of NCHW."""
    n = x.shape[2] * x.shape[3] - 1
    d = (x - x.mean(dim=(2, 3), keepdim=True)).square()
    v = d.sum(dim=(2, 3), keepdim=True) / n
    return x * torch.sigmoid(d / (4 * (v + lambda_p)) + 0.5)


def simam_block(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    out = torch.relu(_affine(_conv(x, p["conv1"], stride=stride), p["bn1"]))
    out = simam(_affine(_conv(out, p["conv2"]), p["bn2"]))
    if "down_conv" in p:
        x = _affine(_conv(x, p["down_conv"], stride=stride, padding=0), p["down_bn"])
    return torch.relu(out + x)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def resnet_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, 1, mel, frames] → feature map [B, 8·width, mel/8, frames/8]."""
    h = torch.relu(_affine(_conv(x, params["stem"]["conv"]), params["stem"]["bn"]))
    for stage_idx, stage in enumerate(params["stages"]):
        h = simam_block(stage["first"], h, stride=1 if stage_idx == 0 else 2)
        rest = stage["rest"]
        if rest is not None:
            for i in range(rest["conv1"].shape[0]):
                h = simam_block(_index(rest, i), h)
    return h


def asp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Attentive statistics pooling: x [B, C, H, W] → flatten (C, H) per frame →
    attention weights over W → concat(weighted mean, weighted std) → [B, 2·C·H]."""
    b, c, h, w = x.shape
    feat = x.reshape(b, c * h, w)
    a = torch.einsum("bfw,kf->bkw", feat, params["att_conv1"]["w"]) + params["att_conv1"]["b"][:, None]
    a = _affine(torch.relu(a), params["att_bn"])
    a = torch.einsum("bkw,fk->bfw", a, params["att_conv2"]["w"]) + params["att_conv2"]["b"][:, None]
    wgt = torch.softmax(a, dim=2)
    mu = (feat * wgt).sum(dim=2)
    sg = torch.sqrt(torch.clamp((feat.square() * wgt).sum(dim=2) - mu.square(), min=1e-5))
    return torch.cat([mu, sg], dim=1)


def speaker_encoder_forward(params: dict, fbank: torch.Tensor) -> torch.Tensor:
    """fbank [B, mel, frames] → 256-d embedding [B, 256]."""
    h = resnet_forward(params["resnet"], fbank[:, None])
    pooled = asp_forward(params["asp"], h)
    return F.linear(pooled, params["bottleneck"]["w"], params["bottleneck"]["b"])


# ---------------------------------------------------------------------------
# Init / conversion
# ---------------------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _layer_plan(sd: dict) -> tuple[int, ...]:
    """Blocks per stage, read from the ``front.layer<i>.<j>.`` names."""
    plan = []
    for li in range(1, 5):
        head = f"front.layer{li}."
        plan.append(len({k[len(head):].split(".")[0] for k in sd if k.startswith(head)}))
    return tuple(plan)


def speaker_state_dict_to_params(
    sd: dict,
    layer_plan: tuple[int, ...] | None = None,
    device="cpu",
) -> dict:
    """A ResNet293_based state dict (torch tensors or numpy arrays, the
    reference names) → the port's params, BatchNorm folded at eps 1e-5.
    The widths come from the weights, and the layer plan, unless given, from
    the names ((10, 20, 64, 3) for the reference checkpoint)."""
    layer_plan = _layer_plan(sd) if layer_plan is None else layer_plan

    def t(name):
        return _f32(sd[name], device)

    def bn(name, eps=1e-5):
        scale = t(f"{name}.weight") / torch.sqrt(t(f"{name}.running_var") + eps)
        return {"scale": scale, "bias": t(f"{name}.bias") - t(f"{name}.running_mean") * scale}

    def block(bp: str, has_down: bool) -> dict:
        p = {"conv1": t(f"{bp}.conv1.weight"), "bn1": bn(f"{bp}.bn1"),
             "conv2": t(f"{bp}.conv2.weight"), "bn2": bn(f"{bp}.bn2")}
        if has_down:
            p["down_conv"] = t(f"{bp}.downsample.0.weight")
            p["down_bn"] = bn(f"{bp}.downsample.1")
        return p

    stages = []
    for li, n_blocks in enumerate(layer_plan):
        name = f"front.layer{li + 1}"
        first = block(f"{name}.0", li > 0)  # stage 1 keeps width and stride: no downsample
        rest = _stack([block(f"{name}.{i}", False) for i in range(1, n_blocks)]) if n_blocks > 1 else None
        stages.append({"first": first, "rest": rest})
    return {
        "resnet": {"stem": {"conv": t("front.conv1.weight"), "bn": bn("front.bn1")}, "stages": stages},
        "asp": {
            "att_conv1": {"w": t("pooling.attention.0.weight")[:, :, 0], "b": t("pooling.attention.0.bias")},
            "att_bn": bn("pooling.attention.2"),
            "att_conv2": {"w": t("pooling.attention.3.weight")[:, :, 0], "b": t("pooling.attention.3.bias")},
        },
        "bottleneck": {"w": t("bottleneck.weight"), "b": t("bottleneck.bias")},
    }


def init_speaker_params(
    generator: torch.Generator,
    in_planes: int = 64,
    layer_plan: tuple[int, ...] = LAYER_PLAN,
    acoustic_dim: int = 80,
    embd_dim: int = 256,
    device=None,
) -> dict:
    """Random init with the exact ResNet293_based shapes, drawn from ``generator``
    (conv taps N(0, 1/(k·k·Cin)), identity BatchNorm)."""
    device = generator.device if device is None else device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    def conv_init(ci, co, k=3):
        return normal((co, ci, k, k), 1.0 / np.sqrt(k * k * ci))

    def bn_init(c):
        return {"scale": torch.ones((c,), device=device), "bias": torch.zeros((c,), device=device)}

    def block(ci, co, has_down):
        p = {"conv1": conv_init(ci, co), "bn1": bn_init(co), "conv2": conv_init(co, co), "bn2": bn_init(co)}
        if has_down:
            p["down_conv"] = conv_init(ci, co, k=1)
            p["down_bn"] = bn_init(co)
        return p

    stem = {"conv": conv_init(1, in_planes), "bn": bn_init(in_planes)}
    stages = []
    ci = in_planes
    for li, n_blocks in enumerate(layer_plan):
        co = in_planes * 2**li
        first = block(ci, co, li > 0)
        rest = _stack([block(co, co, False) for _ in range(n_blocks - 1)]) if n_blocks > 1 else None
        stages.append({"first": first, "rest": rest})
        ci = co

    feat_dim = in_planes * 8 * (acoustic_dim // 8)
    return {
        "resnet": {"stem": stem, "stages": stages},
        "asp": {
            "att_conv1": {"w": normal((128, feat_dim), 0.02), "b": torch.zeros((128,), device=device)},
            "att_bn": bn_init(128),
            "att_conv2": {"w": normal((feat_dim, 128), 0.02), "b": torch.zeros((feat_dim,), device=device)},
        },
        "bottleneck": {"w": normal((embd_dim, feat_dim * 2), 0.01), "b": torch.zeros((embd_dim,), device=device)},
    }
