"""Top-level model handle (slim port of ``zonos_tpu/models/zonos.py``).

``from_config`` builds a random-init model from a seed on a device,
``quantize`` makes its decode matmuls int8 (and the KV cache int8 by
default), ``generate`` turns conditioning embeddings into audio codes, and
``autoencoder`` decodes codes to PCM. The conditioners and the text front
end that make the conditioning are the next slice (ROADMAP.md).
"""

from __future__ import annotations

import torch

from zonos_tpu_torch import resolve_device
from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.models.backbone import init_backbone_params
from zonos_tpu_torch.ops.quant import quantize_transformer_params
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime import generate as genmod


class Zonos:
    """Config + params dict (JAX layout) on one device."""

    def __init__(self, config: ZonosConfig, params: dict, dtype=torch.bfloat16, device=None):
        self.config = config
        self.params = params
        self.dtype = dtype
        self.device = resolve_device(device)
        self.eos_token_id = config.eos_token_id
        self.masked_token_id = config.masked_token_id
        self._autoencoder = None
        self.default_kv_int8 = False  # quantize() turns it on: int8 weights + int8 KV

    @classmethod
    def from_config(cls, config: ZonosConfig, seed: int = 0, dtype=torch.bfloat16, device=None) -> "Zonos":
        """Random-init model (no checkpoint), drawn from a torch.Generator seeded with ``seed``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        d = config.backbone.d_model
        n_q = config.codebook_dimension
        emb = torch.randn((n_q, config.vocab_size, d), generator=gen, device=device) * 0.02
        heads = torch.randn((d, n_q * config.head_vocab_size), generator=gen, device=device) / d ** 0.5
        params = {
            "embeddings": emb.to(dtype),
            "heads": heads.to(dtype),
            "backbone": init_backbone_params(gen, config.backbone, dtype, device),
        }
        return cls(config, params, dtype, device)

    def quantize(self, bits: int = 8) -> "Zonos":
        """Weight-only int8 of the backbone matmuls and heads; int8 KV by default."""
        m = Zonos(self.config, quantize_transformer_params(self.params, bits=bits), self.dtype, self.device)
        m._autoencoder = self._autoencoder
        m.default_kv_int8 = True
        return m

    def generate(
        self,
        prefix_conditioning,
        audio_prefix_codes=None,
        max_new_tokens: int = 86 * 30,
        cfg_scale: float = 2.0,
        batch_size: int = 1,
        sampling_params: dict | SamplingParams | None = None,
        seed=None,
        kv_int8: bool | None = None,
        forbid_eos: bool = False,
        return_lengths: bool = False,
        stats: dict | None = None,
    ):
        """Sanitized audio codes [B, 9, T] (numpy int32) from [2B, Lc, D] conditioning."""
        return genmod.generate(
            self.params, self.config, prefix_conditioning,
            audio_prefix_codes=audio_prefix_codes, max_new_tokens=max_new_tokens,
            cfg_scale=cfg_scale, batch_size=batch_size, sampling_params=sampling_params,
            seed=seed, dtype=self.dtype, forbid_eos=forbid_eos,
            kv_int8=self.default_kv_int8 if kv_int8 is None else kv_int8,
            return_lengths=return_lengths, device=self.device, stats=stats,
        )

    @property
    def autoencoder(self):
        """The DAC decoder on the model's device (random full-size weights)."""
        if self._autoencoder is None:
            from zonos_tpu_torch.codec.dac import DACAutoencoder

            self._autoencoder = DACAutoencoder(dtype=self.dtype, device=self.device)
        return self._autoencoder
