"""Top-level model handle (port of ``zonos_tpu/models/zonos.py``).

``from_config`` builds a random-init model from a seed on a device,
``from_local`` loads a reference checkpoint (``config.json`` +
``model.safetensors``) and ``from_pretrained`` finds one in the local hub
cache; either backbone (transformer or hybrid). ``quantize`` makes the
decode matmuls int8 or int4 (and the KV cache int8 by default),
``prepare_conditioning`` turns a ``make_cond_dict`` dict into the
CFG-doubled prefix embeddings, ``generate`` turns those into audio codes,
``generate_audio`` into PCM with the DAC interleaved with the decode loop,
and ``stream`` into PCM chunks as they are decoded.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Mapping

import numpy as np
import torch

from zonos_tpu_torch import resolve_device
from zonos_tpu_torch.conditioning.conditioners import (
    init_prefix_conditioner_params,
    prefix_conditioner_forward,
    required_keys,
)
from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.models.backbone import init_backbone_params
from zonos_tpu_torch.ops.cuda_matmul import reserve_mlp_scratch
from zonos_tpu_torch.ops.quant import quantize_hybrid_params, quantize_transformer_params
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime import generate as genmod
from zonos_tpu_torch.runtime import streaming


class ConditioningCache:
    """Thread-safe LRU cache of prepared conditioning.

    Keyed on a SHA-512 over the cond/uncond dict contents and ``cfg_scale``
    (the scale decides whether the unconditional half is present).
    """

    def __init__(self, max_size: int = 32):
        self.max_size = max_size
        self._cache: dict[str, Any] = {}
        self._lock = threading.Lock()

    @staticmethod
    def make_key(cond_dict: Mapping, uncond_dict: Mapping | None, cfg_scale: float) -> str:
        def enc(v) -> str:
            if v is None:
                return "None"
            if isinstance(v, (int, float, str, bool)):
                return str(v)
            if isinstance(v, (list, tuple)):
                return f"list_{[enc(x) for x in v]}"
            if isinstance(v, torch.Tensor):
                v = v.detach().float().cpu().numpy()
            if hasattr(v, "__array__"):
                a = np.asarray(v)
                return f"arr_{a.shape}_{a.dtype}_{hashlib.sha512(a.tobytes()).hexdigest()}"
            return f"other_{type(v).__name__}_{v}"

        c = sorted((k, enc(v)) for k, v in cond_dict.items())
        u = None if uncond_dict is None else sorted((k, enc(v)) for k, v in uncond_dict.items())
        return hashlib.sha512(f"cfg:{cfg_scale}_cond:{c}_uncond:{u}".encode()).hexdigest()

    def get(self, key: str):
        with self._lock:
            if key in self._cache:
                val = self._cache.pop(key)
                self._cache[key] = val
                return val
            return None

    def put(self, key: str, value) -> None:
        with self._lock:
            self._cache.pop(key, None)
            if len(self._cache) >= self.max_size:
                del self._cache[next(iter(self._cache))]
            self._cache[key] = value

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()

    def size(self) -> int:
        with self._lock:
            return len(self._cache)


class Zonos:
    """Config + params dict (JAX layout) on one device."""

    def __init__(self, config: ZonosConfig, params: dict, dtype=torch.bfloat16, device=None):
        self.config = config
        self.params = params
        self.dtype = dtype
        self.device = resolve_device(device)
        self.eos_token_id = config.eos_token_id
        self.masked_token_id = config.masked_token_id
        self._conditioning_cache = ConditioningCache(max_size=32)
        self._autoencoder = None
        self.default_kv_int8 = False  # quantize() turns it on: quantized weights + int8 KV

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
            "prefix_conditioner": init_prefix_conditioner_params(gen, config.prefix_conditioner, d, dtype, device),
        }
        return cls(config, params, dtype, device)

    @classmethod
    def from_local(cls, config_path: str, model_path: str, dtype=torch.bfloat16, device=None) -> "Zonos":
        """A reference-layout checkpoint: ``config.json`` and ``model.safetensors``."""
        from zonos_tpu_torch.utils.loading import load_safetensors, torch_state_dict_to_params

        device = resolve_device(device)
        config = ZonosConfig.from_json(config_path)
        params = torch_state_dict_to_params(load_safetensors(model_path), config, dtype, device)
        return cls(config, params, dtype, device)

    @classmethod
    def from_pretrained(cls, repo_id: str, revision: str | None = None, cache_dir=None, dtype=torch.bfloat16,
                        device=None) -> "Zonos":
        """``repo_id``'s checkpoint from the local Hugging Face hub cache
        (``utils.hub``); nothing is downloaded. Raises FileNotFoundError,
        naming the directory searched, when the files are not there."""
        from zonos_tpu_torch.utils.hub import cached_snapshot, repo_dir

        device = resolve_device(device)
        files = ("config.json", "model.safetensors")
        snap = cached_snapshot(repo_id, files, revision=revision, cache_dir=cache_dir)
        if snap is None:
            where = repo_dir(repo_id, cache_dir) / "snapshots" / (revision or "*")
            raise FileNotFoundError(f"{repo_id}: no {' and '.join(files)} under {where} (the port reads the local "
                                    "hub cache only and downloads nothing)")
        return cls.from_local(str(snap / files[0]), str(snap / files[1]), dtype=dtype, device=device)

    def quantize(self, bits: int = 8) -> "Zonos":
        """Weight-only int8 (``bits=8``) or group-wise int4 (``bits=4``) of the
        backbone matmuls, int8 heads; int8 KV by default afterwards. On the
        card K3's h scratch is sized here for the model's widest MLP, so no
        decode step reallocates it."""
        quantize = quantize_hybrid_params if self.config.backbone.is_hybrid else quantize_transformer_params
        m = Zonos(self.config, quantize(self.params, bits=bits), self.dtype, self.device)
        m._autoencoder = self._autoencoder
        m.default_kv_int8 = True
        if bits == 8 and self.device.type == "cuda":
            bb = self.config.backbone
            reserve_mlp_scratch(self.device, max(bb.d_intermediate, bb.attn_mlp_d_intermediate))
        return m

    # ------------------------------------------------------------------
    # Conditioning
    # ------------------------------------------------------------------

    @property
    def required_cond_keys(self) -> set[str]:
        return required_keys(self.config.prefix_conditioner)

    @property
    def conditioner_names(self) -> list[str]:
        return [s.name for s in self.config.prefix_conditioner.conditioners]

    def prepare_conditioning(
        self,
        cond_dict: Mapping[str, Any],
        uncond_dict: Mapping[str, Any] | None = None,
        use_cache: bool = False,
        cfg_scale: float = 2.0,
    ) -> torch.Tensor:
        """[2B, Lc, D] prefix embeddings (cond ++ uncond) on the model's device.

        The unconditional half defaults to the required keys of ``cond_dict``
        only, so every optional conditioner takes its learned uncond vector.
        With ``cfg_scale == 1.0`` only the conditional half is returned.
        """
        key = None
        if use_cache:
            key = ConditioningCache.make_key(cond_dict, uncond_dict, cfg_scale)
            hit = self._conditioning_cache.get(key)
            if hit is not None:
                return hit

        pcfg = self.config.prefix_conditioner
        pparams = self.params["prefix_conditioner"]
        with torch.no_grad():
            result = prefix_conditioner_forward(pparams, pcfg, cond_dict, self.dtype, norm_eps=1e-5)
            if cfg_scale != 1.0:
                if uncond_dict is None:
                    uncond_dict = {k: cond_dict[k] for k in self.required_cond_keys}
                uncond = prefix_conditioner_forward(pparams, pcfg, uncond_dict, self.dtype, norm_eps=1e-5)
                result = torch.cat([result, uncond], dim=0)

        if key is not None:
            self._conditioning_cache.put(key, result)
        return result

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def generate(
        self,
        prefix_conditioning,
        audio_prefix_codes=None,
        max_new_tokens: int = 86 * 30,
        cfg_scale: float = 2.0,
        batch_size: int = 1,
        sampling_params: dict | SamplingParams | None = None,
        seed=None,
        callback=None,
        callback_interval: int = 64,
        kv_int8: bool | None = None,
        forbid_eos: bool = False,
        return_lengths: bool = False,
        stats: dict | None = None,
    ):
        """Sanitized audio codes [B, 9, T] (numpy int32) from [2B, Lc, D] conditioning.

        With ``callback``, decoding runs in segments of ``callback_interval``
        steps and ``callback(None, steps_done, max_steps)`` is called between
        segments; returning False stops early and returns the codes so far.
        """
        kv_int8 = self.default_kv_int8 if kv_int8 is None else kv_int8
        common = dict(
            audio_prefix_codes=audio_prefix_codes, max_new_tokens=max_new_tokens, cfg_scale=cfg_scale,
            batch_size=batch_size, sampling_params=sampling_params, seed=seed, dtype=self.dtype,
            forbid_eos=forbid_eos, kv_int8=kv_int8, device=self.device,
        )
        if callback is None:
            return genmod.generate(self.params, self.config, prefix_conditioning,
                                   return_lengths=return_lengths, stats=stats, **common)
        if return_lengths:
            raise ValueError("return_lengths needs the callback-free path")
        max_steps = max_new_tokens + self.config.codebook_dimension - 2
        result = None
        for item, _sr in streaming.generate_stream(
            self.params, self.config, prefix_conditioning, autoencoder=None,
            first_chunk_frames=callback_interval, chunk_frames=callback_interval,
            on_progress=lambda steps: callback(None, steps, max_steps), **common,
        ):
            if item is not None:
                result = item
        if result is None:
            result = np.zeros((batch_size, self.config.codebook_dimension, 0), np.int32)
        return result

    def generate_audio(
        self,
        prefix_conditioning,
        audio_prefix_codes=None,
        max_new_tokens: int = 86 * 30,
        cfg_scale: float = 2.0,
        batch_size: int = 1,
        sampling_params=None,
        seed=None,
        kv_int8: bool | None = None,
        forbid_eos: bool = False,
        pcm_int16: bool = False,
        stats: dict | None = None,
    ):
        """Full request → (wav [B, Lmax * hop], lengths [B]), the DAC interleaved
        with the decode loop (``runtime.streaming.generate_audio``): float32
        PCM, or int16 quantized on the device with ``pcm_int16``."""
        return streaming.generate_audio(
            self.params, self.config, prefix_conditioning, autoencoder=self.autoencoder,
            audio_prefix_codes=audio_prefix_codes, max_new_tokens=max_new_tokens, cfg_scale=cfg_scale,
            batch_size=batch_size, sampling_params=sampling_params, seed=seed, dtype=self.dtype,
            forbid_eos=forbid_eos, kv_int8=self.default_kv_int8 if kv_int8 is None else kv_int8,
            pcm_int16=pcm_int16, device=self.device, stats=stats,
        )

    def stream(
        self,
        prefix_conditioning,
        audio_prefix_codes=None,
        max_new_tokens: int = 86 * 30,
        cfg_scale: float = 2.0,
        sampling_params=None,
        seed=None,
        first_chunk_frames: int = 16,
        chunk_frames: int = 64,
        kv_int8: bool | None = None,
        stats: dict | None = None,
    ):
        """Streaming generation: yields (pcm float32 [T], sample_rate) chunks,
        the first after the prefill and ``first_chunk_frames`` decode steps.
        A ``stats`` dict receives ``decode_steps`` when the stream ends."""
        return streaming.generate_stream(
            self.params, self.config, prefix_conditioning, autoencoder=self.autoencoder,
            audio_prefix_codes=audio_prefix_codes, max_new_tokens=max_new_tokens, cfg_scale=cfg_scale,
            sampling_params=sampling_params, seed=seed, first_chunk_frames=first_chunk_frames,
            chunk_frames=chunk_frames, dtype=self.dtype,
            kv_int8=self.default_kv_int8 if kv_int8 is None else kv_int8, device=self.device, stats=stats,
        )

    @property
    def autoencoder(self):
        """The DAC on the model's device: descript/dac_44khz from the local hub
        cache, else seeded random full-size weights (``codec.dac``)."""
        if self._autoencoder is None:
            from zonos_tpu_torch.codec.dac import DACAutoencoder

            self._autoencoder = DACAutoencoder(dtype=self.dtype, device=self.device)
        return self._autoencoder
