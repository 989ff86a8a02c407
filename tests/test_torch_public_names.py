"""Every public name of the JAX package has its counterpart in the port,
but for the JAX-only names recorded in ROADMAP §3; and
``TensorCacheManager.contains/clear_memory/size``,
``DACAutoencoder.decode_to_int16`` and ``SpeakerEmbeddingLDA.from_pretrained``
behave as JAX's on the same inputs."""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dac_encoder import DAC_KW, _np_params
from tests.test_torch_speaker import _j_lda, _reference_state_dict, _wav
from zonos_tpu.codec import dac as JDAC
from zonos_tpu.serving import caches as JC
from zonos_tpu_torch.bridge import dac_params_from_jax
from zonos_tpu_torch.codec import dac as TDAC
from zonos_tpu_torch.config import DACConfig
from zonos_tpu_torch.serving import caches as TC
from zonos_tpu_torch.speaker import embedding as TE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Public names of zonos_tpu with no counterpart in the port, by module (ROADMAP §3).
JAX_ONLY = {
    "codec/dac.py": {"conv_transpose1d_phased"},
    "models/transformer.py": {"FUSED_MLP", "PALLAS_ATTN", "REMAT_LAYERS", "UNROLL_LAYERS", "KVCache.max_seqlen"},
    "ops/norms.py": {"add_norm"},
    "ops/quant.py": {"PALLAS_DECODE"},
    "ops/rope.py": {"precompute_freqs"},
    "ops/sampling.py": {"gumbel_sample"},
    "parallel/mesh.py": {"batch_sharding", "replicated"},
    "runtime/generate.py": {"build_generate_fn", "seed_to_key"},
    "runtime/speculative.py": {"SpecCarry", "build_spec_generate_fn"},
    "serving/pipeline.py": {"PerformanceTimer"},  # spans of utils/profiling's recorder instead
    "utils/profiling.py": {"xla_trace", "executable_memory_table"},
}
PALLAS = {"ops/pallas_matmul.py", "ops/pallas_attention.py"}  # ported as ops/cuda_matmul.py, ops/cuda_attention.py


def _public(path: str) -> set:
    """Top-level public functions, classes, their public methods and assigned names of a module."""
    names = set()
    for node in ast.parse(open(path, encoding="utf-8").read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{f.name}" for f in node.body
                          if isinstance(f, ast.FunctionDef) and not f.name.startswith("_")}
        targets = node.targets if isinstance(node, ast.Assign) else [node.target] if isinstance(node, ast.AnnAssign) else []
        names |= {t.id for t in targets if isinstance(t, ast.Name) and not t.id.startswith("_")}
    return names


def _has(module, dotted: str) -> bool:
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_public_names_have_counterparts_but_the_jax_only_ones():
    root = os.path.join(REPO, "zonos_tpu")
    missing = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            if not f.endswith(".py") or rel in PALLAS:
                continue
            port = importlib.import_module("zonos_tpu_torch." + rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
            gone = {n for n in _public(os.path.join(dirpath, f)) if not _has(port, n)}
            if gone:
                missing[rel] = gone
    assert missing == JAX_ONLY


def test_cache_manager_contains_clear_and_size_as_jax(tmp_path):
    managers = [M("embeds", str(tmp_path / name), "m") for M, name in ((JC.TensorCacheManager, "jax"),
                                                                      (TC.TensorCacheManager, "port"))]
    seen = []
    for m in managers:
        row = [m.contains("a"), m.size()]
        m.put("a", np.ones(3, np.float32))
        m.put("b", np.zeros(2, np.float32), persist=False)
        row += [m.contains("a"), m.contains("b"), m.size()]
        m.clear_memory()
        row += [m.size(), m.contains("a"), m.contains("b")]  # "a" stays on disk, "b" was memory only
        row += [m.get("a") is not None, m.size()]
        seen.append(row)
    assert seen[0] == seen[1] == [False, 0, True, True, 2, 0, True, False, True, 1]


def test_decode_to_int16_matches_jax():
    jcfg = JDAC.DACConfig(**DAC_KW)
    np_params = _np_params(jcfg, seed=3)
    jae = JDAC.DACAutoencoder(params=jax.tree.map(jnp.asarray, np_params), cfg=jcfg, dtype=jnp.float32,
                              frame_bucket=8)
    tae = TDAC.DACAutoencoder(params=dac_params_from_jax(np_params), cfg=DACConfig(**DAC_KW),
                              dtype=torch.float32, frame_bucket=8, device="cpu")
    codes = np.random.default_rng(4).integers(0, 1024, size=(2, 9, 13)).astype(np.int32)
    ref, got = jae.decode_to_int16(codes), tae.decode_to_int16(codes)
    assert got.dtype == ref.dtype == np.int16 and got.shape == ref.shape == (13 * 8, 1)
    assert np.abs(got).max() > 100  # audible PCM, not a silent codec
    # the f32 decodes agree to ~1e-6; truncation to int16 may step one count apart
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    assert np.array_equal(got[:, 0], np.clip(tae.decode(codes)[0, 0] * 32767.0, -32767.0, 32767.0).astype(np.int16))


def test_speaker_from_pretrained_reads_the_local_hub_cache(tmp_path, monkeypatch):
    plan = (2, 1, 1, 1)
    sd = _reference_state_dict(np.random.default_rng(9), plan=plan)
    jlda = _j_lda(3)
    snap = tmp_path / "hub" / "models--Zyphra--Zonos-v0.1-speaker-embedding" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, snap / TE.CKPT_NAME)
    torch.save({"weight": torch.from_numpy(jlda["w"].T.copy()), "bias": torch.from_numpy(jlda["b"])},
               snap / TE.LDA_NAME)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    got = TE.SpeakerEmbeddingLDA.from_pretrained(device="cpu")
    ref = TE.SpeakerEmbeddingLDA(ckpt_path=str(snap / TE.CKPT_NAME), lda_ckpt_path=str(snap / TE.LDA_NAME),
                                 device="cpu")
    got.frame_bucket = ref.frame_bucket = 64
    wav = _wav(0.5, 16000, seed=10)
    for a, b in zip(got(wav, 16000), ref(wav, 16000)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="models--Zyphra--Zonos-v0.1-speaker-embedding/snapshots"):
        TE.SpeakerEmbeddingLDA.from_pretrained(cache_dir=str(tmp_path / "empty"), device="cpu")
