"""Checkpoints: the port's safetensors reader and writer, reference-layout
checkpoints between the two packages (both backbones, both ways), the
legacy reference layouts, config.json, the local hub cache, the DAC's
transformers state dict and the port's native checkpoint.

Every checkpoint here is written by the test from seeded weights; nothing is
downloaded.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.codec import dac as JDAC
from zonos_tpu.config import ZonosConfig as JConfig
from zonos_tpu.config import tiny_hybrid_config as j_hybrid
from zonos_tpu.config import tiny_transformer_config as j_transformer
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops.sampling import SamplingParams as JSP
from zonos_tpu.runtime import generate as JG
from zonos_tpu.utils import checkpoint as JCK
from zonos_tpu.utils import export as JE
from zonos_tpu.utils import loading as JL
from zonos_tpu_torch.bridge import dac_params_from_jax, params_from_jax
from zonos_tpu_torch.codec import dac as TDAC
from zonos_tpu_torch.config import DACConfig, ZonosConfig, config_to_dict, tiny_hybrid_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime import generate as TG
from zonos_tpu_torch.utils import checkpoint as TCK
from zonos_tpu_torch.utils import export as TE
from zonos_tpu_torch.utils import loading as TL
from zonos_tpu_torch.utils import safetensors_io as SIO

BACKBONES = {"transformer": j_transformer, "hybrid": j_hybrid}


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_tree_equal(u, v, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), path


def _bridge(params):
    return params_from_jax(jax.tree.map(np.asarray, params))


def _greedy(jparams, jcfg, tparams, tcfg, seed=0):
    cond = np.random.default_rng(seed).normal(size=(2, 9, 64)).astype(np.float32) * 0.5
    ref = JG.generate(jparams, jcfg, cond, max_new_tokens=16, sampling_params=JSP(temperature=0.0), seed=0,
                      dtype=jnp.float32)
    got = TG.generate(tparams, tcfg, cond, max_new_tokens=16, sampling_params=SamplingParams(temperature=0.0),
                      seed=0, dtype=torch.float32, device="cpu")
    return got, ref


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8, torch.int32, torch.int64]


def _tensors(dtype):
    g = torch.Generator().manual_seed(3)
    t = {"a.weight": torch.randn((3, 5), generator=g) * 100, "b": torch.randn((7,), generator=g) * 100,
         "scalar": torch.randn((), generator=g), "empty": torch.zeros((0, 4))}
    return {k: v.to(dtype) for k, v in t.items()}


@pytest.mark.parametrize("dtype", DTYPES, ids=[str(d).split(".")[1] for d in DTYPES])
def test_safetensors_both_ways_against_the_package(tmp_path, dtype):
    import safetensors.torch as ST

    tensors = _tensors(dtype)
    SIO.save_file(tensors, str(tmp_path / "port.safetensors"))
    ST.save_file(tensors, str(tmp_path / "package.safetensors"))
    for theirs, ours in ((ST.load_file(str(tmp_path / "port.safetensors")), tensors),
                         (SIO.load_file(str(tmp_path / "package.safetensors")), tensors)):
        assert set(theirs) == set(ours)
        for k in ours:
            assert theirs[k].dtype == dtype and theirs[k].shape == ours[k].shape and torch.equal(theirs[k], ours[k])


def _write_raw(path, header: dict, data: bytes):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw + data)


@pytest.mark.parametrize("case", ["gap", "overlap", "short", "size", "dtype"])
def test_safetensors_refuses_a_header_that_does_not_tile_the_data(tmp_path, case):
    a = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    b = {"dtype": "F32", "shape": [1], "data_offsets": [8, 12]}
    data = bytes(12)
    if case == "gap":
        b["data_offsets"], data = [12, 16], bytes(16)
    elif case == "overlap":
        b["data_offsets"] = [4, 8]
    elif case == "short":
        data = bytes(16)
    elif case == "size":
        b["shape"] = [2]
    else:
        b["dtype"] = "F64"
    _write_raw(tmp_path / "bad.safetensors", {"a": a, "b": b}, data)
    with pytest.raises(ValueError):
        SIO.load_file(str(tmp_path / "bad.safetensors"))


# ---------------------------------------------------------------------------
# Reference-layout checkpoints between the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(BACKBONES))
def jax_checkpoint(request, tmp_path_factory):
    jcfg = BACKBONES[request.param]()
    jm = JZonos.from_config(jcfg, seed=2, dtype=jnp.float32)
    d = tmp_path_factory.mktemp(request.param)
    JE.save_reference_checkpoint(str(d), jm.params, jcfg)
    jl = JZonos.from_local(str(d / "config.json"), str(d / "model.safetensors"), dtype=jnp.float32)
    return d, jl


def test_jax_checkpoint_loads_into_the_port(jax_checkpoint):
    """JAX's export read by the port's from_local: the bridged params of JAX's
    own from_local of the same file, exactly, and the same greedy codes."""
    d, jl = jax_checkpoint
    port = Zonos.from_local(str(d / "config.json"), str(d / "model.safetensors"), dtype=torch.float32, device="cpu")
    assert port.config.backbone.is_hybrid == jl.config.backbone.is_hybrid
    _assert_tree_equal(port.params, _bridge(jl.params))
    got, ref = _greedy(jl.params, jl.config, port.params, port.config)
    np.testing.assert_array_equal(got, ref)


def test_port_checkpoint_loads_into_jax(jax_checkpoint, tmp_path):
    """The port's export read by JAX's from_local gives the same params, the
    same state dict as JAX's export, and the same greedy codes."""
    d, jl = jax_checkpoint
    port = Zonos.from_local(str(d / "config.json"), str(d / "model.safetensors"), dtype=torch.float32, device="cpu")
    TE.save_reference_checkpoint(str(tmp_path), port.params, port.config)
    back = JZonos.from_local(str(tmp_path / "config.json"), str(tmp_path / "model.safetensors"), dtype=jnp.float32)
    _assert_tree_equal(_bridge(back.params), port.params)
    ref_sd = JE.params_to_torch_state_dict(jl.params, jl.config)
    got_sd = TE.params_to_torch_state_dict(port.params, port.config)
    assert set(ref_sd) == set(got_sd)
    for k in ref_sd:
        np.testing.assert_array_equal(got_sd[k].numpy(), ref_sd[k], err_msg=k)
    got, ref = _greedy(back.params, back.config, port.params, port.config, seed=1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_params_dequantize_on_export(jax_checkpoint, bits):
    """int8 exports equal JAX's export of the same quantized params; int4
    (which JAX's exporter does not take) exports its dequantized values."""
    _, jl = jax_checkpoint
    q = jl.quantize(bits=bits)
    got = TE.params_to_torch_state_dict(_bridge(q.params), ZonosConfig.from_dict(JCK._config_to_dict(jl.config)))
    if bits == 8:
        ref = JE.params_to_torch_state_dict(q.params, jl.config)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    else:
        plain = JE.params_to_torch_state_dict(jl.params, jl.config)
        for k, v in plain.items():
            assert got[k].shape == v.shape, k
        w = plain["backbone.layers.0.mixer.in_proj.weight"]
        assert np.abs(got["backbone.layers.0.mixer.in_proj.weight"].numpy() - w).max() <= np.abs(w).max() / 7


def test_legacy_heads_and_embedding_rows_match_jax():
    """Per-codebook heads.N.weight are fused, the 1026 embedding rows padded
    to 1032 with zeros: the port's conversion equals JAX's."""
    jcfg = j_transformer()
    jm = JZonos.from_config(jcfg, seed=5, dtype=jnp.float32)
    sd = JE.params_to_torch_state_dict(jm.params, jcfg)
    fused = sd.pop("fused_heads.weight")
    for k, part in enumerate(np.split(fused, jcfg.codebook_dimension)):
        sd[f"heads.{k}.weight"] = part
    ref = JL.torch_state_dict_to_params(sd, jcfg, jnp.float32)
    got = TL.torch_state_dict_to_params({k: torch.from_numpy(v) for k, v in sd.items()},
                                        ZonosConfig.from_dict(JCK._config_to_dict(jcfg)), torch.float32)
    _assert_tree_equal(got, _bridge(ref))
    assert got["embeddings"].shape == (9, 1032, 64) and not got["embeddings"][:, 1026:].any()


def _without_extra(d):
    """A config dict without its ``extra`` entries (JAX's from_dict nests a
    stored ``extra`` one level deeper on each read; the port's does not)."""
    if isinstance(d, dict):
        return {k: _without_extra(v) for k, v in d.items() if k != "extra"}
    if isinstance(d, list):
        return [_without_extra(v) for v in d]
    return d


@pytest.mark.parametrize("name", list(BACKBONES))
def test_config_json_round_trips_both_ways(tmp_path, name):
    jcfg = BACKBONES[name]()
    with open(tmp_path / "jax.json", "w") as f:
        json.dump(JCK._config_to_dict(jcfg), f)
    port = ZonosConfig.from_json(str(tmp_path / "jax.json"))
    assert config_to_dict(port) == JCK._config_to_dict(jcfg)
    with open(tmp_path / "port.json", "w") as f:
        json.dump(config_to_dict(port), f)
    assert ZonosConfig.from_json(str(tmp_path / "port.json")) == port  # the port's round trip is exact
    back = JConfig.from_json(str(tmp_path / "port.json"))
    assert back == JConfig.from_json(str(tmp_path / "jax.json"))
    assert _without_extra(JCK._config_to_dict(back)) == _without_extra(JCK._config_to_dict(jcfg))


def test_config_from_reference_json_keeps_unknown_keys():
    d = config_to_dict(tiny_hybrid_config())
    d["backbone"]["attn_cfg"]["causal"] = True
    d["backbone"]["ssm_cfg"]["dt_limit"] = [0.001, 0.1]
    cfg = ZonosConfig.from_dict(d)
    assert ("causal", True) in cfg.backbone.attn_cfg.extra and cfg.backbone.ssm_cfg.dt_limit == (0.001, 0.1)
    assert ZonosConfig.from_dict(json.loads(json.dumps(config_to_dict(cfg)))) == cfg


# ---------------------------------------------------------------------------
# The local hub cache
# ---------------------------------------------------------------------------

def _fake_hub(root, repo_id, files: dict, commit="abc123", ref="main"):
    base = root / f"models--{repo_id.replace('/', '--')}"
    snap = base / "snapshots" / commit
    snap.mkdir(parents=True)
    for name, src in files.items():
        (snap / name).write_bytes(src.read_bytes())
    (base / "refs").mkdir()
    (base / "refs" / ref).write_text(commit)
    return snap


def test_from_pretrained_reads_the_local_hub_cache(jax_checkpoint, tmp_path, monkeypatch):
    d, jl = jax_checkpoint
    files = {n: d / n for n in ("config.json", "model.safetensors")}
    _fake_hub(tmp_path / "hub", "Zyphra/Zonos-v0.1-test", files)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    for kw in ({}, {"revision": "main"}, {"revision": "abc123"}):
        m = Zonos.from_pretrained("Zyphra/Zonos-v0.1-test", dtype=torch.float32, device="cpu", **kw)
        _assert_tree_equal(m.params, _bridge(jl.params))
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    m = Zonos.from_pretrained("Zyphra/Zonos-v0.1-test", dtype=torch.float32, device="cpu")
    assert m.config.backbone == ZonosConfig.from_json(str(d / "config.json")).backbone


def test_from_pretrained_without_the_files_raises_naming_the_path(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="models--Zyphra--Zonos-v0.1-hybrid"):
        Zonos.from_pretrained("Zyphra/Zonos-v0.1-hybrid", device="cpu")
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "elsewhere")):
        Zonos.from_pretrained("Zyphra/Zonos-v0.1-hybrid", cache_dir=str(tmp_path / "elsewhere"), device="cpu")


# ---------------------------------------------------------------------------
# The DAC's transformers state dict
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_dac(tmp_path_factory):
    """transformers' DacModel at its default config, written by save_pretrained."""
    from transformers import DacConfig as HFConfig
    from transformers import DacModel

    torch.manual_seed(0)
    model = DacModel(HFConfig())
    d = tmp_path_factory.mktemp("dac")
    model.save_pretrained(str(d))
    return d, model


def test_dac_converter_equals_jax_on_the_hf_state_dict(hf_dac):
    d, _ = hf_dac
    sd = SIO.load_file(str(d / "model.safetensors"))
    got = TDAC.convert_hf_dac_state_dict(sd)
    ref = JDAC.convert_hf_dac_state_dict({k: v.float().numpy() for k, v in sd.items()})
    _assert_tree_equal(got, dac_params_from_jax(jax.tree.map(np.asarray, ref)))


def test_dac_converter_folds_weight_norm_pairs(hf_dac):
    """A state dict holding weight-norm pairs (the parametrization's
    original0/original1) converts to the folded weights torch computes."""
    import copy

    _, model = hf_dac
    wn = copy.deepcopy(model)
    wn.apply_weight_norm()
    sd = {k: v.detach() for k, v in wn.state_dict().items()}
    assert any(k.endswith("parametrizations.weight.original0") for k in sd)
    got = TDAC.convert_hf_dac_state_dict(sd)
    from torch.nn.utils import parametrize

    for m in wn.modules():  # fold each pair into its weight, as the forward pass computes it
        if parametrize.is_parametrized(m, "weight"):
            parametrize.remove_parametrizations(m, "weight", leave_parametrized=True)
    _assert_tree_equal(got, TDAC.convert_hf_dac_state_dict({k: v.detach() for k, v in wn.state_dict().items()}))


def test_dac_autoencoder_loads_the_cached_checkpoint(hf_dac, tmp_path, monkeypatch, caplog):
    d, _ = hf_dac
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    TDAC.DACAutoencoder(dtype=torch.float32, device="cpu")  # no cache: seeded weights, with a warning
    assert "random weights" in caplog.text
    snap = _fake_hub(tmp_path / "hub", "descript/dac_44khz", {"model.safetensors": d / "model.safetensors"})
    ae = TDAC.DACAutoencoder(dtype=torch.float32, device="cpu")
    _assert_tree_equal(ae.params, TDAC.convert_hf_dac_state_dict(SIO.load_file(str(d / "model.safetensors"))))
    (snap / "model.safetensors").write_bytes(b"\x10" + bytes(15))  # present but unreadable: raise
    with pytest.raises(ValueError, match="dac_44khz"):
        TDAC.DACAutoencoder(dtype=torch.float32, device="cpu")
    assert DACConfig().sampling_rate == 44100


# ---------------------------------------------------------------------------
# The port's native checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [None, 8, 4])
def test_native_checkpoint_round_trip(tmp_path, bits):
    model = Zonos.from_config(tiny_hybrid_config(), seed=6, dtype=torch.float32, device="cpu")
    if bits:
        model = model.quantize(bits=bits)
    TCK.save_checkpoint(str(tmp_path), model.params, model.config)
    back = TCK.load_checkpoint(str(tmp_path))
    _assert_tree_equal(back, model.params)
    assert ZonosConfig.from_json(str(tmp_path / "config.json")) == model.config
    if bits == 8:  # the int8 heads keep K1's padded rows
        assert back["heads"]["q"].stride() == model.params["heads"]["q"].stride()
    assert os.path.isfile(tmp_path / "params.pt")
