"""The port's tp layouts (``zonos_tpu_torch/parallel/mesh.py``) against the
JAX package's (``zonos_tpu/parallel/mesh.py``), on one process.

JAX's ``named`` and the port's over the same tiny models' params (float,
int8, int4; numpy arrays on JAX's side), leaf for leaf; each rank's shard shapes against JAX's ``shard_shape`` on 2
virtual devices; the ranks' shards put back together in head order (qkv by
heads, fc1 as [y | gate]) give every weight back; ``local_config``. At tp 4
(tiny models with 8 query and 4 KV heads): each rank's ``shard_params``
against JAX's ``shard_params`` on 4 virtual devices, shard for shard. The
launcher: ``_rank_main`` binds the rank's card before the group starts and
hands nccl that card; ``spawn`` refuses nccl without a card per rank before
any process starts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from zonos_tpu.config import tiny_hybrid_config as j_tiny_hybrid
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.parallel import mesh as JM
from zonos_tpu_torch.config import tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.parallel import mesh as TM
from zonos_tpu_torch.training.train import named_leaves

# (JAX config, port config, bits): the int4 transformer at d 256, so that
# its row-parallel weights have K / 128 = 2 groups to split
MODELS = {
    "transformer": (j_tiny(), tiny_transformer_config(), None),
    "transformer-int8": (j_tiny(), tiny_transformer_config(), 8),
    "transformer-int4": (j_tiny(d_model=256), tiny_transformer_config(d_model=256), 4),
    "hybrid": (j_tiny_hybrid(), tiny_hybrid_config(), None),
    "hybrid-int8": (j_tiny_hybrid(), tiny_hybrid_config(), 8),
}


def _flat(tree, prefix=""):
    """{path: leaf} with named_leaves' paths (dict keys sorted, None skipped)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree) for p, v in _flat(t, f"{prefix}{i}/").items()}
    return {} if tree is None else {prefix[:-1]: tree}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_numpy(v) for v in tree)  # JAX's groups are a tuple
    return None if tree is None else tree.numpy()


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(JAX config, port config, the params as numpy for JAX's side, the port's params)."""
    jcfg, tcfg, bits = MODELS[request.param]
    m = Zonos.from_config(tcfg, seed=0, dtype=torch.float32, device="cpu")
    if bits:
        m = m.quantize(bits=bits)
    tparams = {k: m.params[k] for k in ("embeddings", "heads", "backbone")}
    return jcfg, tcfg, _numpy(tparams), tparams


def _jax_shardings(jcfg, jparams):
    mesh = JM.make_mesh(jax.devices()[:2], dp=1, tp=2)
    return _flat(JM.named(mesh, JM.zonos_param_specs(jcfg), jparams))


def test_specs_match_jax(model):
    """Every leaf's full-rank spec equals JAX's NamedSharding spec."""
    jcfg, tcfg, jparams, tparams = model
    jsh = _jax_shardings(jcfg, jparams)
    jshapes = _flat(jparams)
    mine = TM.shard_axes(tcfg, tparams)
    assert sorted(mine) == sorted(jsh)
    for path, sh in jsh.items():
        entries = list(sh.spec) + [None] * (np.ndim(jshapes[path]) - len(sh.spec))
        want = entries.index("tp") if "tp" in entries else None
        assert mine[path] == want, (path, sh.spec)


def test_named_expands_quantized_dicts():
    """JAX's test_named_expands_quantized_dicts on the port: q takes the
    weight spec; s keeps the output axis, never its size-1 axis; int4 moves
    the K entry to the G axis."""
    from zonos_tpu_torch.ops.quant import quantize_int4, quantize_int8

    w = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 64, 32)), dtype=torch.float32)
    tree = {"col": quantize_int8(w), "row": quantize_int8(w), "g4": quantize_int4(w)}
    spec = {"col": TM.P(None, None, "tp"), "row": TM.P(None, "tp", None), "g4": TM.P(None, None, "tp")}
    sh = TM.named(spec, tree)
    assert sh["col"]["q"] == (None, None, "tp") and sh["col"]["s"] == (None, None, "tp")
    assert sh["row"]["q"] == (None, "tp", None) and sh["row"]["s"] == (None, None, None)
    assert sh["g4"]["q4"] == (None, None, None, "tp") and sh["g4"]["s4"] == (None, None, None, "tp")
    jmesh = JM.make_mesh(jax.devices()[:2], dp=1, tp=2)
    jtree = {k: {c: jnp.asarray(v.numpy()) for c, v in d.items()} for k, d in tree.items()}
    jsh = JM.named(jmesh, {"col": JP(None, None, "tp"), "row": JP(None, "tp", None), "g4": JP(None, None, "tp")},
                   jtree)
    for k in tree:
        for c in tree[k]:
            assert tuple(jsh[k][c].spec) == sh[k][c], (k, c)


def test_shard_shapes_match_jax(model):
    """Each rank's local leaf has JAX's shard shape on 2 devices and the whole
    leaf's dtype, and is contiguous (but the int8 heads' padded rows)."""
    jcfg, tcfg, jparams, tparams = model
    jsh = _jax_shardings(jcfg, jparams)
    whole = dict(named_leaves(tparams))
    jshapes = _flat(jparams)
    for r in range(2):
        local = dict(named_leaves(TM.shard_tree(tcfg, tparams, 2, r)))
        assert sorted(local) == sorted(jsh)
        for path, sh in jsh.items():
            want = sh.shard_shape(np.shape(jshapes[path]))
            assert tuple(local[path].shape) == tuple(want), (path, r)
            assert local[path].dtype == whole[path].dtype, path
            assert local[path].is_contiguous() or path == "heads/q", path


def _unshard(parts, axis, segments):
    """take_shard's inverse: each segment's pieces, in rank order."""
    tp, out, off = len(parts), [], 0
    for s in segments:
        w = s // tp
        out += [p.narrow(axis, off, w) for p in parts]
        off += w
    return torch.cat(out, dim=axis)


def test_ranks_shards_put_back_give_every_weight(model):
    """qkv re-packed by heads ([q_r | k_r | v_r]) and fc1 as [y_r | gate_r]:
    the ranks' shards, put back in head order, equal each whole weight (and
    its int8 / int4 scales); rank r holds q heads r·Hq/2.. and KV heads
    r·Hkv/2.. of the packed in_proj."""
    _jcfg, tcfg, _jparams, tparams = model
    whole = dict(named_leaves(tparams))
    axes = TM.shard_axes(tcfg, tparams)
    shards = [dict(named_leaves(TM.shard_tree(tcfg, tparams, 2, r))) for r in range(2)]
    bb = tcfg.backbone
    for path, axis in axes.items():
        if axis is None:
            assert all(torch.equal(s[path], whole[path]) for s in shards), path
            continue
        n = whole[path].shape[axis]
        segments = TM._column_segments(bb, path, n) if axis == whole[path].dim() - 1 else [n]
        assert torch.equal(_unshard([s[path] for s in shards], axis, segments), whole[path]), path
    attn = "backbone/layers/attn/in_proj" if not bb.is_hybrid else "backbone/groups/1/mixer/in_proj"
    hq, hkv, dh = bb.attn_cfg.num_heads, bb.attn_cfg.num_heads_kv, bb.head_dim
    w = whole.get(attn, whole.get(attn + "/q", whole.get(attn + "/q4")))
    r1 = shards[1].get(attn, shards[1].get(attn + "/q", shards[1].get(attn + "/q4")))
    q1 = r1[..., :hq // 2 * dh]
    k1 = r1[..., hq // 2 * dh:(hq // 2 + hkv // 2) * dh]
    assert torch.equal(q1, w[..., hq // 2 * dh:hq * dh])
    assert torch.equal(k1, w[..., (hq + hkv // 2) * dh:(hq + hkv) * dh])


def test_local_config_splits_heads_and_widths():
    cfg = TM.local_config(tiny_hybrid_config(), 2)
    bb, full = cfg.backbone, tiny_hybrid_config().backbone
    assert (bb.attn_cfg.num_heads, bb.attn_cfg.num_heads_kv) == (2, 1)
    assert bb.head_dim == full.head_dim == 16
    assert (bb.attn_mlp_d_intermediate, bb.d_intermediate) == (64, 64)
    assert bb.ssm_cfg == full.ssm_cfg and bb.d_model == full.d_model
    assert TM.local_config(tiny_hybrid_config(), 1) == tiny_hybrid_config()
    with pytest.raises(ValueError, match="num_heads_kv 2 does not split over tp=4"):
        TM.local_config(tiny_transformer_config(), 4)


def test_shards_placed_on_another_device_keep_the_heads_layout():
    """shard_tree onto another device (``meta`` here: shapes and strides, no
    values): the int8 heads keep their rows padded to 16 bytes (K1's TMA
    path), sharded leaves arrive contiguous."""
    m = Zonos.from_config(tiny_transformer_config(), seed=0, dtype=torch.float32, device="cpu").quantize()
    heads = m.params["heads"]["q"]
    assert heads.stride(0) % 16 == 0 and not heads.is_contiguous()
    local = TM.shard_tree(m.config, m.params, 2, 1, device="meta")
    assert local["heads"]["q"].device.type == "meta"
    assert local["heads"]["q"].shape == heads.shape and local["heads"]["q"].stride() == heads.stride()
    fc1 = local["backbone"]["layers"]["mlp"]["fc1"]["q"]
    assert fc1.is_contiguous() and fc1.shape[-1] == m.params["backbone"]["layers"]["mlp"]["fc1"]["q"].shape[-1] // 2


def _tp4(cfg):
    """``cfg`` with 8 query and 4 KV heads, so that attention splits over tp 4
    (one KV head per rank); JAX's and the port's configs alike."""
    bb = cfg.backbone
    attn = dataclasses.replace(bb.attn_cfg, num_heads=8, num_heads_kv=4)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(bb, attn_cfg=attn))


# The int4 transformer at d 512: 128 rows of out_proj per rank, one group of 128
MODELS_TP4 = {
    "transformer": (_tp4(j_tiny()), _tp4(tiny_transformer_config()), None),
    "transformer-int8": (_tp4(j_tiny()), _tp4(tiny_transformer_config()), 8),
    "transformer-int4": (_tp4(j_tiny(d_model=512)), _tp4(tiny_transformer_config(d_model=512)), 4),
    "hybrid": (_tp4(j_tiny_hybrid()), _tp4(tiny_hybrid_config()), None),
    "hybrid-int8": (_tp4(j_tiny_hybrid()), _tp4(tiny_hybrid_config()), 8),
}


def _split_by_heads(whole: np.ndarray, axis: int, segments: list[int], tp: int, r: int) -> np.ndarray:
    """Rank r's head-wise piece: the r-th of tp pieces of each segment, in order."""
    parts = np.split(whole, np.cumsum(segments)[:-1], axis=axis)
    return np.concatenate([np.split(p, tp, axis=axis)[r] for p in parts], axis=axis)


@pytest.mark.parametrize("name", sorted(MODELS_TP4))
def test_tp4_shard_params_match_jax_shard_for_shard(name):
    """Each rank's ``shard_params`` at dp 1 × tp 4 against the shard JAX's
    ``shard_params`` puts on the device at that tp index of a 4-device mesh:
    the same shape and dtype for every leaf, the same values for every
    replicated or contiguously split leaf; the packed qkv and fc1 hold that
    rank's heads and [y | gate] columns of the array JAX shards."""
    jcfg, tcfg, bits = MODELS_TP4[name]
    m = Zonos.from_config(tcfg, seed=0, dtype=torch.float32, device="cpu")
    if bits:
        m = m.quantize(bits=bits)
    params = {k: m.params[k] for k in ("embeddings", "heads", "backbone")}
    jmesh = JM.make_mesh(jax.devices()[:4], dp=1, tp=4)
    jsharded = _flat(JM.shard_params(jmesh, jcfg, _numpy(params)))
    whole = dict(named_leaves(params))
    axes = TM.shard_axes(tcfg, params)
    assert sorted(jsharded) == sorted(whole)
    n_headwise = 0
    for r in range(4):
        mesh = TM.Mesh(dp=1, tp=4, rank=r, device=torch.device("cpu"), dp_group=None, tp_group=None,
                       host_group=None)
        local = dict(named_leaves(TM.shard_params(mesh, tcfg, params)))
        for path, arr in jsharded.items():
            shard = next(s for s in arr.addressable_shards if s.device == jmesh.devices[0, r])
            want = np.asarray(shard.data)
            got = local[path].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, (path, r)
            axis = axes[path]
            last = axis is not None and axis == whole[path].dim() - 1
            segments = TM._column_segments(tcfg.backbone, path, whole[path].shape[axis]) if last else [None]
            if len(segments) == 1:
                np.testing.assert_array_equal(got, want, err_msg=f"{path} rank {r}")
            else:
                n_headwise += 1
                np.testing.assert_array_equal(got, _split_by_heads(np.asarray(arr), axis, segments, 4, r),
                                              err_msg=f"{path} rank {r}")
    assert n_headwise >= 4 * 2  # qkv and fc1 (and their int8 scales) on every rank


def test_local_config_at_tp4_of_the_published_models():
    """One tp 4 rank of the flagship and of Zonos-v0.1-hybrid: 4 query heads
    and 1 KV head of 128, MLP widths / 4, the Mamba2 dims whole."""
    from zonos_tpu_torch.config import zonos_v01_hybrid_config, zonos_v01_transformer_config

    t = TM.local_config(zonos_v01_transformer_config(), 4).backbone
    assert (t.attn_cfg.num_heads, t.attn_cfg.num_heads_kv, t.head_dim, t.attn_mlp_d_intermediate) == (4, 1, 128, 2048)
    full_h = zonos_v01_hybrid_config().backbone
    h = TM.local_config(zonos_v01_hybrid_config(), 4).backbone
    assert (h.attn_cfg.num_heads, h.attn_cfg.num_heads_kv, h.head_dim) == (4, 1, 128)
    assert (h.attn_mlp_d_intermediate, h.d_intermediate) == (2048, 1024)
    assert h.ssm_cfg == full_h.ssm_cfg and h.d_model == full_h.d_model == 2048


def _record_rank(backend, device, calls):
    calls.append(("fn", backend, device))
    return {"backend": backend, "calls": list(calls)}


@pytest.fixture
def four_cards(monkeypatch):
    """torch.cuda as on a host with four cards; set_device, init_process_group
    and destroy_process_group recorded in call order instead of run."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", torch.device(d))))
    monkeypatch.setattr(TM.dist, "init_process_group",
                        lambda backend, **kw: calls.append(("init", backend, kw.get("device_id"))))
    monkeypatch.setattr(TM.dist, "destroy_process_group", lambda *a: calls.append(("destroy",)))
    return calls


@pytest.mark.parametrize("backend,device,rank,want_device", [
    ("nccl", "cuda", 2, torch.device("cuda", 2)),
    ("gloo", "cuda", 3, torch.device("cuda", 3)),
    ("gloo", "cpu", 1, None),
])
def test_rank_main_binds_the_card_before_the_group_starts(four_cards, tmp_path, backend, device, rank,
                                                          want_device):
    """``_rank_main`` sets the rank's card first, then starts the group, with
    ``device_id`` that card for nccl only; then runs ``fn`` and ends the group."""
    import pickle

    calls = four_cards
    TM._rank_main(rank, _record_rank, 4, backend, device, str(tmp_path), (calls,), 30.0)
    device_id = want_device if backend == "nccl" else None
    want = ([("set_device", want_device)] if want_device is not None else []) + [
        ("init", backend, device_id), ("fn", backend, device), ("destroy",)]
    assert calls == want
    with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
        assert pickle.load(f) == {"backend": backend, "calls": want[:-1]}


@pytest.mark.parametrize("device,cards", [("cuda", 2), ("cpu", 4)])
def test_spawn_refuses_nccl_without_a_card_per_rank(monkeypatch, four_cards, device, cards):
    """nccl never falls back: 4 ranks on 2 cards, or on the CPU, raise before
    any process starts."""
    started = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.multiprocessing, "start_processes", lambda *a, **k: started.append(a))
    with pytest.raises(ValueError, match=f"nccl needs one card per rank: 4 ranks on {device}, {cards} cards"):
        TM.spawn(_record_rank, 4, "nccl", device, [])
    assert not started and not four_cards
