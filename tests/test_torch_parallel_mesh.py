"""The port's tp layouts (``zonos_tpu_torch/parallel/mesh.py``) against the
JAX package's (``zonos_tpu/parallel/mesh.py``), on one process.

JAX's ``named`` and the port's over the same tiny models' params (float,
int8, int4; numpy arrays on JAX's side), leaf for leaf; each rank's shard shapes against JAX's ``shard_shape`` on 2
virtual devices; the ranks' shards put back together in head order (qkv by
heads, fc1 as [y | gate]) give every weight back; ``local_config``.
"""

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
