"""The port's LoRA fine-tuning (``zonos_tpu_torch/training/lora.py`` and
``training/finetune_lora.py``), mirroring ``tests/test_lora.py`` and held
against the JAX package's on the same params (bridged) and batch.

Tiny transformer (d 64, 2 layers), float32 on the CPU: the initial adapter
is a no-op, training lowers the loss and leaves the base bit-unchanged, the
merge equals the adapter forward and the unmerged x·W + scale·(x·A)·B
forward, quantized and missing targets are refused,
adapters round-trip through .npz and each package reads the other's file, a
LoRA step on a JAX-bridged adapter equals JAX's at 1e-5, and the CLI writes
an adapter, a merged native checkpoint and a reference export that
``Zonos.from_local`` reads back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.training import lora as JL
from zonos_tpu.training import train as JT
from zonos_tpu_torch.bridge import lora_from_jax, params_from_jax
from zonos_tpu_torch.config import tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.training import lora as TL
from zonos_tpu_torch.training import train as TT
from tests.test_torch_training import batch


@pytest.fixture(scope="module")
def base():
    """The JAX model's float params and the port's bridged copy."""
    jm = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32)
    jparams = {k: jm.params[k] for k in ("embeddings", "heads", "backbone")}
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _train(params, steps, seed=0):
    cfg = tiny_transformer_config()
    lora = TL.init_lora(params["backbone"], rank=4, seed=1)
    opt = TT.make_optimizer(lr=3e-3, warmup=1)
    state = TL.init_lora_state(lora, opt)
    step = TL.build_lora_train_step(cfg, opt, params)
    cond, delayed, mask = batch(seed=seed)
    losses = []
    for _ in range(steps):
        state, loss = step(state, cond, delayed, mask)
        losses.append(float(loss))
    return state, losses


def test_lora_initial_adapter_is_noop(base):
    _jparams, params = base
    lora = TL.init_lora(params["backbone"], rank=4, seed=1)
    merged = TL.merge_lora(params["backbone"], lora, scale=2.0)
    assert set(lora) == set(TL.DEFAULT_TARGETS)
    for path, adapter in lora.items():
        assert adapter["a"].shape[-1] == 4 and not adapter["b"].any()
        assert torch.equal(TL._get(merged, path), TL._get(params["backbone"], path))
    # A ~ N(0, 1/rank), from a torch.Generator: replayable from the seed
    assert torch.equal(TL.init_lora(params["backbone"], rank=4, seed=1)["layers/mlp/fc1"]["a"],
                       lora["layers/mlp/fc1"]["a"])
    np.testing.assert_allclose(float(lora["layers/mlp/fc1"]["a"].std()), 0.5, rtol=0.05)


def test_lora_train_reduces_loss_and_freezes_base(base):
    _jparams, params = base
    snapshot = {p: t.clone() for p, t in TT.named_leaves(params)}
    state, losses = _train(params, 6)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(torch.equal(t, snapshot[p]) for p, t in TT.named_leaves(params))  # the base, bit-unchanged
    assert not any(t.requires_grad for _, t in TT.named_leaves(params))
    assert float(state.lora["layers/mlp/fc1"]["b"].abs().sum()) > 0.0


def test_lora_merge_matches_adapter_forward(base):
    """merge_lora folds the trained adapter so the plain loss_fn reproduces
    the adapter forward: the deployment path."""
    _jparams, params = base
    cfg = tiny_transformer_config()
    state, _ = _train(params, 3, seed=3)
    cond, delayed, mask = batch(seed=3)
    merged = dict(params)
    merged["backbone"] = TL.merge_lora(params["backbone"], state.lora, scale=2.0)
    l_merged = float(TT.loss_fn(merged, cfg, cond, delayed, mask))
    nll, w = TL.lora_loss_terms(params, cfg, state.lora, cond, delayed, mask, scale=2.0)
    l_adapter = float(nll / w)
    np.testing.assert_allclose(l_merged, l_adapter, rtol=1e-6)
    logits = TT.forward_logits(merged, cfg, cond, delayed[..., :-1])
    ref = TT.forward_logits(params, cfg, cond, delayed[..., :-1])
    assert not torch.allclose(logits, ref)  # the merged adapter moved the model


def test_lora_merge_matches_unmerged_forward(base):
    """The merged weights give the logits of the adapter applied beside the
    frozen weights, x·W + scale·(x·A)·B, never merged (chip_smoke's phase 11
    reference, which must meet every target of every layer once)."""
    from chip_smoke import _unmerged_logits

    _jparams, params = base
    cfg = tiny_transformer_config()
    state, _ = _train(params, 3, seed=4)
    cond, delayed, _mask = batch(seed=4)
    merged = dict(params)
    merged["backbone"] = TL.merge_lora(params["backbone"], state.lora, scale=2.0)
    with torch.no_grad():
        got = TT.forward_logits(merged, cfg, cond, delayed[..., :-1])
        ref = _unmerged_logits(params, cfg, state.lora, 2.0, cond, delayed[..., :-1])
        plain = TT.forward_logits(params, cfg, cond, delayed[..., :-1])
    err = float((got - ref).norm() / ref.norm())
    effect = float((ref - plain).norm() / ref.norm())
    assert err < 1e-6 and effect > 1e3 * err, (err, effect)


def test_lora_rejects_quantized_and_missing_targets(base):
    _jparams, params = base
    with pytest.raises(KeyError):
        TL.init_lora(params["backbone"], targets=("layers/attn/nope",))
    model = Zonos.from_config(tiny_transformer_config(), seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError):
        TL.init_lora(model.quantize().params["backbone"], rank=4)


def test_lora_npz_roundtrip_and_across_packages(tmp_path, base):
    jparams, params = base
    lora = TL.init_lora(params["backbone"], rank=4, seed=2)
    lora["layers/attn/out_proj"]["b"] += 0.5  # a non-zero factor too
    p = str(tmp_path / "adapter.npz")
    TL.save_lora_npz(p, lora)
    back = TL.load_lora_npz(p)
    assert set(back) == set(lora)
    for target in lora:
        for f in ("a", "b"):
            assert torch.equal(back[target][f], lora[target][f])
    # the port's file read by JAX's loader, and JAX's by the port's
    jback = JL.load_lora_npz(p)
    for target in lora:
        np.testing.assert_array_equal(np.asarray(jback[target]["b"]), lora[target]["b"].numpy())
    jlora = JL.init_lora(jparams["backbone"], rank=4, seed=5)
    jp = str(tmp_path / "jax_adapter.npz")
    JL.save_lora_npz(jp, jlora)
    tback = TL.load_lora_npz(jp)
    for target in jlora:
        np.testing.assert_array_equal(tback[target]["a"].numpy(), np.asarray(jlora[target]["a"]))


def test_lora_steps_match_jax(base):
    """A JAX adapter (bridged by ``lora_from_jax``) through 3 LoRA steps of each
    package (warmup 1: the first at lr 0): losses and factors at 1e-5."""
    jparams, params = base
    jcfg, tcfg = j_tiny(), tiny_transformer_config()
    jlora = JL.init_lora(jparams["backbone"], rank=4, seed=7)
    rng = np.random.default_rng(7)
    for adapter in jlora.values():  # B non-zero (and not constant): both factors take gradients
        adapter["b"] = jnp.asarray(rng.normal(size=adapter["b"].shape).astype(np.float32) * 0.01)
    tlora = lora_from_jax(jax.tree.map(np.asarray, jlora))
    jopt, topt = JT.make_optimizer(lr=1e-3, warmup=1), TT.make_optimizer(lr=1e-3, warmup=1)
    jstate, tstate = JL.init_lora_state(jlora, jopt), TL.init_lora_state(tlora, topt)
    jstep = jax.jit(JL.build_lora_train_step(jcfg, jopt, jparams))
    tstep = TL.build_lora_train_step(tcfg, topt, params)
    cond, delayed, mask = batch(seed=8)
    for _ in range(3):
        jstate, jloss = jstep(jstate, cond, delayed, mask)
        tstate, tloss = tstep(tstate, cond, delayed, mask)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for target in jlora:
        for f in ("a", "b"):
            want = np.asarray(jstate.lora[target][f])
            np.testing.assert_allclose(tstate.lora[target][f].numpy(), want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{target}/{f}")


def test_finetune_lora_cli(tmp_path):
    """``python -m zonos_tpu_torch.training.finetune_lora --synthetic`` on the
    CPU writes the adapter, the merged native checkpoint and the reference
    export; ``Zonos.from_local`` reads the export back."""
    from zonos_tpu_torch.training import finetune_lora
    from zonos_tpu_torch.utils.checkpoint import load_checkpoint

    adapter, merged, ref = (str(tmp_path / n) for n in ("adapter.npz", "merged", "reference"))
    rc = finetune_lora.main(["--synthetic", "4", "--model", "tiny", "--steps", "3", "--batch", "2",
                             "--frames", "24", "--out", adapter, "--merge", merged, "--export-reference", ref,
                             "--device", "cpu"])
    assert rc == 0
    lora = TL.load_lora_npz(adapter)
    assert "layers/mlp/fc1" in lora and lora["layers/mlp/fc1"]["b"].any()
    ckpt = load_checkpoint(merged)
    assert "backbone" in ckpt and "prefix_conditioner" in ckpt
    back = Zonos.from_local(f"{ref}/config.json", f"{ref}/model.safetensors", dtype=torch.float32, device="cpu")
    w = back.params["backbone"]["layers"]["mlp"]["fc1"]
    want = ckpt["backbone"]["layers"]["mlp"]["fc1"]
    torch.testing.assert_close(w, want.to(torch.bfloat16).float())  # the export is bf16
    # the merged weights are the base plus the adapter
    base = Zonos.from_config(tiny_transformer_config(), seed=0, dtype=torch.float32, device="cpu")
    fc1 = TL.merge_lora(base.params["backbone"], lora)["layers"]["mlp"]["fc1"]
    torch.testing.assert_close(want, fc1)
    # a second run adapts the merged checkpoint (--weights, native layout)
    rc = finetune_lora.main(["--synthetic", "2", "--weights", merged, "--steps", "1", "--batch", "1", "--frames",
                             "12", "--out", str(tmp_path / "again.npz"), "--device", "cpu"])
    assert rc == 0


def test_finetune_lora_needs_data(tmp_path):
    from zonos_tpu_torch.training import finetune_lora

    assert finetune_lora.main(["--device", "cpu"]) == 2
    assert finetune_lora.main(["--data", str(tmp_path), "--device", "cpu"]) == 2  # no (wav, txt) pairs
