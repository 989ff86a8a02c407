"""The port's profiling helpers (``zonos_tpu_torch/utils/profiling.py``), on
the CPU: the device timer, the Chrome trace, the memory table of a call (a
decode step of the tiny model among them), the per-card table and the RTF
log line, with the JAX package's RTF for the same numbers."""

import json
import logging

import numpy as np
import torch

from zonos_tpu.utils import profiling as J
from zonos_tpu_torch.utils import profiling as P


def test_device_timer():
    with P.device_timer("t") as t:
        y = torch.ones((64, 64)) @ torch.ones((64, 64))
        t.wait_for({"y": [y]})
    assert t.elapsed_s > 0 and float(y[0, 0]) == 64.0


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with P.torch_trace(str(tmp_path / "logs")) as prof:
        torch.ones((32, 32)).matmul(torch.ones((32, 32)))
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert prof.trace_path.startswith(str(tmp_path / "logs"))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_memory_report_contents():
    a, b = torch.ones((64, 128)), torch.ones((128, 256))
    table = P.memory_report(lambda x, y: (x @ y).sum(dim=0), a, b)
    assert "arguments" in table and "outputs" in table and "total live" in table
    # argument bytes: 64*128*4 + 128*256*4 = 163840 B: about 0.16 MB
    args_line = next(line for line in table.splitlines() if line.startswith("arguments"))
    assert abs(float(args_line.split("|")[1]) - 163840 / 2**20) < 0.01
    assert "temps not measured" in table  # no CUDA tensor: the allocator is not read


def test_memory_report_on_decode_step():
    """The table works on a real decode step of the tiny model."""
    from zonos_tpu_torch.config import tiny_transformer_config
    from zonos_tpu_torch.models.transformer import KVCache
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.runtime.generate import GenerateStatics, _decode_logits

    cfg = tiny_transformer_config()
    model = Zonos.from_config(cfg, seed=0, dtype=torch.float32, device="cpu")
    statics = GenerateStatics(cfg=cfg, sampling=SamplingParams(min_p=0.1), prefill_len=32, delayed_len=64,
                              cache_len=128, batch_size=1)
    cache = KVCache.create(cfg.backbone, 2, 128, torch.float32)

    def step(params, tok, cache):
        return _decode_logits(params, statics, tok, cache, 32, torch.zeros((2,), dtype=torch.int32), 2.0)

    table = P.memory_report(step, model.params, torch.zeros((1, 9, 1), dtype=torch.int32), cache)
    assert "total live" in table


def test_device_memory_table_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P.device_memory_table() == "no CUDA devices"


def test_log_rtf_equals_jax(caplog):
    with caplog.at_level(logging.INFO, logger="zonos_tpu_torch"):
        rtf = P.log_rtf(5.0, 2.0, "req")
    assert np.isclose(rtf, J.log_rtf(5.0, 2.0, "req")) and rtf == 2.5
    assert P.log_rtf(1.0, 0.0) == 0.0 == J.log_rtf(1.0, 0.0)
    assert any("RTF req: 5.00s audio / 2.00s wall = 2.50x realtime" in r.message for r in caplog.records)
