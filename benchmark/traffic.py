"""The one traffic generator: a mix file of ``benchmark/traffic`` plus a seed
gives the list of requests of a run.

Every seed gets the same work on the same schedule: the text lengths are
fixed quantiles of the mix's length distribution and the open loop's gaps
fixed quantiles of the exponential distribution, both put in one order by
the mix's ``schedule_seed``. The seed draws what the requests say: the
words, the voices and the request seeds. (Drawn per seed, the order moved
the engine's TTFA tail by ±15% between seeds, against ±5% between two runs
of one seed: where bursts fall sets the queueing, PERF.md.)
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Request:
    index: int
    due: float  # seconds after the window opens (open loop); 0 for a closed loop
    text: str
    voice: int
    seed: int
    greedy: bool

    def body(self, mix: dict, model_choice: str) -> dict:
        return {
            "text": self.text,
            "speaker": f"en/npc{self.voice}",
            "language": mix.get("language", "en-us"),
            "model_choice": model_choice,
            "seed": self.seed,
            "randomize_seed": False,
            "min_p": 1.0 if self.greedy else mix["min_p"],
            "cfg_scale": mix["cfg_scale"],
            "bench_id": self.index,
        }


def _words(name: str) -> list[str]:
    with open(os.path.join(HERE, "traffic", name)) as f:
        return [w.strip() for w in f.read().split() if w.strip()]


def _lengths(mix: dict, n: int) -> np.ndarray:
    """n text lengths: the midpoint quantiles of a log-normal with the mix's
    median and spread, clipped to its range."""
    c = mix["chars"]
    q = (np.arange(n) + 0.5) / n
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
    lens = np.exp(math.log(c["median"]) + c["sigma"] * z)
    return np.clip(np.round(lens), c["min"], c["max"]).astype(int)


def _text(rng: np.random.Generator, words: list[str], n_chars: int) -> str:
    """A sentence of exactly n_chars characters from the word list (the last
    word may be cut), so that every seed gets the same token budgets."""
    out: list[str] = []
    while len(" ".join(out)) < n_chars:
        out.append(words[int(rng.integers(len(words)))])
    s = " ".join(out)[: n_chars - 1]
    if s.endswith(" "):
        s = s[:-1] + "o"
    return s[0].upper() + s[1:] + "."


def _zipf_voices(rng: np.random.Generator, n: int, voices: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, voices + 1) ** s
    return rng.choice(voices, size=n, p=p / p.sum())


def make_requests(mix: dict, seed: int, seconds: float, rate: float | None) -> list[Request]:
    """The run's requests. Open loop: round(rate · seconds) requests due in
    [0, seconds). Closed loop: ``mix["queue"]`` requests sent one after another."""
    rng = np.random.default_rng([int(seed) % (2**63), 7])
    order = np.random.default_rng(int(mix["schedule_seed"]))
    n = max(int(round(rate * seconds)), 1) if mix["loop"] == "open" else int(mix["queue"])
    lens = order.permutation(_lengths(mix, n))
    words = _words(mix["words"])
    voices = _zipf_voices(rng, n, mix["voices"], mix["zipf_s"])
    seeds = rng.integers(1, 2**31 - 1, size=n)
    if mix["loop"] == "open":
        q = (np.arange(n) + 0.5) / n
        gaps = order.permutation(-np.log1p(-q))
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        due = due * (seconds * (n - 1) / n) / max(due[-1], 1e-9) if n > 1 else due
    else:
        due = np.zeros(n)
    every = int(mix["greedy_every"])
    return [Request(i, float(due[i]), _text(rng, words, int(lens[i])), int(voices[i]), int(seeds[i]), i % every == 0)
            for i in range(n)]
