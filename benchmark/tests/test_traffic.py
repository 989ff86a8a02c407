"""The generator: the same work for every seed, in another order."""

import json
import os

from benchmark import spec, traffic


def mixes():
    return {n: spec.traffic(n) for n in ("npc-stream", "npc-generate")}


def test_same_seed_same_requests():
    for mix in mixes().values():
        a = traffic.make_requests(mix, 2**31 + 17, 45, 0.8)
        b = traffic.make_requests(mix, 2**31 + 17, 45, 0.8)
        assert a == b


def test_seeds_differ_in_words_not_in_work():
    mix = mixes()["npc-stream"]
    a = traffic.make_requests(mix, 1, 45, 0.8)
    b = traffic.make_requests(mix, 2, 45, 0.8)
    assert [r.text for r in a] != [r.text for r in b]
    assert [r.seed for r in a] != [r.seed for r in b]
    # The same schedule and text lengths (hence token budgets) for every seed.
    assert [r.due for r in a] == [r.due for r in b]
    assert [len(r.text) for r in a] == [len(r.text) for r in b]
    assert [r.greedy for r in a] == [r.greedy for r in b]
    assert len(a) == len(b) == 36
    for reqs in (a, b):
        assert reqs[0].due == 0.0 and max(r.due for r in reqs) < 45
        assert all(20 <= len(r.text) <= 90 for r in reqs)
        assert sum(r.greedy for r in reqs) == 9
        assert all(0 <= r.voice < 8 for r in reqs)


def test_bodies_carry_the_request():
    mix = mixes()["npc-generate"]
    r = traffic.make_requests(mix, 5, 45, None)
    assert len(r) == mix["queue"]
    body = r[0].body(mix, "Zyphra/Zonos-v0.1-transformer")
    assert body["min_p"] == 1.0 and body["randomize_seed"] is False and body["speaker"].startswith("en/npc")
    assert json.loads(json.dumps(body)) == body
    assert os.path.exists(os.path.join(traffic.HERE, "traffic", mix["words"]))


def test_the_fleet_mix_is_the_engine_cells_lines():
    """The fleet cell's mix gives the engine cell's requests: only its rate,
    set in its cell file, differs."""
    stream, fleet = spec.traffic("npc-stream"), spec.traffic("npc-stream-fleet")
    assert {k: v for k, v in fleet.items() if k != "why"} == {k: v for k, v in stream.items() if k != "why"}
    assert traffic.make_requests(fleet, 2**31 + 5, 51, 6.8) == traffic.make_requests(stream, 2**31 + 5, 51, 6.8)
