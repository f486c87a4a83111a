"""Every traffic mix gives byte-identical inputs for one seed and other
inputs for another, seeds beyond 32 bits included; each names a generator
that exists."""

from __future__ import annotations

import json

import numpy as np
import pytest
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

from mindbench import traffic as T

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))
SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)


def _mix(name):
    mix = T.load(BENCH / "traffic" / f"{name}.json")
    mix.setdefault("name", name)
    return mix


def _gen(mix):
    return T.generator(BENCH, mix["kind"])


def _requests(mix, seed, n=40, vocab=151936):
    """The first ``n`` requests of a source whose requests finish oldest
    first, one at a time."""
    s = _gen(mix).Source(mix, vocab=vocab, seed=seed)
    flying = s.start(0.0)
    out = list(flying)
    while len(out) < n:
        tag = flying.pop(0)[0]
        new = s.finished(tag, 0.0) + s.due(0.0)
        flying += new
        out += new
    return out[:n]


def _draw(mix, seed):
    if _gen(mix).FORM == "trace":
        t = _gen(mix).make(dict(mix, accesses_per_thread=500), threads=8,
                           seed=seed)
        return b"".join(t[k].tobytes() for k in ("threads", "ops", "offsets"))
    return b"".join(p.tobytes() + np.array([n], np.int32).tobytes()
                    for _, p, n in _requests(mix, seed))


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_bytes(name, seed):
    mix = _mix(name)
    assert _draw(mix, seed) == _draw(mix, seed)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_bytes(name):
    mix = _mix(name)
    assert len({_draw(mix, s) for s in SEEDS}) == len(SEEDS)


@pytest.mark.parametrize("name", [m for m in MIXES
                                  if _gen(_mix(m)).FORM == "requests"])
def test_every_seed_serves_the_same_sizes(name):
    """The lengths of a cycle are one set for every seed, in another order."""
    mix = _mix(name)
    k = mix["length_set"]
    sizes = []
    for seed in SEEDS[:3]:
        reqs = _requests(mix, seed, n=k, vocab=1000)
        sizes.append(sorted(n for _, _, n in reqs))
    assert sizes[0] == sizes[1] == sizes[2]


@pytest.mark.parametrize("name", ["shared-prefix"])
def test_repeats_share_an_in_flight_prompt(name):
    """Every ``repeat_every``-th request repeats the prompt of a request
    of another client that is still in flight."""
    mix = _mix(name)
    s = _gen(mix).Source(mix, vocab=1000, seed=3)
    flying = {tag: p for tag, p, _ in s.start(0.0)}
    repeats = 0
    for count in range(len(flying) + 1, 200):
        tag = next(iter(flying))
        del flying[tag]
        [(new, prompt, _)] = s.finished(tag, 0.0)
        assert new == tag
        if count % mix["repeat_every"] == 0:
            assert any(np.array_equal(prompt, p) for p in flying.values())
            repeats += 1
        flying[tag] = prompt
    assert repeats >= 20


def test_replay_mix_shapes():
    gen = _gen(_mix("ycsb-a"))
    ycsb = gen.make(dict(_mix("ycsb-a"), accesses_per_thread=200),
                    threads=80, seed=5)
    assert len(ycsb["ops"]) == 16000 and ycsb["shared_bytes"] == 24 << 20
    assert 0.45 < ycsb["ops"].mean() < 0.55
    tf = gen.make(_mix("tf"), threads=80, seed=5)
    assert len(tf["ops"]) == 80_000
    assert tf["arena_bytes"] == (8 << 20) + 80 * (24 << 20)
    assert (tf["offsets"] < (8 << 20)).mean() < 0.05


def test_mix_files_are_data():
    for p in (BENCH / "traffic").iterdir():
        assert p.suffix == ".json"
        assert (BENCH / "generators" / f"{json.loads(p.read_text())['kind']}.py").is_file()


def test_a_generator_of_another_form_is_refused():
    with pytest.raises(ValueError):
        T.generator(BENCH, "replay", form="requests")
    with pytest.raises(FileNotFoundError):
        T.generator(BENCH, "no-such-kind")
