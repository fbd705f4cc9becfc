"""The traffic generator: the same seed gives the same requests, and
every seed the same set of sizes and gaps in another order."""
from __future__ import annotations

import collections
import json
import math
from pathlib import Path

import pytest

from perfbench import traffic

REPO = Path(__file__).resolve().parents[2]
IMAGE = json.loads((REPO / "perfbench/configs/wan2.1-t2v-1.3b.json").read_text())
COST = json.loads((REPO / "perfbench/configs/wan2.1-t2v-1.3b.cost.json")
                  .read_text())
OPEN = json.loads((REPO / "perfbench/traffic/interactive_s90_m10.json")
                  .read_text())
BACKLOG = json.loads((REPO / "perfbench/traffic/backlog_s.json").read_text())


def gen(mix, seed, seconds=51.0):
    return traffic.generate(mix, IMAGE["model"], "dit-image", COST, seed,
                            seconds)


def test_same_seed_same_requests():
    big = 2 ** 31 + 12345
    assert gen(OPEN, big) == gen(OPEN, big)
    assert gen(OPEN, big) != gen(OPEN, big + 1)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 2 ** 33 + 1])
def test_every_seed_replays_one_schedule(seed):
    """The seed names the requests (their prompts and noise); when they
    come and how large they are is the mix's one schedule."""
    a, b = gen(OPEN, 3), gen(OPEN, seed)
    assert [(r.arrival, r.cls, r.deadline) for r in a] == \
        [(r.arrival, r.cls, r.deadline) for r in b]
    assert {r.id for r in a}.isdisjoint(r.id for r in b)
    n, rate = len(a), OPEN["rate_per_s"]
    assert n == round(rate * 51)
    assert collections.Counter(r.cls for r in a) == {"S": n - round(n / 10),
                                                     "M": round(n / 10)}
    # the gaps are the quantiles of the exponential distribution
    gaps = sorted(y.arrival - x.arrival for x, y in zip(a, a[1:]))
    quantiles = sorted(-math.log(1 - (i + 0.5) / n) / rate for i in range(n))
    assert all(any(abs(g - q) < 1e-9 for q in quantiles) for g in gaps)
    assert max(r.arrival for r in b) < 51.0
    # another schedule seed, another order of the same gaps and classes
    c = gen(dict(OPEN, schedule_seed=OPEN["schedule_seed"] + 1), seed)
    assert [r.arrival for r in c] != [r.arrival for r in a]
    assert collections.Counter(r.cls for r in c) == \
        collections.Counter(r.cls for r in a)


@pytest.mark.parametrize("seed", [2, 2 ** 31 + 5])
def test_poisson_schedule_is_drawn_from_the_seed(seed):
    """``"schedule": "poisson"``: i.i.d. exponential gaps and classes
    drawn from the run's seed, arrivals until the window closes."""
    mix = dict(OPEN, schedule="poisson")
    a, b = gen(mix, seed, 600.0), gen(mix, seed + 1, 600.0)
    assert a == gen(mix, seed, 600.0)
    assert [r.arrival for r in a] != [r.arrival for r in b]
    assert a[0].arrival == 0.0 and max(r.arrival for r in a) < 600.0
    rate = OPEN["rate_per_s"]
    gaps = [y.arrival - x.arrival for x, y in zip(a, a[1:])]
    assert len(a) == pytest.approx(rate * 600.0, rel=0.15)
    assert sum(gaps) / len(gaps) == pytest.approx(1.0 / rate, rel=0.15)
    # arrivals clump: the counts of 10 s bins vary as a Poisson count's
    # do (variance ~ mean)

    def bin_var(rs):
        counts = collections.Counter(int(r.arrival // 10) for r in rs)
        c = [counts[i] for i in range(60)]
        mean = sum(c) / 60
        return sum((x - mean) ** 2 for x in c) / 59, mean
    var, mean = bin_var(a)
    assert var == pytest.approx(mean, rel=0.6)
    assert sum(r.cls == "M" for r in a) / len(a) == pytest.approx(0.1,
                                                                  abs=0.04)


def test_classes_spread_by_block():
    rs = gen(OPEN, 11)
    block = OPEN["shuffle_block"]
    for i in range(0, len(rs) - block + 1, block):
        assert sum(r.cls == "M" for r in rs[i:i + block]) == 1


def test_deadlines_follow_the_frozen_table():
    r = next(r for r in gen(OPEN, 5) if r.cls == "M")
    t_c = (COST["table"]["dit-image|encode|4096|1"]
           + 4 * COST["table"]["dit-image|denoise|4096|1"]
           + COST["table"]["dit-image|decode|4096|1"])
    assert r.deadline == pytest.approx(r.arrival + 2.0 * t_c + 1.0)
    assert r.tokens == 4096 and r.steps == 4


def test_backlog_is_twice_the_predicted_completions():
    rs = gen(BACKLOG, 9, seconds=10.0)
    t_image = (4 * COST["pack_table"]["dit-image|denoise|1024|1|b8"]
               + 8 * (COST["table"]["dit-image|encode|1024|1"]
                      + COST["table"]["dit-image|decode|1024|1"])) / 8
    assert len(rs) == math.ceil(2.0 * 10.0 / t_image)
    assert {r.arrival for r in rs} == {0.0}
    assert all(r.deadline is None and r.tokens == 1024 for r in rs)


def test_closed_and_warmup():
    video = json.loads((REPO / "perfbench/configs/wan2.2-ti2v-5b.json")
                       .read_text())
    mix = json.loads((REPO / "perfbench/traffic/closed_video_l.json")
                     .read_text())
    vcost = json.loads((REPO / "perfbench/configs/wan2.2-ti2v-5b.cost.json")
                       .read_text())
    rs = traffic.generate(mix, video["model"], "dit-video", vcost, 4, 51.0)
    assert len(rs) == 1 and rs[0].tokens == 18480 and rs[0].steps == 50
    warm = traffic.warmup(mix, video["model"], "dit-video", vcost, 4)
    assert [[w.steps for w in b] for b in warm] == [[1]]
    assert traffic.cost_key("dit-video", "denoise", 18480) == \
        "dit-video|denoise|16384|1"
