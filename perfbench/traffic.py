"""The one traffic generator: a traffic mix is a JSON file of parameters
under ``perfbench/traffic/``, and this module turns it, the seed and the
run's length into requests.

Kinds of mix (``"kind"``):

* ``open_loop``: independent users, open loop, by the mix's
  ``schedule``:

  - ``stratified`` (the default): ``round(rate_per_s * seconds)``
    requests arrive over the window; the gaps are the quantiles
    ``(i + 0.5) / n`` of an exponential distribution of mean
    ``1 / rate_per_s``, the classes their shares of n (largest
    remainders).  Gaps and classes are dealt into blocks of
    ``shuffle_block``, so that each block holds one gap of every stratum
    and the classes in their shares, and each block is shuffled by the
    mix's ``schedule_seed``.  Every run replays that one schedule: the
    gaps of a Poisson process without its clumps, whose order at 0.8 of
    the knee moves the latencies far more than the run's seed should.
    So the seed draws what the requests hold (their prompts and noise,
    through their ids) and not when they come.
  - ``poisson``: a Poisson process drawn from the run's seed: i.i.d.
    exponential gaps of mean ``1 / rate_per_s`` until the window
    closes, each request's class drawn by the shares.

* ``backlog``: an offline batch submitted at once as the window opens:
  ``ceil(count_factor * seconds / t_image)`` requests, ``t_image`` the
  frozen cost table's time of one image in a pack of ``pack`` (denoise
  steps of the pack plus each member's encode and decode).
* ``closed``: ``clients`` clients, each with one request at the window's
  opening (a client's next request would follow its completion, and
  the mix's requests outlast the window).

Deadlines (``"deadline"``: ``alpha`` by class and ``allowance_s``) are
``arrival + alpha_c * T_c + allowance_s``, ``T_c`` the class's encode,
``steps`` denoise steps and decode in the frozen cost table; without a
``deadline`` entry requests are best-effort.  ``warmup`` lists the
bursts served before the window: ``{"class": C, "count": n}``, each one
serve call of n requests arriving at once.
"""
from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class RequestSpec:
    id: str
    cls: str
    height: int
    width: int
    frames: int
    steps: int
    arrival: float
    deadline: Optional[float]
    tokens: int


def token_count(model: dict, height: int, width: int, frames: int) -> int:
    f = max(1, (frames + 3) // 4) if frames > 1 else 1
    p = model["patch_size"]
    return f * (height // 8 // p) * (width // 8 // p)


def cost_key(model_name: str, kind: str, tokens: int, degree: int = 1,
             batch: int = 1) -> str:
    """The key of a cell of the port's cost table (a power-of-two token
    bucket; a batch of more than one is a pack's cell)."""
    bucket = 1 << max(0, int(math.log2(max(tokens, 1))))
    key = f"{model_name}|{kind}|{bucket}|{degree}"
    return key + f"|b{batch}" if batch > 1 else key


def stage_cost(cost: dict, model_name: str, kind: str, tokens: int,
               batch: int = 1) -> float:
    """Seconds of one call in the frozen cost table (``table`` and
    ``pack_table`` of the port's ``CostModel.save`` format)."""
    table = cost["pack_table"] if batch > 1 else cost["table"]
    return table[cost_key(model_name, kind, tokens, 1, batch)]


def service_time(cost: dict, model_name: str, tokens: int,
                 steps: int) -> float:
    """A lone request's encode, denoise steps and decode."""
    return (stage_cost(cost, model_name, "encode", tokens)
            + steps * stage_cost(cost, model_name, "denoise", tokens)
            + stage_cost(cost, model_name, "decode", tokens))


def _counts(shares: dict[str, float], n: int) -> dict[str, int]:
    """Largest-remainder split of n by ``shares``."""
    raw = {c: s * n for c, s in shares.items()}
    counts = {c: int(math.floor(v)) for c, v in raw.items()}
    left = n - sum(counts.values())
    for c in sorted(raw, key=lambda c: (counts[c] - raw[c], c))[:left]:
        counts[c] += 1
    return counts


def _spread(counts: dict[str, int], n: int) -> list[str]:
    """Classes laid out evenly over n slots, rarest first."""
    slots: list[Optional[str]] = [None] * n
    for c in sorted(counts, key=lambda c: (counts[c], c)):
        free = [i for i, s in enumerate(slots) if s is None]
        k = counts[c]
        for j in range(k):
            slots[free[int((j + 0.5) * len(free) / k)]] = c
    return slots  # type: ignore[return-value]


def _deal(items: list, block: int, rng: random.Random) -> list:
    """items (in stratum order) dealt round-robin into ceil(n/block)
    blocks, each block shuffled, the blocks concatenated."""
    nb = max(1, math.ceil(len(items) / block))
    blocks = [items[b::nb] for b in range(nb)]
    out = []
    for b in blocks:
        rng.shuffle(b)
        out.extend(b)
    return out


def _poisson(mix: dict, seed: int,
             seconds: float) -> tuple[list[float], list[str]]:
    """Arrivals of a Poisson process of ``rate_per_s`` over [0, seconds)
    and their classes, drawn from the run's seed."""
    rng = random.Random(seed)
    names = sorted(mix["classes"])
    shares = [mix["classes"][c]["share"] for c in names]
    arrivals, t = [], 0.0
    while t < seconds or not arrivals:
        arrivals.append(t)
        t += rng.expovariate(mix["rate_per_s"])
    return arrivals, rng.choices(names, shares, k=len(arrivals))


def generate(mix: dict, model: dict, model_name: str, cost: dict,
             seed: int, seconds: float,
             prefix: str = "r") -> list[RequestSpec]:
    """The window's requests of ``mix`` for ``seed`` and ``seconds``."""
    classes = mix["classes"]
    steps = mix["steps"]
    kind = mix["kind"]
    if kind == "open_loop" and mix.get("schedule") == "poisson":
        arrivals, cls = _poisson(mix, seed, seconds)
    elif kind == "open_loop":
        rate = mix["rate_per_s"]
        rng = random.Random(mix["schedule_seed"])
        n = max(1, round(rate * seconds))
        gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
        block = mix.get("shuffle_block", n)
        gaps = _deal(gaps, block, rng)
        cls = _spread(_counts({c: v["share"] for c, v in classes.items()},
                              n), n)
        # deal the evenly laid out classes block by block, then shuffle
        cls = [c for b in range(0, n, block)
               for c in rng.sample(cls[b:b + block], len(cls[b:b + block]))]
        arrivals = [0.0, *itertools.accumulate(gaps[:-1])]
    elif kind == "backlog":
        (c0, spec0), = classes.items()
        tok = token_count(model, spec0["height"], spec0["width"],
                          spec0["frames"])
        pack = mix["pack"]
        t_image = (steps * stage_cost(cost, model_name, "denoise", tok, pack)
                   + pack * (stage_cost(cost, model_name, "encode", tok)
                             + stage_cost(cost, model_name, "decode", tok))
                   ) / pack
        n = math.ceil(mix["count_factor"] * seconds / t_image)
        cls, arrivals = [c0] * n, [0.0] * n
    elif kind == "closed":
        (c0, _), = classes.items()
        n = mix["clients"]
        cls, arrivals = [c0] * n, [0.0] * n
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    return [_spec(mix, model, model_name, cost, f"{prefix}{seed}-{i:05d}",
                  c, a) for i, (c, a) in enumerate(zip(cls, arrivals))]


def warmup(mix: dict, model: dict, model_name: str, cost: dict,
           seed: int) -> list[list[RequestSpec]]:
    """The bursts served before the window, as lists of requests."""
    out = []
    for j, burst in enumerate(mix.get("warmup", [])):
        out.append([_spec(mix, model, model_name, cost,
                          f"w{seed}-{j}-{i}", burst["class"], 0.0,
                          steps=burst.get("steps"))
                    for i in range(burst["count"])])
    return out


def _spec(mix, model, model_name, cost, rid, cls, arrival,
          steps=None) -> RequestSpec:
    c = mix["classes"][cls]
    steps = steps or mix["steps"]
    tok = token_count(model, c["height"], c["width"], c["frames"])
    deadline = None
    dl = mix.get("deadline")
    if dl is not None:
        deadline = (arrival + dl["alpha"][cls]
                    * service_time(cost, model_name, tok, steps)
                    + dl["allowance_s"])
    return RequestSpec(rid, cls, c["height"], c["width"], c["frames"],
                       steps, arrival, deadline, tok)
