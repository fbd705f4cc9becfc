"""The port's host spans on the wall path (``Telemetry``'s overlay stream):
each rank's ``pickup`` and ``call`` with the pipeline's four phases
inside, and the plane's ``wait``, ``apply``, ``schedule`` and
``dispatch`` between one call and the next, all on the serve's clock
and naming the dispatch they serve.  The same engine without telemetry
records nothing and makes the same decisions; the simulator records
none of these spans; GFC times a registration only for telemetry."""
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.core.gfc import GroupFreeComm  # noqa: E402
from repro_torch.core.policies import make_policy  # noqa: E402
from repro_torch.core.scheduler import (ControlPlane,  # noqa: E402
                                        trace_signature)
from repro_torch.core.simulator import SimBackend  # noqa: E402
from repro_torch.core.telemetry import PLANE, Telemetry  # noqa: E402
from repro_torch.core.trajectory import Request  # noqa: E402
from repro_torch.diffusion import pipeline as pipeline_mod  # noqa: E402
from repro_torch.diffusion.adapters import convert_request  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

CFG = DIT_IMAGE.reduced()
PHASES = ("inputs", "forward", "sync", "writeback")
PLANE_OPS = ("wait", "apply", "schedule", "dispatch")


def _requests():
    # three equal requests at once: one rank encodes them in turn, the
    # packing policy steps them as packs, then decodes
    return [Request(id=f"r{i}", model=CFG.name, height=64, width=64,
                    steps=2, arrival=0.0) for i in range(3)]


def _serve(telemetry):
    eng = ServingEngine(CFG, make_policy("packing", 1), 1, device="cpu",
                        telemetry=telemetry)
    returned = []
    execute, packed = eng.pipeline.execute, eng.pipeline.execute_packed

    def keep(run):
        def call(*args):
            out = run(*args)
            returned.append(out)
            return out
        return call
    eng.pipeline.execute = keep(execute)
    eng.pipeline.execute_packed = keep(packed)
    try:
        eng.serve(_requests(), timeout=120.0)
        end = time.monotonic() - eng.backend.t0
        return eng.cp.events, end, returned
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def traced():
    tel = Telemetry()
    events, end, _ = _serve(tel)
    spans = [(r, t, t + dur, op, size, cause)
             for r, seq in tel.overlay.items()
             for t, dur, op, size, cause in seq]
    return {"tel": tel, "events": events, "end": end, "spans": spans}


def _of(spans, rank, op):
    return sorted((s for s in spans if s[0] == rank and s[3] == op),
                  key=lambda s: s[1])


def test_every_call_holds_one_of_each_phase(traced):
    spans = traced["spans"]
    calls = _of(spans, 0, "call")
    # 3 encodes, a pack a step, 3 decodes
    assert len(calls) == 8
    assert sum(c[5]["task"].startswith("pack-") for c in calls) == 2
    reqs = {e["pack"]: tuple(e["reqs"]) for e in traced["events"]
            if e["ev"] == "packed_dispatch"}
    reqs.update((e["task"], (e["req"],)) for e in traced["events"]
                if e["ev"] == "dispatch" and "pack" not in e)
    for r, t0, t1, _, _, cause in calls:
        kids = [s for s in spans if s[0] == r and s[3] in PHASES
                and s[5] == cause]
        assert [k[3] for k in sorted(kids, key=lambda k: k[1])] == \
            list(PHASES)
        kids.sort(key=lambda k: k[1])
        assert t0 <= kids[0][1] and kids[-1][2] <= t1
        # the phases tile the call's pipeline work, in order
        for a, b in zip(kids, kids[1:]):
            assert a[2] == b[1]
        assert cause["reqs"] == reqs[cause["task"]]
        by_op = {k[3]: k for k in kids}
        # inputs and sync carry the bytes they moved
        assert by_op["inputs"][4] > 0 and by_op["sync"][4] > 0
        assert by_op["forward"][4] == 0 and by_op["writeback"][4] == 0


def test_plane_spans_chain_each_completion_to_the_next_call(traced):
    spans = traced["spans"]
    calls = _of(spans, 0, "call")
    pickups = {s[5]["task"]: s for s in _of(spans, 0, "pickup")}
    plane = [s for s in spans if s[0] == PLANE]
    assert {s[3] for s in plane} == set(PLANE_OPS)
    for prev, nxt in zip(calls, calls[1:]):
        cause = prev[5]
        wait, = [s for s in plane if s[3] == "wait" and s[5] == cause]
        apply, = [s for s in plane if s[3] == "apply" and s[5] == cause]
        sched, = [s for s in plane if s[3] == "schedule" and s[5] == cause]
        disp, = [s for s in plane if s[3] == "dispatch"
                 and s[5] == nxt[5]]
        pickup = pickups[nxt[5]["task"]]
        # the wait starts at the completion's post, which ends the call
        assert wait[1] == pytest.approx(prev[2], abs=1e-9)
        assert wait[2] <= apply[1] <= apply[2] <= sched[1]
        # the dispatch runs inside the schedule point, and the rank's
        # pickup starts at its queue put
        assert sched[1] <= disp[1] <= pickup[1] <= disp[2] <= sched[2]
        assert pickup[2] == nxt[1]


def test_every_span_lies_within_the_serve(traced):
    assert traced["spans"]
    for _, t0, t1, _, _, _ in traced["spans"]:
        assert 0.0 <= t0 <= t1 <= traced["end"]


def test_perfetto_shows_phases_under_the_rank_and_hand_offs_under_the_plane(
        traced):
    events = traced["tel"].perfetto()["traceEvents"]
    cp_pid, = [e["pid"] for e in events if e.get("name") == "process_name"
               and e["args"]["name"] == "control-plane"]
    host = {e["name"] for e in events if e.get("cat") == "host"}
    assert host == {"pickup", "call", *PHASES}
    assert all((e["pid"], e["tid"]) == (0, 0) for e in events
               if e.get("cat") == "host")
    plane = [e for e in events if e.get("cat") == "plane"]
    assert {e["name"] for e in plane} == set(PLANE_OPS)
    assert all((e["pid"], e["tid"]) == (cp_pid, 0) for e in plane)
    assert all({"task", "seq", "reqs"} <= set(e["args"]) for e in plane)


def test_without_telemetry_nothing_is_timed_and_the_trace_is_the_same(
        traced, monkeypatch):
    clock = {"n": 0}

    class Counting:
        @staticmethod
        def monotonic():
            clock["n"] += 1
            return time.monotonic()
    monkeypatch.setattr(pipeline_mod, "time", Counting)
    events, _, returned = _serve(None)
    assert clock["n"] == 0
    assert len(returned) == 8 and all(r is None for r in returned)
    assert trace_signature(events) == trace_signature(traced["events"])


def test_the_simulator_records_no_host_span():
    tel = Telemetry()
    cost = CostModel()
    plane = ControlPlane(1, make_policy("packing", 1), cost,
                         SimBackend(cost), telemetry=tel)
    for r in _requests():
        plane.submit(r, convert_request(r, CFG))
    plane.run()
    assert all(q.done_time is not None for q in plane.requests.values())
    assert PLANE not in tel.overlay
    assert {op for seq in tel.overlay.values() for _, _, op, _, _ in seq} \
        <= {"migrate"}


@pytest.mark.parametrize("attached", [False, True])
def test_gfc_times_a_registration_only_for_telemetry(attached):
    comm = GroupFreeComm(4)
    tel = Telemetry()
    if attached:
        comm.telemetry = tel
    descs = [comm.register_group((0, 1)), comm.register_group((2, 3))]
    assert [d.gid for d in descs] == [0, 1]
    assert comm.stats == {"hierarchical": 0}
    assert len(tel.gfc_register_s) == (2 if attached else 0)
