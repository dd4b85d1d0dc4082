"""The port's spans and counters (`zkpoa_tpu_torch/utils/trace.py`) and
where the prover records them: the phases of `prover/prove.py`
`_prove_device`, the bytes it copies to its device and the places where
the host waits on the card."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zkpoa_tpu_torch import host
from zkpoa_tpu_torch.models import r1cs
from zkpoa_tpu_torch.ops import msm as M
from zkpoa_tpu_torch.ops import qap_eval
from zkpoa_tpu_torch.prover import ptau
from zkpoa_tpu_torch.prover import prove as P
from zkpoa_tpu_torch.prover.setup import setup_device
from zkpoa_tpu_torch.utils import trace

torch.set_num_threads(1)

PHASES = ["prove.upload", "prove.spmv", "prove.quotient", "prove.plans", "prove.g1_msms",
          "prove.g2_msm", "prove.assembly"]
STAGE = "layer1 prove batches [0]"
UPLOAD = ["prove.upload.limbs", "prove.upload.copy"]
MSM_HOST = "prove.msm.host"
LOGGED = ["witness upload", "QAP SpMV", "quotient h(X)", "MSM plans (c=5/5, 0 heavy values)",
          "a/b1/c/h G1 MSMs", "b2 G2 MSM", "assembly"]


def spans(events, name=None):
    return [e for e in events if e["kind"] == "span" and name in (None, e["name"])]


def counts(events, name):
    out = {}
    for e in events:
        if e["kind"] == "count" and e["name"] == name:
            out[e["site"]] = out.get(e["site"], 0) + e["n"]
    return out


def test_nothing_recorded_with_the_profiler_off_and_outside_collect():
    before = trace.events()
    with trace.span("off.outer", root=True) as s:
        trace.count("off.counter", 5, site="here")
    assert s is None
    assert trace.events() == before


def test_spans_nest_under_one_prove_id():
    with trace.collect() as events:
        with trace.span("stage"):
            with trace.span("prove", root=True):
                with trace.span("prove.upload"):
                    trace.count("bytes", 32, site="witness")
                trace.count("syncs", site="phase")
            with trace.span("prove", root=True):
                pass
    stage, = spans(events, "stage")
    first, second = spans(events, "prove")
    upload, = spans(events, "prove.upload")
    assert stage["parent"] is None and stage["prove"] is None
    assert first["parent"] == second["parent"] == stage["id"]
    assert first["prove"] == first["id"] != second["prove"] == second["id"]
    assert upload["parent"] == first["id"] and upload["prove"] == first["id"]
    c_bytes, c_syncs = [e for e in events if e["kind"] == "count"]
    assert (c_bytes["span"], c_bytes["prove"], c_bytes["n"]) == (upload["id"], first["id"], 32)
    assert (c_syncs["span"], c_syncs["prove"], c_syncs["site"]) == (first["id"], first["id"],
                                                                    "phase")
    assert first["t0"] <= upload["t0"] <= upload["t1"] <= first["t1"] <= stage["t1"]
    assert events == trace.events()[-len(events):]


def test_collect_blocks_nest_and_the_buffer_is_bounded():
    with trace.collect() as outer:
        trace.count("a")
        with trace.collect() as inner:
            trace.count("b")
        trace.count("c")
    assert [e["name"] for e in outer] == ["a", "b", "c"]
    assert [e["name"] for e in inner] == ["b"]
    assert trace.EVENTS_MAX >= 4096
    assert trace._events.maxlen == trace.EVENTS_MAX


def test_a_stage_is_a_span_of_its_name():
    tr = trace.Tracer(echo=False)
    with trace.collect() as events:
        with tr.stage("layer1 prove batches [0]"):
            with trace.span("prove", root=True):
                pass
    stage, = spans(events, "layer1 prove batches [0]")
    assert spans(events, "prove")[0]["parent"] == stage["id"]
    assert "layer1 prove batches [0]" in tr.timings


def test_the_profiler_turns_recording_on_with_ranges_of_the_same_name(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("profiled.outer"):
            with trace.span("profiled.inner"):
                trace.count("profiled.counter", 3)
    names = [e["name"] for e in trace.events()[-3:]]
    assert names == ["profiled.counter", "profiled.inner", "profiled.outer"]
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    ranges = {e["name"] for e in json.load(open(tmp_path / "t.json"))["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"profiled.outer", "profiled.inner"} <= ranges


@pytest.mark.parametrize("times", [None, {}])
def test_ptau_timed_synchronizes_only_for_its_times(monkeypatch, times):
    synced = []
    monkeypatch.setattr(ptau, "_sync", lambda device: synced.append(device))
    with trace.collect() as events:
        with ptau._timed(times, "read", "cpu"):
            pass
    assert [e["name"] for e in spans(events)] == ["read"]
    if times is None:
        assert synced == []
    else:
        assert synced == ["cpu", "cpu"] and times["read"] >= 0


def _circuit():
    """A product of 13 values: 13 constraints, 27 wires."""
    c = r1cs.Circuit()
    out = c.public_output()
    acc = c.var(3)
    for k in range(12):
        acc = c.mul(acc, c.var(k + 2))
    c.bind_output(out, acc)
    return c.compile()


@pytest.fixture(scope="module")
def proves(tmp_path_factory):
    """A setup under collect(), then two proves of one witness with the
    SpMV cut into chunks of 8 rows and `_sync` recording its calls: the
    first without `log` under collect(), inside a workflow stage that
    writes its profiler trace (as `workflow --profile` does), the second
    under collect() with `log`."""
    system, witness = _circuit()
    with trace.collect() as setup_events:
        key = setup_device(system, "cpu", seed="trace-test")
    logs = tmp_path_factory.mktemp("trace")
    out = {"system": system, "witness": witness, "key": key, "setup_events": setup_events}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qap_eval, "CHUNK_ROWS", 8)
        synced = []
        mp.setattr(P, "_sync", lambda device: synced.append(device))
        tr = trace.Tracer(log_dir=str(logs), profile=True, echo=False)
        with trace.collect() as events:
            with tr.stage(STAGE):
                out["proof"] = P.prove(key, system, witness, "cpu", seed="t")
        out["stage"], = spans(events, STAGE)
        out["events"] = [e for e in events if e is not out["stage"]]
        out["synced"] = list(synced)
        messages = []
        with trace.collect() as events:
            out["logged_proof"] = P.prove(key, system, witness, "cpu", seed="t",
                                          log=messages.append)
        out["logged_events"], out["logged_synced"] = events, synced[len(out["synced"]):]
        out["messages"] = messages
    path = logs / "torch_trace" / "layer1_prove_batches__0_.json"
    out["ranges"] = [e["name"] for e in json.load(open(path))["traceEvents"]
                     if e.get("cat") == "user_annotation"]
    return out


def test_a_prove_records_its_phase_and_upload_spans_in_order(proves):
    found = sorted(spans(proves["events"]), key=lambda e: e["t0"])
    root = found[0]
    assert root["name"] == "prove" and root["id"] == root["prove"]
    assert [e["name"] for e in found[1:]] == \
        PHASES[:1] + UPLOAD + PHASES[1:5] + [MSM_HOST, PHASES[5], MSM_HOST, PHASES[6]]
    assert all(e["prove"] == root["id"] for e in proves["events"])
    by_name = {e["name"]: e for e in found}
    for name in PHASES:
        assert by_name[name]["parent"] == root["id"]
    for name in UPLOAD:
        assert by_name[name]["parent"] == by_name["prove.upload"]["id"]
    g1_host, g2_host = spans(proves["events"], MSM_HOST)
    assert g1_host["parent"] == by_name["prove.g1_msms"]["id"]
    assert g2_host["parent"] == by_name["prove.g2_msm"]["id"]
    assert all(a["t1"] <= b["t0"] for a, b in zip(found[1:], found[2:]) if a["name"] in PHASES
               and b["name"] in PHASES)
    for name in ["prove"] + PHASES + UPLOAD:
        assert name in proves["ranges"], name


def test_h2d_bytes_are_the_arrays_the_prove_copies(proves):
    """A prove copies its witness alone: the setup before it put the SpMV
    operands (int32 index arrays, the pool) on the device once, and each
    prove's evaluation finds them there."""
    packed = proves["system"].pack()
    operands = packed.pool_limbs.nbytes + sum(
        a.nbytes for m in (packed.a, packed.b, packed.c) for a in (m.idx, m.wire, m.cid))
    setup = proves["setup_events"]
    assert counts(setup, "h2d_bytes") == {"spmv_operands": operands}
    assert counts(setup, "host_sync") == {"spmv_operands": 10}
    assert counts(setup, "spmv_operands") == {"fill": 1}
    want = {"witness": host.scalars_to_limbs_fast(proves["witness"]).nbytes}
    assert counts(proves["events"], "h2d_bytes") == want
    assert counts(proves["logged_events"], "h2d_bytes") == want
    for events in (proves["events"], proves["logged_events"]):
        assert counts(events, "spmv_operands") == {"hit": 1}
    syncs = counts(proves["events"], "host_sync")
    assert not any(site.startswith("spmv") for site in syncs)
    assert syncs["witness"] == 1 and syncs["msm_decode_g1"] == syncs["msm_decode_g2"] == 1
    # the witness and h plans each read their most pieces a bucket in their combine alone
    assert "plan.max_pieces" not in syncs and syncs["plan.combine"] >= 2
    assert all(n > 0 for n in syncs.values())


def test_host_syncs_repeat_across_proves_of_one_witness(proves):
    first = counts(proves["events"], "host_sync")
    second = counts(proves["logged_events"], "host_sync")
    assert "prove.phase" not in first
    assert second.pop("prove.phase") == len(PHASES)
    assert first == second
    a, b = proves["proof"], proves["logged_proof"]
    assert (a.pi_a, a.pi_b, a.pi_c) == (b.pi_a, b.pi_b, b.pi_c)


def test_prove_synchronizes_only_for_its_log(proves):
    assert proves["synced"] == []
    assert proves["logged_synced"] == ["cpu"] * len(PHASES)
    assert [m.rsplit(" ", 1)[0] for m in proves["messages"]] == [f"prove: {n}" for n in LOGGED]
    assert all(m.endswith("s") for m in proves["messages"])


def test_a_profiled_workflow_stage_names_the_prove_phases_in_its_trace(proves):
    """`workflow --profile` writes one chrome trace a stage; a prove inside
    the stage shows there as its phase and upload ranges, under the
    stage's own span."""
    root, = spans(proves["events"], "prove")
    assert root["parent"] == proves["stage"]["id"] and proves["stage"]["prove"] is None
    for name in [STAGE, "prove"] + PHASES + UPLOAD:
        assert name in proves["ranges"], name


def _heavy_circuit():
    """Values 0, 1, 5 and 7 on 20 wires each, every wire x in A and B of
    x (x - v) = 0, and a public product: a witness with heavy values."""
    c = r1cs.Circuit()
    out = c.public_output()
    for v in (0, 1, 5, 7):
        for _ in range(20):
            x = c.var(v)
            c.constrain(x, x - v, 0)
    c.bind_output(out, c.mul(c.var(3), c.var(11)))
    return c.compile()


def _without_new_tracing(mp):
    """Turns off the host span of `msm_many` and the `host_mul` counts."""
    span, count = trace.span, trace.count
    mp.setattr(trace, "span", lambda name, root=False: trace._OFF if name == MSM_HOST
               else span(name, root))
    mp.setattr(trace, "count", lambda name, n=1, site=None: None if name == "host_mul"
               else count(name, n, site))


@pytest.fixture(scope="module")
def heavy_proves():
    """One witness with heavy values (HEAVY_COUNT_MIN cut to 16) proved
    three times with one (r, s): without recording, under collect(), and
    under collect() with the host span and host_mul counts turned off."""
    system, witness = _heavy_circuit()
    out = {"witness": witness}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "HEAVY_COUNT_MIN", 16)
        key = setup_device(system, "cpu", seed="trace-heavy")
        out["off"] = P.prove(key, system, witness, "cpu", r=5, s=6)
        with trace.collect() as events:
            out["on"] = P.prove(key, system, witness, "cpu", r=5, s=6)
        out["events"] = events
        with pytest.MonkeyPatch.context() as inner:
            _without_new_tracing(inner)
            with trace.collect() as events:
                out["untraced"] = P.prove(key, system, witness, "cpu", r=5, s=6)
        out["untraced_events"] = events
    return out


def test_host_muls_are_counted_by_site(heavy_proves):
    """Five G1 and one G2 multiplications in the assembly; three G1 (the
    a, b1 and c queries) and one G2 (b2) for each heavy value other than 1."""
    values = {}
    for x in heavy_proves["witness"]:
        values[int(x)] = values.get(int(x), 0) + 1
    heavy = [v for v, n in values.items() if n >= 16 and v not in (0, 1)]
    assert sorted(heavy) == [5, 7] and values[1] >= 16
    assert counts(heavy_proves["events"], "host_mul") == {
        "heavy_g1": 3 * len(heavy), "heavy_g2": len(heavy), "assembly_g1": 5, "assembly_g2": 1}


def test_msm_host_spans_lie_inside_the_prove(heavy_proves):
    events = heavy_proves["events"]
    root, = spans(events, "prove")
    host = spans(events, MSM_HOST)
    parents = {e["id"]: e["name"] for e in spans(events)}
    assert [parents[e["parent"]] for e in host] == ["prove.g1_msms", "prove.g2_msm"]
    assert all(e["prove"] == root["id"] and root["t0"] <= e["t0"] <= e["t1"] <= root["t1"]
               for e in host)
    muls = [e for e in events if e["kind"] == "count" and e["name"] == "host_mul"]
    by_id = {e["id"]: e for e in host}
    assert all(by_id[e["span"]]["name"] == MSM_HOST for e in muls if e["site"].startswith("heavy"))


def test_host_tracing_adds_no_wait_and_keeps_the_proof(heavy_proves):
    on, off, untraced = heavy_proves["on"], heavy_proves["off"], heavy_proves["untraced"]
    assert (on.pi_a, on.pi_b, on.pi_c) == (off.pi_a, off.pi_b, off.pi_c) \
        == (untraced.pi_a, untraced.pi_b, untraced.pi_c)
    plain = heavy_proves["untraced_events"]
    assert not spans(plain, MSM_HOST) and not counts(plain, "host_mul")
    assert counts(heavy_proves["events"], "host_sync") == counts(plain, "host_sync")
    assert counts(plain, "host_sync")["plan.heavy_rows"] == 3 * 4  # values 0, 1, 5 and 7


def _limbs(values):
    return torch.from_numpy(host.scalars_to_limbs_fast(values))


@pytest.mark.parametrize("call,want", [
    (lambda: M.combine_levels(torch.zeros(1, dtype=torch.int64), 8), {}),
    (lambda: M.combine_levels(torch.tensor([0, 20]), 8),
     {"plan.combine": 3, "plan.piece_table": 1}),
    (lambda: M._heavy_split(_limbs(list(range(1, 301)))),
     {"plan.unique": 1, "plan.heavy_values": 1}),
    (lambda: M._heavy_split(_limbs([5] * M.HEAVY_COUNT_MIN + list(range(6, 50)))),
     {"plan.unique": 1, "plan.heavy_values": 2, "plan.heavy_rows": 3}),
    (lambda: M.plan_msm(_limbs(list(range(1, 65))), 5, split_heavy=False),
     {"plan.bincount": 2, "plan.piece_table": 1, "plan.combine": 1}),
], ids=["no-buckets", "one-cut", "no-heavy", "one-heavy", "plan"])
def test_host_syncs_are_counted_only_where_the_branch_waits(call, want):
    """An empty count skips its `max`, and an empty heavy-value search
    copies nothing to the host: neither is counted as a wait. A plan reads
    the most pieces a bucket has once, in its combine."""
    with trace.collect() as events:
        call()
    assert counts(events, "host_sync") == want
