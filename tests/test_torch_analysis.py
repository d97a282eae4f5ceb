"""The port's persistence analysis (``repro_torch.analysis``) against the
JAX package's on the CPU: ``trace_scenario`` of each of the six crash
scenarios gives the reference's event stream, event for event, and the
port's ``check_events`` passes it with no finding; both checkers give
identical reports on mutated streams and on live ``PMem`` traces; and the
port's ``run_static`` gives the reference's report over both packages'
trees.  Every comparison is exact."""
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from repro.analysis import checker as RC
from repro.analysis import persistlint as RL
from repro.analysis import trace as RT
from repro.core import harris_list as RH
from repro.core import pmem as RP
from repro.core import policies as RPol
from repro.core import traversal as RTr
from repro.persistence.manifest import StagedIO as RIO
from repro_torch import analysis as TA
from repro_torch.analysis import checker as TC
from repro_torch.analysis import persistlint as TL
from repro_torch.analysis import trace as TT
from repro_torch.core import harris_list as TH
from repro_torch.core import pmem as TP
from repro_torch.core import policies as TPol
from repro_torch.core import traversal as TTr
from repro_torch.persistence.manifest import StagedIO as TIO

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
SCENARIOS = ("log", "log2", "checkpoint", "migrate", "rebalance", "ordered")


@pytest.fixture(scope="module")
def streams():
    """Every scenario traced once in each package (the port's on the
    CPU)."""
    return {layer: (RT.trace_scenario(layer).events,
                    TT.trace_scenario(layer, {"device": "cpu"}).events)
            for layer in SCENARIOS}


def as_dicts(xs) -> list:
    return [x.to_dict() for x in xs]


def test_the_analysis_package_exports_the_references_names():
    import repro.analysis as ref
    assert TA.__all__ == ref.__all__
    assert TT.EVENT_KINDS == RT.EVENT_KINDS
    assert (TC.FATAL_RULES, TC.DIAG_RULES) == (RC.FATAL_RULES, RC.DIAG_RULES)
    assert TL.RULES == RL.RULES


@pytest.mark.parametrize("layer", SCENARIOS)
def test_trace_equals_the_references_and_checks_clean(streams, layer):
    ref, port = streams[layer]
    assert as_dicts(port) == as_dicts(ref)
    assert len(port) == cs.TRACE_EVENTS[layer]
    rep = TC.check_events(port)
    assert rep.ok and rep.diagnostics == []
    assert rep.to_dict() == RC.check_events(ref).to_dict()


def test_rebalance_at_four_shards_traces_clean():
    """The four-shard window, which the reference traces only with four
    forced host devices: the port's stream keeps the single shard's
    count and kinds and checks clean."""
    events = TT.trace_scenario("rebalance", {"device": "cpu",
                                             "n_shards": 4}).events
    assert len(events) == cs.TRACE_EVENTS["rebalance4"]
    rep = TC.check_events(events)
    assert rep.ok and rep.diagnostics == []


def test_paper_phase_traces_on_the_cpu():
    out = cs.paper_traces(CPU)
    assert {k: v["events"] for k, v in out.items()} == cs.TRACE_EVENTS


# the mutations of tests/test_persistlint.py, on the log scenario's stream
def _deleted_fence(ev):
    pub = [e for e in ev if e.kind == "publish" and e.src][-1]
    fence = [e for e in ev if e.kind == "fence" and e.index < pub.index][-1]
    return [e for e in ev if e.index != fence.index], True


def _dropped_flush(ev):
    pub = [e for e in ev if e.kind == "publish" and e.src][-1]
    victim = [e for e in ev if e.kind == "flush" and e.target == pub.src
              and e.index < pub.index][-1]
    return [e for e in ev if e.index != victim.index], True


def _traverse_flush(ev):
    cls = type(ev[0])
    return list(ev) + [cls(len(ev), "flush", "line:7", in_traverse=True)], \
        False


def _duplicated_flush(ev):
    first = next(e for e in ev if e.kind == "flush")
    return ev[:first.index + 1] + [first] + ev[first.index + 1:], True


def _trailing_fence(ev):
    return list(ev) + [type(ev[0])(len(ev), "fence", "")], True


MUTATIONS = {"deleted_fence": (_deleted_fence, ["publish-before-persist"],
                               []),
             "dropped_flush": (_dropped_flush, ["missing-flush"],
                               ["fence-with-nothing-pending"]),
             "traverse_flush": (_traverse_flush,
                                ["traversal-phase-persistence"], []),
             "duplicated_flush": (_duplicated_flush, [], ["redundant-flush"]),
             "trailing_fence": (_trailing_fence, [],
                                ["fence-with-nothing-pending"])}


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_mutated_streams_give_identical_reports(streams, mutation):
    mutate, fatal, diag = MUTATIONS[mutation]
    ref, port = streams["log"]
    (rm, end_check), (pm, _) = mutate(list(ref)), mutate(list(port))
    r = RC.check_events(rm, end_check=end_check)
    t = TC.check_events(pm, end_check=end_check)
    assert t.to_dict() == r.to_dict()
    assert [f.rule for f in t.violations] == fatal
    assert [f.rule for f in t.diagnostics] == diag


def test_unknown_event_kind_raises_in_both():
    for cls, check in ((RT.PersistEvent, RC.check_events),
                       (TT.PersistEvent, TC.check_events)):
        with pytest.raises(ValueError, match="unknown event kind"):
            check([cls(0, "sync", "a")])
    for trace in (RT.PersistTrace(), TT.PersistTrace()):
        with pytest.raises(ValueError, match="unknown event kind"):
            trace.on_event("sync", "a")


def _leaky(base):
    class LeakyPolicy(base):
        def after_read(self, ctx, addr, *, immutable):
            ctx.flush(addr)            # regardless of phase: leaks
    return LeakyPolicy()


@pytest.mark.parametrize("leaky", [False, True])
def test_live_pmem_list_traces_equal(leaky):
    """``tests/test_persistlint.py``'s live ``HarrisList`` trace: the same
    stream and report in both packages; a policy that flushes during the
    journey is caught by both, the NVTraverse policy is not."""
    reps = []
    for P, H, Tr, Pol, T, C in ((RP, RH, RTr, RPol, RT, RC),
                                (TP, TH, TTr, TPol, TT, TC)):
        mem = P.PMem(1 << 12)
        ds = H.HarrisList(mem)
        tr = T.PersistTrace().attach(mem)
        pol = _leaky(Pol.NVTraversePolicy) if leaky else \
            Pol.NVTraversePolicy()
        for op, args in (("insert", (5, 50)), ("insert", (3, 30)),
                         ("find", (5,)), ("delete", (3,))):
            Tr.run_operation(ds, pol, op, args)
        reps.append((as_dicts(tr.events),
                     C.check_events(tr.events, end_check=False).to_dict()))
    assert reps[0] == reps[1]
    rules = {f["rule"] for f in reps[1][1]["violations"]}
    assert ("traversal-phase-persistence" in rules) == leaky


def test_live_staged_io_traces_equal(tmp_path):
    """The live StagedIO cases: a write after its flush is caught by the
    strict clwb model; a clean staged cycle is not."""
    got = []
    for i, (IO, T, C) in enumerate(((RIO, RT, RC), (TIO, TT, TC))):
        io = IO(tmp_path / str(i))
        tr = T.PersistTrace().attach(io)
        io.write("a.tmp", b"v1")
        io.flush("a.tmp")
        io.write("a.tmp", b"v2")
        io.fence()
        io.publish("a.tmp", "a")
        io.write("b.tmp", b"v")
        io.flush("b.tmp")
        io.fence()
        io.publish("b.tmp", "b")
        io.unlink("a")
        got.append((as_dicts(tr.events),
                    C.check_events(tr.events).to_dict()))
    assert got[0] == got[1]
    assert [f["rule"] for f in got[1][1]["violations"]] == ["missing-flush"]


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_run_static_equals_the_references(tree):
    root = SRC / tree
    port, ref = TL.run_static(root=root), RL.run_static(root=root)
    assert port.to_dict() == ref.to_dict()
    assert port.ok and port.n_files == len(list(root.rglob("*.py")))
    assert {(v.rule, v.file) for v in port.waived} == {
        ("raw-durable-io", "serving/engine.py")}


def test_lint_source_equal_on_the_references_doctest_and_a_mutant():
    src = ("from repro_torch.persistence.manifest import StagedIO\n"
           "import os\nos.replace('a', 'b')\n"
           "def f(io):\n    io.write('x', b'')\n    io.publish('x', 'y')\n")
    assert as_dicts(TL.lint_source("x.py", src)) == \
        as_dicts(RL.lint_source("x.py", src))
    assert [v.rule for v in TL.lint_source("x.py", src)] == [
        "raw-durable-io", "publish-needs-fence"]
