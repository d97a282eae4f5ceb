"""The reference's PersistLint static pass over the port package: the
port's durable layers keep the flush -> fence -> publish discipline with
no violation, and need only the reference's own two waivers.  The port's
own copy of the pass, run with no arguments, lints the port's tree and
gives the same report."""
from collections import Counter
from pathlib import Path

import pytest

from repro.analysis.persistlint import lint_source, run_static
from repro_torch.analysis import persistlint as port_lint

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
DURABLE = ("core/ordered.py", "core/migrate.py", "persistence/manifest.py",
           "robustness/faultinject.py", "serving/engine.py")


def test_port_package_lints_clean_with_the_references_waivers():
    port = run_static(root=PORT)
    ref = run_static()
    assert port.violations == []
    assert port.n_files == len(list(PORT.rglob("*.py")))
    kinds = lambda rep: Counter((v.rule, v.file) for v in rep.waived)  # noqa
    assert kinds(port) == kinds(ref)
    assert {v.rule for v in port.waived} == {"raw-durable-io"}


@pytest.mark.parametrize("rel", DURABLE)
def test_each_durable_module_is_linted(rel):
    src = (PORT / rel).read_text()
    assert "publish" in src or "StagedIO" in src
    assert [v for v in lint_source(rel, src) if not v.waived] == []


@pytest.mark.parametrize("rel,needle", [
    ("core/ordered.py", '        self.io.fence()\n        self.io.publish('
                        '"ord.tmp", rel)'),
    ("core/migrate.py", '        self.io.fence()\n        self.io.publish('
                        'tmp, f"{self.d}/round_{self.n_rounds:06d}.npz")'),
])
def test_dropping_a_journal_fence_is_caught(rel, needle):
    """A mutation of the port's own journal code: without the fence that
    dominates a publish the lint reports publish-needs-fence."""
    src = (PORT / rel).read_text()
    assert needle in src
    mutant = src.replace(needle, needle.split("\n")[1])
    rules = [v.rule for v in lint_source(rel, mutant) if not v.waived]
    assert rules == ["publish-needs-fence"]


def test_ports_own_run_static_lints_its_tree_as_the_reference_does():
    own = port_lint.run_static()
    assert own.to_dict() == run_static(root=PORT).to_dict()
    assert own.n_files == len(list(PORT.rglob("*.py")))
    assert {(v.rule, v.file) for v in own.waived} == {
        ("raw-durable-io", "serving/engine.py")}
