"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``) on the CPU: the two instruction-level examples print
the reference's text line for line, the live-rebalance example prints
the reference's splits, trigger rounds and drains (the reference in a
subprocess with its own four forced devices), and the serving and
training examples pass their own assertions with ``--device cpu``.  The
new examples and tools import nothing of JAX or of the JAX package."""
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PORT_FILES = sorted(EXAMPLES.glob("torch_*.py")) + \
    sorted((ROOT / "tools").glob("torch_*.py"))


def run_script(path: Path, argv, capsys) -> str:
    """``path`` run as ``__main__`` with ``argv``; its standard output."""
    old = sys.argv
    sys.argv = [str(path), *argv]
    try:
        capsys.readouterr()
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def reference_outputs():
    """The reference's three host examples, started together in
    subprocesses (``rebalance_live.py`` forces its own four devices) while
    the port's run in this process; {name: stdout}."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    procs = {name: subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}.py")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("quickstart", "nvtraverse_demo", "rebalance_live")}
    outs = {}

    def get(name):
        if name not in outs:
            out, err = procs[name].communicate(timeout=300)
            assert procs[name].returncode == 0, err[-3000:]
            outs[name] = out
        return outs[name]
    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_port_files_import_no_jax_or_reference():
    # five examples, the reference's three tools and the MoE turns tool
    assert len(PORT_FILES) == 9
    pat = re.compile(r"^\s*(import|from) (jax|repro)\b", re.M)
    for p in PORT_FILES:
        assert not pat.search(p.read_text()), p.name


@pytest.mark.parametrize("name", ["quickstart", "nvtraverse_demo"])
def test_instruction_level_examples_print_the_reference(
        name, reference_outputs, capsys):
    got = run_script(EXAMPLES / f"torch_{name}.py", [], capsys)
    assert got.splitlines() == reference_outputs(name).splitlines()
    assert "✓" in got


def test_rebalance_live_prints_the_reference(reference_outputs, capsys):
    got = run_script(EXAMPLES / "torch_rebalance_live.py",
                     ["--device", "cpu"], capsys)
    assert got.splitlines() == reference_outputs(
        "rebalance_live").splitlines()
    assert "policy fired" in got and "rebalance complete" in got


def test_serve_batch_runs_on_the_host(capsys):
    out = run_script(EXAMPLES / "torch_serve_batch.py", ["--device", "cpu"],
                     capsys)
    assert "committed after recovery: [0, 1, 2, 3, 4, 5, 6, 7]" in out
    assert "exactly once ✓" in out


def test_train_tiny_lm_resumes_bit_faithfully_on_the_host(capsys):
    """A short run of the ~100M config: 10 steps (early in the warm-up:
    8 do not lower the loss on this seed, 10 do), a checkpoint every 3 (a
    third of the run), the crash at step 8 and a resume from step 6."""
    out = run_script(EXAMPLES / "torch_train_tiny_lm.py",
                     ["--device", "cpu", "--steps", "10"], capsys)
    assert "checkpoint every 3" in out
    assert "resumed from committed step 6" in out
    assert "drift vs uninterrupted run: 0.00e+00" in out
    assert "bit-faithful" in out


@pytest.mark.parametrize("name", ["torch_serve_batch",
                                  "torch_rebalance_live",
                                  "torch_train_tiny_lm"])
def test_examples_without_a_card_raise(name, capsys):
    """Without ``--device`` an example runs on the card, and raises where
    there is none: no quiet switch to the host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        run_script(EXAMPLES / f"{name}.py", [], capsys)
