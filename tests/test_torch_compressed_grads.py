"""The port's ``make_compressed_psum_grads`` (bf16-compressed gradient mean
with f32 error feedback) against the JAX package's on the CPU:

  * the replica form (``axis=0``, leaves ``[R, ...]``) against the
    reference under ``jax.jit(jax.vmap(..., axis_name="pod"))``, as
    ``tests/test_train_loop.py`` runs it: the reduced gradients and the
    errors bit for bit, over 5 steps of error feedback on a seeded tree of
    f32 leaves of many magnitudes, at R = 2, 3 and 4;
  * the reference test's 50-step error-feedback sum;
  * the ``torch.distributed`` form with two gloo ranks (two processes on a
    ``FileStore``) equal to the replica form at R = 2;
  * a call with neither a replica axis nor a process group raises.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.train_loop import \
    make_compressed_psum_grads as jmake_compressed
from repro_torch.training.train_loop import make_compressed_psum_grads

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"w": (33, 5), "b": (7,), "norm": (4, 3, 2)}


def _tree(rng, R: int) -> dict:
    """f32 leaves [R, ...]: a normal times e^(3 N), so that the bf16
    roundings and the sums cross many binades."""
    return {k: (rng.standard_normal((R,) + s)
                * np.exp(3 * rng.standard_normal((R,) + s)))
            .astype(np.float32) for k, s in SHAPES.items()}


def _zeros(R: int) -> dict:
    return {k: np.zeros((R,) + s, np.float32) for k, s in SHAPES.items()}


def _reference(R: int, steps: list):
    """The reference's reduced gradients and errors after each step."""
    f = jax.jit(jax.vmap(jmake_compressed("pod"), axis_name="pod"))
    err = {k: jnp.asarray(v) for k, v in _zeros(R).items()}
    out = []
    for g in steps:
        red, err = f({k: jnp.asarray(v) for k, v in g.items()}, err)
        out.append(({k: np.asarray(v) for k, v in red.items()},
                    {k: np.asarray(v) for k, v in err.items()}))
    return out


@pytest.mark.parametrize("R", [2, 3, 4])
def test_replica_form_matches_the_reference_bit_for_bit(R):
    rng = np.random.default_rng(R)
    steps = [_tree(rng, R) for _ in range(5)]
    f = make_compressed_psum_grads(axis=0)
    err = {k: torch.from_numpy(v) for k, v in _zeros(R).items()}
    for g, (jred, jerr) in zip(steps, _reference(R, steps)):
        red, err = f({k: torch.from_numpy(v) for k, v in g.items()}, err)
        for k in SHAPES:
            assert red[k].dtype == err[k].dtype == torch.float32
            np.testing.assert_array_equal(red[k].numpy(), jred[k], err_msg=k)
            np.testing.assert_array_equal(err[k].numpy(), jerr[k], err_msg=k)
        # every replica holds the same mean
        assert all(torch.equal(red[k][r], red[k][0])
                   for k in SHAPES for r in range(R))


def test_error_feedback_sums_to_the_true_mean():
    """tests/test_train_loop.py's check on the port: a gradient below
    bf16's resolution near 1e-3, compressed 50 times with its residual
    carried, sums to 50 x its value within rel 1e-3."""
    f = make_compressed_psum_grads(axis=0)
    g = {"w": torch.full((2, 1), 1e-3 + 1e-6)}
    err = {"w": torch.zeros_like(g["w"])}
    total = 0.0
    for _ in range(50):
        red, err = f(g, err)
        total += float(red["w"][0, 0])
    assert total == pytest.approx(50 * (1e-3 + 1e-6), rel=1e-3)
    # without the feedback the bf16 rounding loses the 1e-6 every step
    once = f(g, {"w": torch.zeros_like(g["w"])})[0]["w"][0, 0]
    assert float(once) != pytest.approx(1e-3 + 1e-6, rel=1e-4)


_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.training.train_loop import make_compressed_psum_grads

rank, store, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
f = make_compressed_psum_grads(group=dist.group.WORLD)
data = np.load(data)
names = sorted({n.split("_", 1)[1] for n in data.files})
n_steps = len(data.files) // len(names)
err = {k: torch.zeros(data[f"0_{k}"].shape[1:]) for k in names}
res = {}
for i in range(n_steps):
    g = {k: torch.from_numpy(data[f"{i}_{k}"][rank]) for k in names}
    red, err = f(g, err)
    res.update({f"red{i}_{k}": v.numpy() for k, v in red.items()})
    res.update({f"err{i}_{k}": v.numpy() for k, v in err.items()})
dist.destroy_process_group()
np.savez(out, **res)
"""


def test_process_group_form_matches_the_replica_form(tmp_path):
    """Two gloo ranks, each holding its replica's leaves, over 3 steps of
    error feedback: each rank's mean and error equal the replica form's
    at R = 2, bit for bit (two ranks sum with one rounded add, as the
    replica form does)."""
    rng = np.random.default_rng(7)
    steps = [_tree(rng, 2) for _ in range(3)]
    np.savez(tmp_path / "data.npz", **{
        f"{i}_{k}": v for i, g in enumerate(steps) for k, v in g.items()})
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / "data.npz"), str(tmp_path / f"rank{r}.npz")],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, out + err
    f = make_compressed_psum_grads(axis=0)
    err = {k: torch.from_numpy(v) for k, v in _zeros(2).items()}
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for i, g in enumerate(steps):
        red, err = f({k: torch.from_numpy(v) for k, v in g.items()}, err)
        for r, got in enumerate(ranks):
            for k in SHAPES:
                np.testing.assert_array_equal(got[f"red{i}_{k}"],
                                              red[k][r].numpy())
                np.testing.assert_array_equal(got[f"err{i}_{k}"],
                                              err[k][r].numpy())


def test_without_an_axis_or_a_group_it_raises():
    with pytest.raises(ValueError, match="nothing to reduce over"):
        make_compressed_psum_grads()
    with pytest.raises(ValueError, match="exactly one"):
        make_compressed_psum_grads(axis=0, group=object())
