"""The port's checkpoint manager (``repro_torch.persistence.checkpoint``)
against the JAX package's on the CPU: the same save/gc/crash history
writes byte-identical checkpoint directories (every ``.npy``, every
``MANIFEST.json`` and its digests), either package recovers and restores
the other's directory, the live-step index holds the same members across
passes, and a bfloat16 leaf is written with the reference's exact bytes.
The reference cannot restore that leaf (its ``np.load`` gives a ``|V2``
array, which JAX rejects); the port restores it as ``torch.bfloat16``."""
import numpy as np
import pytest
import torch

from repro.persistence.checkpoint import CheckpointManager as JaxManager
from repro.persistence.index import live_step_index as jax_live_index
from repro.persistence.manifest import Manifest, manifest_rel
from repro_torch.persistence import checkpoint as TC
from repro_torch.persistence.index import live_step_index


def Port(root, **kw):
    return TC.CheckpointManager(root, device="cpu", **kw)


MAKERS = {"jax": JaxManager, "port": Port}


def _tree(step):
    return {"params": {"w": np.full((4, 4), float(step), np.float32),
                       "b": np.zeros((4,), np.float32)},
            "opt": {"mu": np.full((4, 4), step * 0.1)},
            "layers": [np.arange(3, dtype=np.int32) + step,
                       np.int64(step)]}


def _delta(t):
    return {"params": {"w": t["params"]["w"] + 1, "b": t["params"]["b"]},
            "opt": t["opt"], "layers": t["layers"]}


def h_delta(make, root):
    mgr = make(root)
    t = _tree(1)
    mgr.save(1, t, aux={"cursor": 7})
    man = mgr.save(2, _delta(t))
    assert man.files["params/b"]["owner"] == 1
    assert man.files["params/w"]["owner"] == 2
    return mgr


def h_izraelevitz(make, root):
    big = {"p": {f"l{i}": np.ones((8, 8), np.float32) * i
                 for i in range(20)}}
    nv = make(root / "nv", policy="nvtraverse")
    nv.save(1, big)
    iz = make(root / "iz", policy="izraelevitz")
    iz.save(1, big)
    assert nv.io.counters.fences == 1
    assert iz.io.counters.fences == 21           # one a leaf, one more
    return iz


def h_crash(phase):
    def run(make, root):
        mgr = make(root)
        mgr.save(1, _tree(1), aux={"ok": 1})
        assert mgr.save(2, _tree(2), crash_after=phase) is None
        mgr.io.crash(evict="none")
        return mgr
    return run


def h_evict(make, root):
    for seed in range(5):
        mgr = make(root / f"s{seed}", seed=seed)
        mgr.save(1, _tree(1))
        mgr.save(2, _tree(2), crash_after="manifest")
        mgr.io.crash(evict="random", p_evict=0.7)
        assert make(root / f"s{seed}").recover().step == 1
    return mgr


def h_corrupt(make, root):
    mgr = make(root)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    man2 = Manifest.from_bytes(mgr.io.read(manifest_rel(2)))
    (mgr.io.root / man2.files["params/w"]["file"]).write_bytes(b"garbage")
    assert make(root).recover().step == 1
    return mgr


def h_stray(make, root):
    mgr = make(root)
    mgr.save(1, _tree(1))
    stray = root / f"step_{2**40:08d}"
    stray.mkdir()
    (stray / "junk.npy").write_bytes(b"junk")
    assert make(root).recover().step == 1
    assert not stray.exists()
    return mgr


def h_gc(make, root):
    mgr = make(root)
    t = _tree(1)
    mgr.save(1, t)
    for s in (2, 3, 4):
        t = _delta(t)
        mgr.save(s, t)
    mgr.gc(keep=2)
    return mgr


HISTORIES = {"delta": h_delta, "izraelevitz": h_izraelevitz,
             "crash_shards": h_crash("shards"),
             "crash_manifest": h_crash("manifest"), "evict": h_evict,
             "corrupt": h_corrupt, "stray": h_stray, "gc": h_gc}


def dir_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def leaves(tree):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in TC._flatten(tree).items()}


@pytest.mark.parametrize("name", list(HISTORIES))
def test_same_history_writes_byte_identical_dirs(tmp_path, name):
    for pkg, make in MAKERS.items():
        HISTORIES[name](make, tmp_path / pkg)
    want = dir_bytes(tmp_path / "jax")
    assert want and dir_bytes(tmp_path / "port") == want


@pytest.mark.parametrize("name", ["delta", "crash_manifest", "corrupt",
                                  "gc"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_recovers_and_restores_the_others(tmp_path, name,
                                                         writer):
    HISTORIES[name](MAKERS[writer], tmp_path)
    jm, jt = JaxManager(tmp_path).restore(_tree(0))
    tm, tt = Port(tmp_path).restore(_tree(0))
    assert tm.step == jm.step and tm.files == jm.files and tm.aux == jm.aux
    a, b, saved = leaves(jt), leaves(tt), leaves(_tree(0))
    assert sorted(a) == sorted(b) == sorted(saved)
    for k in a:
        # the port keeps the stored dtype; JAX narrows 64-bit leaves
        assert b[k].dtype == saved[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k].astype(a[k].dtype),
                                      err_msg=k)
    assert isinstance(tt["layers"], list) and tt["layers"][1].dim() == 0


def test_restore_puts_leaves_on_the_device_as_tensors(tmp_path):
    h_gc(Port, tmp_path)
    man, tree = Port(tmp_path).restore(_tree(0), device="cpu")
    assert man.step == 4
    assert isinstance(tree["params"]["w"], torch.Tensor)
    np.testing.assert_array_equal(tree["params"]["w"].numpy(),
                                  np.full((4, 4), 4.0, np.float32))
    np.testing.assert_array_equal(tree["params"]["b"].numpy(),
                                  np.zeros(4, np.float32))   # step 1's ref
    assert Port(tmp_path / "empty").restore(_tree(0)) == (None, None)


def test_live_step_index_holds_the_same_members_across_passes(tmp_path):
    """recover()/gc() keep one live-step index current by mixed rounds;
    after every pass it holds the reference's members, and its probe
    matches what is on disk."""
    mgrs = {}
    for pkg, make in MAKERS.items():
        mgrs[pkg] = make(tmp_path / pkg)
        for s in (1, 2, 3, 4):
            mgrs[pkg].save(s, {"w": np.full((4,), float(s))})
    for step in ("recover", "gc", "recover"):
        for m in mgrs.values():
            m.gc(keep=2) if step == "gc" else m.recover()
        assert mgrs["port"]._step_index.members == \
            mgrs["jax"]._step_index.members
        assert mgrs["port"]._step_index.contains([1, 2, 3, 4]).tolist() == \
            mgrs["jax"]._step_index.contains([1, 2, 3, 4]).tolist()
    assert mgrs["port"]._step_index.contains([1, 2, 3, 4]).tolist() == \
        [False, False, True, True]
    assert not (tmp_path / "port" / "step_00000001").exists()
    # the function itself, from scratch and in place
    mans = [Manifest(step=s, prev=None, files={}, aux={}) for s in (3, 5)]
    keep = {"step_00000002/w.npy"}
    idx = live_step_index(mans, keep, device="cpu")
    jidx = jax_live_index(mans, keep)
    assert idx.members == jidx.members == {2, 3, 5}
    live_step_index(mans[1:], set(), idx)
    jax_live_index(mans[1:], set(), jidx)
    assert idx.members == jidx.members == {5}


def test_bf16_leaf_bytes_match_and_only_the_port_restores_them(tmp_path):
    """Reference divergence: the reference saves a bfloat16 leaf (header
    ``'<V2'``, the raw 16-bit payload) but cannot restore it
    (``src/repro/persistence/checkpoint.py:57`` loads ``|V2``, ``:189``
    hands it to JAX, which raises).  The port writes the same bytes and
    restores them as bfloat16, taking the dtype from ``tree_like``."""
    import jax.numpy as jnp
    vals = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    JaxManager(tmp_path / "jax").save(
        1, {"w": jnp.asarray(vals, jnp.bfloat16), "s": np.float32(2)})
    Port(tmp_path / "port").save(
        1, {"w": torch.as_tensor(vals).to(torch.bfloat16),
            "s": np.float32(2)})
    want = dir_bytes(tmp_path / "jax")
    assert dir_bytes(tmp_path / "port") == want
    npy = want["step_00000001/w.npy"]
    assert b"'descr': '<V2'" in npy[:128]
    like = {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
            "s": np.float32(0)}
    with pytest.raises(TypeError, match="V2"):
        JaxManager(tmp_path / "jax").restore(
            {"w": jnp.zeros((3, 4), jnp.bfloat16), "s": np.float32(0)})
    for d in ("jax", "port"):
        man, tree = Port(tmp_path / d).restore(like)
        assert tree["w"].dtype == torch.bfloat16
        assert torch.equal(tree["w"],
                           torch.as_tensor(vals).to(torch.bfloat16))
        assert tree["s"].dtype == torch.float32 and float(tree["s"]) == 2.0
    with pytest.raises(TypeError, match="void"):
        Port(tmp_path / "port").restore({"w": np.zeros((3, 4)),
                                         "s": np.float32(0)})


def test_unknown_policy_raises(tmp_path):
    with pytest.raises(ValueError, match="policy"):
        Port(tmp_path, policy="eager")
