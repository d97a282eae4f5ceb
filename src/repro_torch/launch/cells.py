"""Dry-run cells: (arch x shape x mesh) -> a step function, its arguments
as meta tensors and their shardings (the port's counterpart of
``repro.launch.cells``).

A *cell* is what one step of the assignment runs:

  * ``train_*``   -> the train step (the microbatch loop and the
    optimizer's update);
  * ``prefill_*`` -> the forward over the prompt, logits and KV caches
    out;
  * ``decode_*`` / ``long_*`` -> the serve step (ONE new token against a
    KV cache of seq_len).

The arguments are meta tensors, the counterpart of the reference's
``ShapeDtypeStruct``\\ s: they have shapes and dtypes and no data, and
nothing is allocated.  The reference's step and position are device int32
scalars; the port's are host integers, so the cell carries them as 0-dim
int32 meta tensors (counted as the reference counts them) and the step
function runs at step 0 and at the cache's last position.

:func:`lower_cell` has no compiler to ask: it runs the step once on the
meta arguments under counting modes and reports what the reference reads
off a compiled program, under the same names (:class:`Lowered`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import SHAPES, ArchConfig, ShapeConfig
from ..configs.registry import get_arch
from ..kernels import work as kernel_work
from ..models.model import build_model
from ..sharding import specs as SH
from ..training.optimizer import make_optimizer
from ..training.train_loop import make_train_step
from .mesh import Mesh

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeConfig
    fn: Callable
    args: Tuple[Any, ...]          # meta tensors (a ParamTree, dicts)
    in_shardings: Tuple[Any, ...]
    donate_argnums: Tuple[int, ...] = ()


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _batch(cfg, B: int, S: int, *, train: bool) -> dict:
    """Model input batch (token count S; +1 labels column for training)."""
    cols = S + 1 if train else S
    batch = {"tokens": _empty((B, cols), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _empty((B, cfg.enc_seq, cfg.d_model),
                                 torch.bfloat16)
    if cfg.family == "vlm":
        batch["vis"] = _empty((B, cfg.vis_tokens, cfg.d_model),
                              torch.bfloat16)
    return batch


def _batch_shardings(mesh, batch: dict, B: int, *, microbatched=False):
    def sh(leaf):
        spec = SH.batch_spec(mesh, B, rank=leaf.dim()
                             - (1 if microbatched else 0))
        if microbatched:   # [M, B/M, ...]: the DP shard rides on dim 1
            spec = (None, *spec)
        return SH.NamedSharding(mesh, spec)
    return {k: sh(v) for k, v in batch.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def make_cell(arch_or_cfg, shape_or_cfg, mesh: Mesh) -> Cell:
    """``arch_or_cfg``/``shape_or_cfg`` may be names or
    (ArchConfig, ShapeConfig) instances."""
    cfg = get_arch(arch_or_cfg) if isinstance(arch_or_cfg, str) \
        else arch_or_cfg
    shape = SHAPES[shape_or_cfg] if isinstance(shape_or_cfg, str) \
        else shape_or_cfg
    if shape.kind == "prefill" and getattr(cfg, "sp_prefill", False) \
            and not cfg.sp:
        cfg = dataclasses.replace(cfg, sp=True)   # fwd-only SP
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    params = model.init_shapes(trainable=train)
    # inference cells store parameters without the ZeRO axis when the
    # model-sharded copy fits comfortably a device (arctic-480b at
    # 960 GB / 16 = 60 GB a device stays ZeRO-sharded)
    param_bytes = sum(_nbytes(p) for p in params.parameters())
    per_chip_replicated = param_bytes / mesh.shape["model"]
    infer = not train and per_chip_replicated < 6e9
    params_sh = SH.params_shardings(params, cfg, mesh, infer=infer)
    repl = SH.NamedSharding(mesh, ())

    if train:
        opt = make_optimizer(cfg)
        opt_state = opt.init(params)
        opt_sh = SH.params_shardings(opt_state, cfg, mesh)
        batch = _batch(cfg, B, S, train=True)
        M = max(1, cfg.microbatches)
        if M > 1:   # pre-shaped [M, B/M, ...]; dim 1 carries the DP shard
            batch = {k: _empty((M, v.shape[0] // M) + tuple(v.shape[1:]),
                               v.dtype) for k, v in batch.items()}
        batch_sh = _batch_shardings(mesh, batch, B // M,
                                    microbatched=(M > 1))
        train_step = make_train_step(model, cfg, opt)

        def train_fn(params, opt_state, batch, step):
            # the step is the device scalar of the reference; the port's
            # schedule reads a host int
            return train_step(params, opt_state, batch, 0)

        return Cell(
            arch=cfg, shape=shape, fn=train_fn,
            args=(params, opt_state, batch, _empty((), torch.int32)),
            in_shardings=(params_sh, opt_sh, batch_sh, repl),
            donate_argnums=(0, 1))

    if shape.kind == "prefill":
        batch = _batch(cfg, B, S, train=False)
        batch_sh = _batch_shardings(mesh, batch, B)
        max_len = S + (cfg.vis_tokens if cfg.family == "vlm" else 0)

        def prefill_fn(params, batch):
            return model.prefill(params, batch, max_len)

        return Cell(arch=cfg, shape=shape, fn=prefill_fn,
                    args=(params, batch), in_shardings=(params_sh, batch_sh))

    # decode / long-context decode: one token against a cache of S
    caches = model.init_caches(B, S, META)
    caches_sh = SH.caches_shardings(cfg, mesh, B)
    tok_spec = SH.batch_spec(mesh, B, rank=1)

    def serve_step(params, tokens, caches, pos):
        # the position is the device scalar of the reference; the port's
        # decode step writes at a host int: the cache's last slot
        return model.decode_step(params, tokens, caches, S - 1)

    return Cell(
        arch=cfg, shape=shape, fn=serve_step,
        args=(params, _empty((B,), torch.int32), caches,
              _empty((), torch.int32)),
        in_shardings=(params_sh, SH.NamedSharding(mesh, tok_spec),
                      caches_sh, repl),
        donate_argnums=(2,))


# --------------------------------------------------------------------- #
# leaves                                                                 #
# --------------------------------------------------------------------- #
def leaves(tree) -> list:
    """The tensors of an argument or output tree: a ParamTree's
    parameters, dicts, tuples and NamedTuples, in order."""
    module = lambda x: hasattr(x, "named_parameters")
    out = []
    for t in tree_flatten(tree, is_leaf=module)[0]:
        if module(t):
            out.extend(p for _, p in t.named_parameters())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def arg_shardings(cell: Cell) -> list:
    """(tensor, NamedSharding) for every argument leaf of ``cell``."""
    out = []
    for arg, sh in zip(cell.args, cell.in_shardings):
        ts = leaves(arg)
        if isinstance(sh, SH.NamedSharding):
            shs = [sh] * len(ts)
        else:
            shs = [s for s in tree_flatten(
                sh, is_leaf=lambda x: isinstance(x, SH.NamedSharding))[0]]
        if len(shs) != len(ts):
            raise ValueError(f"{len(ts)} argument leaves, {len(shs)} "
                             f"shardings")
        out.extend(zip(ts, shs))
    return out


def argument_bytes_per_device(cell: Cell) -> int:
    """Each argument leaf's shard bytes on one device of the cell's
    mesh."""
    total = 0
    for t, sh in arg_shardings(cell):
        n = 1
        for d in sh.shard_shape(tuple(t.shape)):
            n *= d
        total += n * t.element_size()
    return total


# --------------------------------------------------------------------- #
# lowering: one run on the meta device under counting modes              #
# --------------------------------------------------------------------- #
aten = torch.ops.aten
_UNINITIALISED = {aten.empty.memory_format, aten.empty_strided.default,
                  aten.empty_like.default, aten.new_empty.default,
                  aten.new_empty_strided.default}


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class _MemoryAndBytes(TorchDispatchMode):
    """Counts each dispatched op's input and output bytes (an op that
    only makes a view of its input, or allocates without writing, moves
    none), and the live bytes of the storages made during the run, by
    storage so that views count once; ``peak`` is their most at any op."""

    def __init__(self, arg_storages):
        super().__init__()
        self.args = {s._cdata for s in arg_storages}
        self.bytes = 0
        self.live = {}          # storage cdata -> (weak ref, nbytes)
        self.bound = 0          # live bytes, counting some maybe freed
        self.peak = 0

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            del self.live[k]
        self.bound = sum(n for _, n in self.live.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not (func.is_view or func in _UNINITIALISED
                or self._aliases_only(func, ins, outs)):
            self.bytes += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
        for t in outs:
            st = _storage(t)
            key = st._cdata
            if key in self.args:
                continue
            known = self.live.get(key)
            if known is not None and not known[0].expired():
                continue
            n = st.nbytes()
            self.live[key] = (StorageWeakRef(st), n)
            self.bound += n
            if self.bound > self.peak:
                self._sweep()
                self.peak = max(self.peak, self.bound)
        return out

    @staticmethod
    def _aliases_only(func, ins, outs) -> bool:
        """A non-mutating op whose every output is one of its inputs'
        storages (``_unsafe_view`` and the like) moves no bytes."""
        if func._schema.is_mutable or not outs:
            return False
        in_keys = {_storage(t)._cdata for t in ins}
        return all(_storage(t)._cdata in in_keys for t in outs)


@dataclasses.dataclass
class MemoryAnalysis:
    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int


class Lowered:
    """What one counted run of a cell gives, read under the names of a
    compiled XLA program: :meth:`memory_analysis` and
    :meth:`cost_analysis`."""

    def __init__(self, memory: MemoryAnalysis, cost: dict, kernels: dict,
                 seconds: float, microbatches: int):
        self._memory = memory
        self._cost = cost
        self.kernels = kernels
        self.seconds = seconds
        self.microbatches = microbatches

    def memory_analysis(self) -> MemoryAnalysis:
        return self._memory

    def cost_analysis(self) -> dict:
        return dict(self._cost)


def _count(fn, args, grad: bool):
    """Run ``fn(*args)`` once under the counting modes: (outputs, flop
    counter, bytes and memory mode, kernel tally)."""
    arg_storages = [_storage(t) for a in args for t in leaves(a)]
    tally = kernel_work.Tally()
    flops = FlopCounterMode(display=False)
    mem = _MemoryAndBytes(arg_storages)
    with torch.set_grad_enabled(grad), kernel_work.recording(tally), \
            flops, mem:
        out = fn(*args)
    return out, flops, mem, tally


def lower_cell(cell: Cell, mesh: Mesh) -> Lowered:
    """Run the cell's step once on its meta arguments (the mesh registered
    with :mod:`repro_torch.sharding.constraints`, as the reference lowers
    inside its mesh).

    ``memory_analysis()``: ``argument_size_in_bytes`` (every argument
    leaf), ``output_size_in_bytes`` (every output leaf, once a storage),
    ``alias_size_in_bytes`` (the outputs that are donated arguments'
    storages, written in place) and ``temp_size_in_bytes`` (the peak of
    the live bytes made during the run, less the outputs that are new),
    so that argument + output - alias + temp is the run's peak.
    ``cost_analysis()``: ``flops`` (``FlopCounterMode``'s count plus the
    kernels' formulas) and ``bytes accessed`` (every op's inputs and
    outputs, each op moving its own: eager PyTorch fuses nothing, plus
    the kernels' formulas).  One card: the figures are the device's."""
    from ..sharding.constraints import use_mesh
    t0 = time.perf_counter()
    with use_mesh(mesh):
        out, flops, mem, tally = _count(cell.fn, cell.args,
                                        grad=cell.shape.kind == "train")
    seconds = time.perf_counter() - t0
    arg_keys = {_storage(t)._cdata: _nbytes(t)
                for a in cell.args for t in leaves(a)}
    donated = {_storage(t)._cdata for i in cell.donate_argnums
               for t in leaves(cell.args[i])}
    out_leaves, seen = [], set()
    for t in leaves(out):
        key = _storage(t)._cdata
        if key not in seen:
            seen.add(key)
            out_leaves.append((key, t))
    out_bytes = sum(_nbytes(t) for _, t in out_leaves)
    alias = sum(_nbytes(t) for k, t in out_leaves if k in donated)
    fresh = sum(_nbytes(t) for k, t in out_leaves if k not in arg_keys)
    memory = MemoryAnalysis(
        argument_size_in_bytes=sum(_nbytes(t) for a in cell.args
                                   for t in leaves(a)),
        output_size_in_bytes=out_bytes, alias_size_in_bytes=alias,
        temp_size_in_bytes=max(0, mem.peak - fresh))
    cost = {"flops": float(flops.get_total_flops() + tally.flops),
            "bytes accessed": float(mem.bytes + tally.bytes)}
    kernels = {k: dict(v) for k, v in tally.by_kernel.items()}
    return Lowered(memory, cost, kernels, seconds,
                   max(1, cell.arch.microbatches)
                   if cell.shape.kind == "train" else 1)
