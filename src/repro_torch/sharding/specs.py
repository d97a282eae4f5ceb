"""Partition rules: DP / FSDP (ZeRO) / TP / EP / SP on the production
layouts (the port's copy of ``repro.sharding.specs``, rule for rule).

  * **DP**: the batch dim of activations over ``("pod", "data")``
    (multi-pod) or ``("data",)``.
  * **TP** over ``"model"``: attention heads (Q and KV projections), FFN
    hidden, vocab (logits).
  * **FSDP/ZeRO** over ``"data"``: the other matrix dim of every large
    parameter, so parameters and optimizer slots are stored fully
    sharded.
  * **EP** over ``"model"`` where ``cfg.moe_strategy == "ep"`` (arctic:
    128 experts); qwen2-moe's 60 experts take the TP rule (expert d_ff
    over ``"model"``) instead.
  * **SP**: KV caches shard the KV-head dim over ``"model"`` when it
    divides, otherwise the sequence dim; batch 1 (long_500k) shards the
    sequence over ``"data"`` too.

Every rule is divisibility-guarded: a dim that an axis does not divide is
left unsharded.

A spec is a plain tuple with an axis name, a tuple of axis names or
``None`` per dim (the counterpart of ``PartitionSpec``; ``()`` is
replicated), aligned to the trailing dims.  A :class:`NamedSharding` is a
(mesh, spec) pair that gives its :meth:`~NamedSharding.shard_shape`.

The reference stacks each layer's leaves on a leading ``L`` axis; the port
keeps a tensor a layer, its index in the name (``blocks.3.attn.wq``,
:mod:`repro_torch.models.convert`).  The numeric name parts are dropped
before a rule reads the path, and a per-layer tensor's spec is the
reference's without its leading ``None`` (``_spec`` aligns axes to the
trailing dims).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..launch.mesh import Mesh
from ..models.mamba2 import SSMCache

# optimizer slot names: AdamW's moments, Adafactor's factored and full
# second moments
OPT_SLOTS = ("mu", "nu", "vr", "vc", "v")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: tuple

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The per-device shape of a ``global_shape`` array; every sharded
        dim must divide evenly (the rules guard for it)."""
        spec = tuple(self.spec) + (None,) * (len(global_shape)
                                             - len(self.spec))
        out = []
        for dim, axes in zip(global_shape, spec):
            n = _axsize(self.mesh, axes) if axes is not None else 1
            if dim % n:
                raise ValueError(f"dim {dim} does not divide over {axes} "
                                 f"({n} devices)")
            out.append(dim // n)
        return tuple(out)


def batch_axes(mesh: Mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _ok(dim: int, mesh: Mesh, axes) -> bool:
    if axes is None:
        return True
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= mesh.shape[a]
    return dim % size == 0 and dim >= size


def _spec(mesh: Mesh, shape, *axes) -> tuple:
    """Divisibility-guarded spec, the axes aligned to the TRAILING dims
    and leading extra dims left unsharded."""
    lead = max(0, len(shape) - len(axes))
    out = [None] * lead
    for dim, ax in zip(shape[lead:], axes[-(len(shape) - lead):] if
                       len(shape) > lead else ()):
        out.append(ax if ax is not None and _ok(dim, mesh, ax) else None)
    return tuple(out)


# --------------------------------------------------------------------- #
# parameters                                                             #
# --------------------------------------------------------------------- #
def param_spec(path: Tuple[str, ...], shape, cfg, mesh: Mesh,
               *, infer: bool = False) -> tuple:
    """Sharding rule for one parameter, keyed on its path (the name's
    parts without layer indices).

    ``infer=True`` (prefill/decode cells): drop the ZeRO/FSDP storage
    axis; inference has no optimizer state, so parameters are stored
    model-sharded and replicated over the data axes."""
    path = tuple(p for p in path if not p.isdigit())
    name = path[-1]
    fsdp = None if infer else "data"   # ZeRO storage axis
    tp = "model"

    if name in ("embed",):
        # feature-dim sharding only (a vocab-sharded table turns the token
        # gather into a full rematerialization in the reference)
        return _spec(mesh, shape, None, tp)          # [V, D]
    if name == "lm_head":
        return _spec(mesh, shape, fsdp, tp)          # [D, V]
    if name in ("enc_pos", "dec_pos"):
        return _spec(mesh, shape, None, fsdp)
    if name in ("wq", "wk", "wv", "wqkv"):
        return _spec(mesh, shape, fsdp, tp)          # [D, (H+2K)*dh]
    if name == "wo":
        return _spec(mesh, shape, tp, fsdp)          # [H*dh, D]
    if name in ("bq", "bk", "bv", "bqkv"):
        return _spec(mesh, shape, tp)
    if name in ("w_gate", "w_up", "w_down", "w_gate_up") \
            and "experts" in path:
        if cfg.moe_strategy == "ep":
            # EP: experts over model, ZeRO d_model/d_ff over data
            if name == "w_down":                     # [E, F, D]
                return _spec(mesh, shape, tp, fsdp, None)
            return _spec(mesh, shape, tp, fsdp, None)  # [E, D, F]
        # TP: expert hidden over model, ZeRO d_model over data
        if name == "w_down":                         # [E, F, D]
            return _spec(mesh, shape, None, tp, fsdp)
        return _spec(mesh, shape, None, fsdp, tp)    # [E, D, F]
    if name in ("w_gate", "w_up", "w_gate_up"):
        return _spec(mesh, shape, fsdp, tp)          # [D, F] / [D, 2F]
    if name == "w_down":
        return _spec(mesh, shape, tp, fsdp)          # [F, D]
    if name == "router":
        return _spec(mesh, shape, fsdp, None)        # [D, E]
    ssm_tp = tp if getattr(cfg, "ssm_proj_tp", True) else None
    if name == "in_proj":
        return _spec(mesh, shape, fsdp, ssm_tp)      # [D, di+cdim+H]
    if name == "out_proj":
        return _spec(mesh, shape, ssm_tp, fsdp)      # [di, D]
    if name == "out_norm":
        return _spec(mesh, shape, ssm_tp)            # [di]
    if name == "conv_w":
        return _spec(mesh, shape, None, ssm_tp)      # [ck, cdim]
    if name == "conv_b":
        return _spec(mesh, shape, ssm_tp)
    # norms, scalars, per-head vectors: replicate
    return ()


def params_shardings(tree, cfg, mesh: Mesh, *, infer: bool = False):
    """:class:`NamedSharding`\\ s in the nesting of ``tree``: a
    ``ParamTree`` (or any ``nn.Module``) gives ``{name: sharding}`` over
    its named parameters; a dict of tensors and dicts (a flat state dict,
    AdamW's ``{"mu", "nu"}`` or Adafactor's ``{path: {"vr", "vc"}}``)
    gives the same dict.  A leaf's path is its keys split on ``.``,
    without layer indices and optimizer slot names; a factored Adafactor
    slot, which drops the last dim, has its spec cut to its rank."""
    def one(keys, leaf):
        names = tuple(n for k in keys for n in k.split(".")
                      if n not in OPT_SLOTS and not n.isdigit())
        shape = tuple(leaf.shape)
        spec = param_spec(names if names else ("?",), shape, cfg, mesh,
                          infer=infer)
        if len(spec) > len(shape):
            spec = spec[:len(shape)]
        return NamedSharding(mesh, spec)

    def walk(keys, t):
        if isinstance(t, dict):
            return {k: walk(keys + (k,), v) for k, v in t.items()}
        return one(keys, t)

    if hasattr(tree, "named_parameters"):
        tree = dict(tree.named_parameters())
    return walk((), tree)


# --------------------------------------------------------------------- #
# activations / inputs / caches                                          #
# --------------------------------------------------------------------- #
def batch_spec(mesh: Mesh, global_batch: int, rank: int = 2) -> tuple:
    ba = batch_axes(mesh)
    if not _ok(global_batch, mesh, ba):
        ba = ("data",) if _ok(global_batch, mesh, ("data",)) else None
    return (ba, *([None] * (rank - 1)))


def attn_cache_spec(cfg, mesh: Mesh, batch: int) -> tuple:
    """[L, B, S, K, dh] KV cache: heads over model when divisible, else
    sequence over model; batch over the data axes; batch 1 also shards
    the sequence over data (long-context SP)."""
    ba = batch_axes(mesh)
    K = cfg.n_kv_heads
    heads_ok = K % mesh.shape["model"] == 0
    if batch == 1:
        seq_ax = "data" if heads_ok else ("data", "model")
        return (None, None, seq_ax, "model" if heads_ok else None, None)
    bax = ba if batch % _axsize(mesh, ba) == 0 else (
        ("data",) if batch % mesh.shape["data"] == 0 else None)
    if heads_ok:
        return (None, bax, None, "model", None)
    return (None, bax, "model", None, None)


def _axsize(mesh, axes):
    s = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        s *= mesh.shape[a]
    return s


def ssm_cache_spec(cfg, mesh: Mesh, batch: int) -> SSMCache:
    """SSMCache(state=[L,B,H,P,N], conv=[L,B,ck-1,cdim]) specs."""
    ba = batch_axes(mesh)
    bax = ba if batch % _axsize(mesh, ba) == 0 else None
    h_ax = "model" if cfg.ssm_heads % mesh.shape["model"] == 0 else None
    cd_ax = "model" if (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) \
        % mesh.shape["model"] == 0 else None
    return SSMCache(state=(None, bax, h_ax, None, None),
                    conv=(None, bax, None, cd_ax))


def caches_shardings(cfg, mesh: Mesh, batch: int):
    """Shardings in the layout of ``Model.init_caches`` (the port's
    caches keep the reference's stacked [L, ...] layout per family)."""
    fam = cfg.family
    kv = lambda: {"k": NamedSharding(mesh, attn_cache_spec(cfg, mesh, batch)),
                  "v": NamedSharding(mesh, attn_cache_spec(cfg, mesh, batch))}

    def ssm():
        sp = ssm_cache_spec(cfg, mesh, batch)
        return SSMCache(state=NamedSharding(mesh, sp.state),
                        conv=NamedSharding(mesh, sp.conv))
    if fam in ("dense", "vlm", "moe"):
        return kv()
    if fam == "ssm":
        return ssm()
    if fam == "hybrid":
        return {"ssm": ssm(), "attn": kv()}
    if fam == "encdec":
        return {"self": kv(), "cross": kv()}
    raise ValueError(fam)
