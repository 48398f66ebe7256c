"""Partition rules: buffer name + shape → spec → DTensor placements (port
of ``repro/sharding/rules.py``).

Mesh axes (see :mod:`repro_torch.launch.mesh`):

  * ``pod``   — pure data parallelism across pods
  * ``data``  — FSDP: params + optimizer state sharded, gathered per use
  * ``model`` — tensor parallelism (attention heads / FFN columns / MoE
                experts / vocab)

A *spec* is JAX's ``PartitionSpec`` as a tuple, one entry per tensor dim:
a mesh axis name, a tuple of names (the dim split over them, the first
the major one), or ``None``. :func:`placements` turns it into one DTensor
placement per mesh dim (``Shard(d)`` or ``Replicate()``), and
:func:`distribute_model` turns every buffer of a model into a DTensor.

The role tables are the JAX package's, keyed by a tensor's last name and
its parent's, and every rule degrades as there: a dim is sharded only when
divisible by the mesh axis and at least ``min_shard`` wide. The port's
tensors differ from JAX's leaves in four ways, and each rule reads the
port's tensor as the JAX leaf it stands for:

  * **no scan stacks** — the converter unstacks JAX's ``groups`` (and the
    vmapped encoder) into one block per layer. A leaf's spec there is
    computed on its stacked shape, so a stacked 1-D leaf (``lam``,
    ``conv_b``) falls to the 2-D default rule: the port passes the stack
    (``stack``: the group or encoder layer count) and drops its entry, so a
    port tensor's spec is JAX's for the same leaf with the group axis
    dropped.
  * **the embedding** is the bare buffer ``embed`` where JAX has
    ``embed/w``: the same (vocab → model, d → data) rule.
  * **the cross memory** is head-major (B, KV, S, hd) where JAX's is
    sequence-major (B, S, KV, hd): its rule shards the same logical dims
    (the KV heads first, else the sequence), transposed.
  * **MLA's latent cache** is one ``lat`` (B, S, r + pe) tensor where JAX
    keeps ``ckv`` and ``kpe``: both shard their sequence dim, and so does
    ``lat``.

Names are dotted buffer paths (``blocks.3.mixer.wq.codes``,
``blocks.1.mlp.experts.up.w``); a ``mesh`` is a ``DeviceMesh`` or a
``{axis: size}`` mapping (specs need only the sizes).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import (DeviceMesh, DTensor, Placement,
                                      Replicate, Shard, distribute_tensor)
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro_torch.models.transformer import layer_layout

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# weights whose *output* (last) dim is TP-sharded
_COL_PARALLEL = {
    "wq", "wk", "wv", "up", "gate", "up_gate", "w_gate", "w_branch",
    "w_gates", "ffn_up", "w_if", "lm_head", "frontend_proj", "vision_proj",
    "kv_down", "k_up", "v_up", "q_up", "q_proj", "w_kpe",
}
# weights whose *input* (second-to-last) dim is TP-sharded
_ROW_PARALLEL = {"wo", "down", "w_out", "ffn_down"}
# small / replicated by name
_REPLICATED = {"g", "b", "conv_w", "router", "a_param", "conv_state",
               "w_a", "w_x"}


def axis_sizes(mesh: Union[DeviceMesh, Mapping[str, int]]) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (its dim names) or a mapping."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def _divisible(dim: int, axis_size: int, min_shard: int) -> bool:
    return axis_size > 1 and dim >= min_shard and dim % axis_size == 0


def _stack_of(cfg, name: str) -> Tuple[int, ...]:
    """The stacked dims JAX's tree holds in front of buffer ``name``: the
    group count for a layer of a scanned group, the encoder's layer count
    for an encoder layer, none otherwise."""
    parts = name.split(".")
    if cfg is None or len(parts) < 2 or not parts[1].isdigit():
        return ()
    if parts[0] == "encoder":
        return (cfg.enc_layers,)
    if parts[0] != "blocks":
        return ()
    n_prefix, n_groups, _ = layer_layout(cfg)
    i = int(parts[1])
    return ((n_groups,)
            if n_prefix <= i < n_prefix + n_groups * len(cfg.block_pattern)
            else ())


def reference_path(cfg, name: str) -> Tuple[Tuple, bool]:
    """(path, stacked): the JAX package's tree path of the leaf the port's
    buffer ``name`` stands for (dict keys and list indices; a stacked
    leaf's group or encoder index dropped), and whether that leaf carries
    the stacked axis. ``embed`` is JAX's ``embed/w``, ``enc_norm`` its
    ``encoder/final_norm``, an MoE block's ``mlp`` its ``moe``."""
    parts = name.split(".")
    if parts == ["embed"]:
        return ("embed", "w"), False
    if parts[0] == "enc_norm":
        return ("encoder", "final_norm", *parts[1:]), False
    if parts[0] == "encoder":
        return ("encoder", "blocks", *parts[2:]), True
    if parts[0] != "blocks":
        return tuple(parts), False
    rest = parts[2:]
    if rest[:1] == ["mlp"] and rest[1:2] and rest[1] in ("router", "experts",
                                                          "shared"):
        rest = ["moe"] + rest[1:]
    n_prefix, n_groups, _ = layer_layout(cfg)
    period = len(cfg.block_pattern)
    i = int(parts[1])
    if i < n_prefix:
        return ("prefix", i, *rest), False
    j = i - n_prefix
    if j < n_groups * period:
        return ("groups", f"p{j % period}", *rest), True
    return ("suffix", j - n_groups * period, *rest), False


def spec_for_param(
    name: str,
    shape: Sequence[int],
    mesh,
    fsdp_axis: str = "data",
    tp_axis: str = "model",
    min_shard: int = 128,
    stack: Sequence[int] = (),
) -> Spec:
    """Spec for one buffer of the model, ``name`` its dotted path; with
    ``stack``, computed on ``stack + shape`` (JAX's stacked leaf) and the
    stacked entries dropped."""
    names = name.split(".")
    axes = axis_sizes(mesh)
    fsdp = fsdp_axis if fsdp_axis in axes else None
    tp = tp_axis if tp_axis in axes else None
    fsdp_n = axes.get(fsdp_axis, 1)
    tp_n = axes.get(tp_axis, 1)
    shape = tuple(stack) + tuple(shape)
    drop = len(stack)

    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    in_experts = "experts" in names
    ndim = len(shape)

    def shard(dim_size: int, axis: Optional[str], axis_n: int) -> Optional[str]:
        return axis if axis and _divisible(dim_size, axis_n, min_shard) else None

    # ---- 1-D / small tensors --------------------------------------------
    if ndim <= 1 or leaf in _REPLICATED:
        out: List[Axis] = [None] * max(ndim, 0)
        # per-expert 1-D params still shard the expert dim
        if in_experts and ndim >= 1:
            out[0] = shard(shape[0], tp, tp_n)
        return tuple(out[drop:])

    # ---- role of the trailing 2 dims -------------------------------------
    m, n = shape[-2], shape[-1]
    if leaf == "embed" or (leaf == "w" and "embed" in names):
        two = (shard(m, tp, tp_n), shard(n, fsdp, fsdp_n))       # (vocab, d)
    elif leaf in _ROW_PARALLEL or (leaf == "w" and parent in _ROW_PARALLEL):
        two = (shard(m, tp, tp_n), shard(n, fsdp, fsdp_n))
    elif leaf in _COL_PARALLEL or (leaf == "w" and parent in _COL_PARALLEL):
        two = (shard(m, fsdp, fsdp_n), shard(n, tp, tp_n))
    elif leaf in ("codes", "packed", "scale", "l"):
        # quantized-backbone containers: inherit the parent linear's role
        row = parent in _ROW_PARALLEL
        if leaf == "l":       # (m, rank): rank never sharded
            two = (shard(m, tp if row else fsdp,
                         tp_n if row else fsdp_n), None)
        elif row:
            two = (shard(m, tp, tp_n), shard(n, fsdp, fsdp_n))
        else:
            two = (shard(m, fsdp, fsdp_n), shard(n, tp, tp_n))
    elif leaf == "r":          # (rank, n): follow the output dim's role
        row = parent in _ROW_PARALLEL
        two = (None, shard(n, fsdp if row else tp,
                           fsdp_n if row else tp_n))
    else:
        # default 2-D: FSDP the larger dim, TP the other when divisible
        if m >= n:
            two = (shard(m, fsdp, fsdp_n), shard(n, tp, tp_n))
        else:
            two = (shard(m, tp, tp_n), shard(n, fsdp, fsdp_n))

    # ---- leading dims: expert dim → TP; scan/layer dims → replicated ----
    lead: List[Axis] = [None] * (ndim - 2)
    if in_experts and ndim >= 3 and tp and _divisible(shape[ndim - 3], tp_n, 1):
        # Expert parallelism wins the model axis: each device owns E/tp
        # whole experts rather than slicing every small expert tp-ways.
        lead[-1] = tp
        two = tuple(a if a != tp else None for a in two)
    return tuple(lead + list(two))[drop:]


def tree_param_specs(model: torch.nn.Module, mesh, **kw) -> Dict[str, Spec]:
    """``{buffer name: spec}`` of a model (an ``LM``: its config gives
    each layer's JAX stack)."""
    cfg = getattr(model, "cfg", None)
    return {name: spec_for_param(name, t.shape, mesh,
                                 stack=_stack_of(cfg, name), **kw)
            for name, t in model.named_buffers()}


def placements(spec: Spec, mesh: DeviceMesh) -> List[Placement]:
    """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim
    ``d``'s spec names the mesh dim, else ``Replicate()``. A dim split over
    a tuple of axes splits major-to-minor in the tuple's order, which must
    be the mesh's dim order (DTensor splits a dim over mesh dims in that
    order), as JAX's ``('pod', 'data')`` is."""
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        group = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {group} of dim {d} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def tree_shardings(model: torch.nn.Module, mesh: DeviceMesh,
                   **kw) -> Dict[str, List[Placement]]:
    """``{buffer name: placements}`` of a model."""
    return {name: placements(spec, mesh)
            for name, spec in tree_param_specs(model, mesh, **kw).items()}


def check_divides(name: str, shape: Sequence[int], spec: Spec,
                  mesh) -> None:
    """Raise where a sharded dim does not divide evenly over its axes (the
    counterpart of the JAX dry run failing at ``.compile()``)."""
    axes = axis_sizes(mesh)
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= axes[a]
        if dim % n:
            raise ValueError(f"{name} {tuple(shape)}: dim {dim} does not "
                             f"divide over {ax} ({n}) in spec {spec}")


def distribute(name: str, t: torch.Tensor, spec: Spec,
               mesh: DeviceMesh) -> torch.Tensor:
    """``t`` as a DTensor over ``mesh`` by ``spec`` (checked to divide). A
    fake tensor (an abstract model) holds no data to split: its DTensor
    is built from this rank's local block of the same placements, the
    shape ``distribute_tensor`` would give it."""
    check_divides(name, t.shape, spec, mesh)
    pl = placements(spec, mesh)
    if not isinstance(t, FakeTensor):
        return distribute_tensor(t, mesh, pl)
    local, _ = _compute_local_shape_and_global_offset(
        t.shape, mesh.shape, mesh.get_coordinate(), pl)
    return DTensor.from_local(t.new_empty(local), mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_model(model: torch.nn.Module, mesh: DeviceMesh,
                     **kw) -> torch.nn.Module:
    """Every buffer of ``model`` turned into a DTensor over ``mesh`` by
    the rules, in place; returns the model."""
    specs = tree_param_specs(model, mesh, **kw)
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._buffers[leaf] = distribute(name, mod._buffers[leaf], spec, mesh)
    return model


# ==========================================================================
# Activation / batch / cache specs
# ==========================================================================
def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ('pod', 'data') when multi-pod."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """DP axes usable for this batch (drop axes the batch can't fill)."""
    sizes = axis_sizes(mesh)
    axes: Tuple[str, ...] = ()
    cap = 1
    for a in dp_axes(mesh):
        if global_batch % (cap * sizes[a]) == 0:
            axes = axes + (a,)
            cap *= sizes[a]
    return axes


def _entry(axes: Tuple[str, ...]) -> Axis:
    """A spec entry of ``axes``, as ``PartitionSpec`` normalises it: None
    for none, the bare name for one."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def batch_spec(mesh, global_batch: int, extra_dims: int = 1) -> Spec:
    """Spec for a (batch, ...) tensor: batch over usable DP axes."""
    return (_entry(batch_axes(mesh, global_batch)),) + (None,) * extra_dims


def data_shardings(mesh: DeviceMesh, batch: Dict[str, torch.Tensor],
                   global_batch: int) -> Dict[str, List[Placement]]:
    """Placements for a train/prefill batch dict."""
    return {k: placements(batch_spec(mesh, global_batch, v.ndim - 1), mesh)
            for k, v in batch.items()}


def spec_for_cache(
    key: str,
    shape: Sequence[int],
    mesh,
    global_batch: int,
    tp_axis: str = "model",
    min_shard: int = 16,
    stack: int = 0,
) -> Spec:
    """Decode-cache spec for one layer's tensor ``key``; ``stack`` = 1 for
    a layer JAX stacks in a scanned group (its spec is computed with the
    batch at dim 1, as JAX's, and that dim dropped).

    Batch (dim 0) over the usable DP axes. The TP axis goes to, in
    preference order: the KV-head dim, else the sequence (flash-decode)
    for the slot cache; the KV heads, else the sequence, for the cross
    memory; the sequence dim for MLA's latent; the widest non-batch dim
    of a recurrent state."""
    axes = axis_sizes(mesh)
    tp = tp_axis if tp_axis in axes else None
    tp_n = axes.get(tp_axis, 1)
    shape = (1,) * stack + tuple(shape)
    ndim = len(shape)
    if ndim == stack or key in ("pos", "slot_pos"):
        return (None,) * (ndim - stack)

    spec: List[Axis] = [None] * ndim
    b_dim = stack if ndim >= 2 else 0
    baxes = batch_axes(mesh, global_batch)
    if baxes and shape[b_dim] >= 1:
        spec[b_dim] = _entry(baxes)

    if tp is None:
        return tuple(spec[stack:])

    def try_dim(d: int) -> bool:
        if d < ndim and spec[d] is None and shape[d] % tp_n == 0 \
                and shape[d] >= min_shard:
            spec[d] = tp
            return True
        return False

    if key in ("k", "v", "k_scale", "v_scale") and ndim - b_dim >= 3:
        # head-major slot cache (B, KV, S, hd), scales (B, KV, S): KV
        # heads, else the sequence (int4 pages count byte rows = slot
        # pairs there)
        if not try_dim(b_dim + 1):
            try_dim(b_dim + 2)
    elif key in ("cross_k", "cross_v") and ndim - b_dim >= 3:
        # head-major here (B, KV, S, hd); JAX's sequence-major memory
        # shards its KV dim first, then its S dim: the same dims
        if not try_dim(b_dim + 1):
            try_dim(b_dim + 2)
    elif key == "lat" and ndim - b_dim == 3:
        try_dim(b_dim + 1)            # (B, S, r + pe): sequence dim
    elif ndim >= 2:
        # recurrent states: shard the widest non-batch dim
        cands = sorted(range(b_dim + 1, ndim), key=lambda d: -shape[d])
        for d in cands:
            if try_dim(d):
                break
    return tuple(spec[stack:])


def tree_cache_specs(cache: List[Dict[str, torch.Tensor]], mesh,
                     global_batch: int, cfg=None, **kw
                     ) -> List[Dict[str, Spec]]:
    """Each layer's ``{key: spec}`` of a cache (``init_cache``'s list);
    ``cfg`` tells which layers JAX stacks in a scanned group."""
    out = []
    for i, layer in enumerate(cache):
        stack = len(_stack_of(cfg, f"blocks.{i}"))
        out.append({key: spec_for_cache(key, t.shape, mesh, global_batch,
                                        stack=stack, **kw)
                    for key, t in layer.items()})
    return out


def tree_cache_shardings(cache: List[Dict[str, torch.Tensor]],
                         mesh: DeviceMesh, global_batch: int, cfg=None,
                         **kw) -> List[Dict[str, List[Placement]]]:
    return [{key: placements(spec, mesh) for key, spec in layer.items()}
            for layer in tree_cache_specs(cache, mesh, global_batch, cfg,
                                          **kw)]


def replicated(mesh: DeviceMesh) -> List[Placement]:
    return [Replicate()] * mesh.ndim


__all__ = [
    "Spec", "axis_sizes", "batch_axes", "batch_spec", "check_divides",
    "data_shardings", "distribute", "distribute_model", "dp_axes",
    "placements", "reference_path", "replicated", "spec_for_cache",
    "spec_for_param",
    "tree_cache_shardings", "tree_cache_specs", "tree_param_specs",
    "tree_shardings",
]
