"""Logical-axis sharding rules, resolved per (config, mesh), and their
DTensor placements.

The port of `repro.distributed.sharding`. Every parameter, cache and
activation dim carries a LOGICAL axis name (`PSpec.axes`); `Rules` maps a
name to physical mesh axes and degrades to replication where the dim
does not divide the mesh axis: minicpm's 36 heads and whisper's 6 cannot
be tensor-parallel 16 ways, so "heads" resolves to None for them and the
FFN still takes TP through "mlp". The decisions are the JAX package's,
one for one; `Rules` reads only the mesh's axis sizes.

`pspec(*logical)` gives a tuple with, per tensor dim, a tuple of mesh
axes or None (JAX's PartitionSpec as a tuple). `placements(*logical)`
turns it into DTensor placements, one per mesh dim: a tensor dim over
("pod", "data") is Shard(d) on both mesh dims, pod-major, as JAX lays
P(("pod", "data")) out. `constrain(x, rules, *logical)` redistributes a
DTensor to those placements (JAX's `with_sharding_constraint`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import HBM_BYTES, mesh_axes

# Logical axis vocabulary. Values are the *preferred* physical axes;
# Rules.resolve() drops entries that don't divide.
DEFAULT_RULES: dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),     # pure DP
    "seq": (),                    # unsharded by default
    "seq_sp": ("model",),         # sequence parallelism (MoE dispatch, cache)
    "embed": ("data",),           # FSDP: weight d_model dim over data axis
    "heads": ("model",),          # Megatron TP
    "kv_heads": ("model",),
    "mlp": ("model",),            # d_ff TP
    "experts": ("model",),        # EP
    "vocab": ("model",),
    "lru": ("model",),            # RG-LRU width / SSM inner dim
    "cache_seq": ("model",),      # decode KV cache sequence sharding (SP)
    "cache_batch": ("pod", "data"),
    "packed": (),                 # 2-bit/nibble-packed contraction dims:
                                  # sub-byte strides cannot take FSDP slicing
                                  # -> replicated; the output dim keeps TP
    "frames": (),                 # encoder frames / vision patches
    "replicated": (),
}


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: object         # a DeviceMesh, or anything with a `shape` dict
    sizes: dict          # logical axis -> dim size it must divide (0=any)
    table: dict

    @staticmethod
    def make(mesh, cfg=None, shape=None, overrides: Optional[dict] = None,
             *, hbm_bytes: float = HBM_BYTES) -> "Rules":
        """`hbm_bytes`: one device's memory. The inference profile drops
        FSDP unless the TP-sharded weights alone would take half of it
        (the JAX package's 8 GiB of a 16 GiB TPU: pass 16 GiB for its
        decisions)."""
        axes = mesh_axes(mesh)
        sizes = {}
        if cfg is not None:
            sizes = {
                "heads": cfg.n_heads,
                "kv_heads": cfg.n_kv_heads,
                "mlp": cfg.d_ff,
                "embed": cfg.d_model,
                "vocab": cfg.vocab_padded,
                "experts": cfg.moe.n_experts if cfg.moe else 0,
                "lru": (cfg.hybrid.lru_width if cfg.hybrid
                        else (cfg.ssm.expand * cfg.d_model if cfg.ssm else 0)),
            }
            if cfg.moe and cfg.moe.sharding == "tp":
                # experts don't divide the model axis -> TP the expert FFN
                sizes["experts"] = 1  # force replication of the expert axis
        if shape is not None:
            sizes["batch"] = shape.global_batch
            sizes["cache_batch"] = shape.global_batch
            sizes["seq_sp"] = shape.seq_len
            sizes["cache_seq"] = shape.seq_len
        if cfg is not None:
            tp = axes.get("model", 1)
            if cfg.n_kv_heads and tp > 1 and cfg.n_kv_heads % tp == 0:
                # KV heads take the model axis -> the cache seq dim must
                # not double-claim it (SP on the cache is the fallback for
                # kv_heads < tp only)
                sizes["cache_seq"] = 1
        table = dict(DEFAULT_RULES)
        if shape is not None and shape.kind != "train" and cfg is not None:
            # Inference profile: no optimizer state, so FSDP weight
            # sharding buys nothing and costs an all-gather a layer a
            # step; keep the weights TP-sharded only, unless the
            # TP-sharded weights alone would take half the device's
            # memory (grok-1 at 16 GiB: 316B * 2 B / 16 = 39.5 GiB ->
            # keep FSDP for serving).
            tp = axes.get("model", 1)
            if cfg.param_count() * 2 / tp < hbm_bytes / 2:
                table["embed"] = ()
        if overrides:
            table.update(overrides)
        return Rules(mesh, sizes, table)

    @property
    def axis_sizes(self) -> dict:
        return mesh_axes(self.mesh)

    def resolve(self, logical: Optional[str]) -> Optional[Tuple[str, ...]]:
        """Logical axis -> tuple of mesh axes (or None = replicated)."""
        if logical is None:
            return None
        shape = self.axis_sizes
        axes = [a for a in self.table.get(logical, ()) if a in shape]
        if not axes:
            return None
        total = 1
        for a in axes:
            total *= shape[a]
        need = self.sizes.get(logical, 0)
        if need and need % total != 0:
            # try progressively smaller prefixes before replicating
            for cut in range(len(axes) - 1, 0, -1):
                t = 1
                for a in axes[:cut]:
                    t *= shape[a]
                if need % t == 0:
                    return tuple(axes[:cut])
            return None
        return tuple(axes) if axes else None

    def pspec(self, *logical_axes) -> tuple:
        return tuple(self.resolve(a) for a in logical_axes)

    def placements(self, *logical_axes) -> tuple:
        """DTensor placements (one per mesh dim) of a tensor whose dims
        carry `logical_axes`."""
        return spec_placements(self.mesh, self.pspec(*logical_axes))


def spec_placements(mesh, spec) -> tuple:
    """A pspec tuple -> DTensor placements on `mesh` (a DeviceMesh):
    Shard(d) on each mesh dim that tensor dim d names, Replicate() on the
    others. A dim over several mesh axes takes them in mesh order. A
    one-rank mesh axis that two dims claim (the rules keep "kv_heads" and
    "cache_seq" apart only where "model" is wider than one) shards the
    first: it splits nothing either way."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} over {axes}: a dim takes its mesh "
                             f"axes in mesh order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                if mesh.shape[i] == 1:
                    continue
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of {spec}")
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spans_ranks(w) -> bool:
    """Whether `w` is a DTensor on a mesh of more than one rank: a
    product with it may leave partial sums across ranks."""
    return is_dtensor(w) and w.device_mesh.size() > 1


def product_operand(x):
    """A DTensor left operand of x (..., K) @ w with its inner leading
    dims (all but the first and K) whole: the product flattens them into
    rows, and DTensor's view rules refuse to flatten a sharded inner dim
    (a sequence-parallel residual stream gathers its sequence here, as
    the Megatron-SP block entry does). Anything else as it is."""
    if not is_dtensor(x) or x.ndim <= 2:
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if isinstance(p, Shard)
                 and 0 < p.dim < x.ndim - 1 else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def sharded_matmul(x, w):
    """x @ w (w (K, N), or a bank (E, K, N) against x (E, M, K)) for a
    DTensor w. On a mesh of more than one rank every partial sum a rank
    holds, in the product (a contraction over a tensor-parallel K) and in
    its backward (the input gradient's contraction over a tensor-parallel
    N, the weight gradient's over the data-parallel rows), is taken in
    float32, summed across ranks in float32 and rounded once to its
    dtype, as one device's product accumulates the whole contraction
    before it rounds (a bf16 partial would round twice); on one rank the
    products keep the operands' dtype. The left operand and the incoming
    gradient keep their rows whole (`product_operand`) in both passes."""
    return _DTensorMatmul.apply(product_operand(x), w)


def _reduce(y, placements=None):
    """Partial placements of y summed (to `placements`, or to Replicate
    on those mesh dims)."""
    from torch.distributed.tensor import Partial, Replicate
    if placements is None:
        placements = tuple(Replicate() if isinstance(p, Partial) else p
                           for p in y.placements)
    if tuple(placements) != tuple(y.placements):
        y = y.redistribute(y.device_mesh, placements)
    return y


class _DTensorMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        dt = torch.promote_types(x.dtype, w.dtype)
        if spans_ranks(w):
            return _reduce(x.float() @ w.float()).to(dt)
        return x.to(dt) @ w.to(dt)

    @staticmethod
    def backward(ctx, gy):
        from torch.distributed.tensor import Partial, Replicate
        x, w = ctx.saved_tensors
        ct = (torch.float32 if spans_ranks(w)
              else torch.promote_types(x.dtype, w.dtype))
        g, xc, wc = product_operand(gy).to(ct), x.to(ct), w.to(ct)
        gx_at = [Replicate() if isinstance(p, Partial) else p
                 for p in x.placements]
        gx = _reduce(g @ wc.mT, gx_at).to(x.dtype)
        if w.ndim == 2:
            K, N = w.shape
            gw = xc.reshape(-1, K).mT @ g.reshape(-1, N)
        else:
            gw = xc.mT @ g
        return gx, _reduce(gw, w.placements).to(w.dtype)


def constrain(x, rules: Optional[Rules], *logical_axes):
    """Redistribute a DTensor to the placements of `logical_axes`
    (differentiable); the identity without rules and on a plain tensor
    (a rank-local value: a kernel operand, a shard)."""
    if rules is None or not is_dtensor(x):
        return x
    want = rules.placements(*logical_axes)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_spec(x, spec):
    """`constrain` by a pspec tuple (mesh axes per dim) rather than by
    logical axes."""
    if not is_dtensor(x):
        return x
    want = spec_placements(x.device_mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def replicate(x):
    """A DTensor redistributed to replicate on every mesh dim (the
    operand of an op with no sharding strategy); a plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gather_weights(tree, rules: Optional[Rules], skip=()):
    """The weights of `tree` as a layer computes with them: every DTensor
    leaf all-gathered over the data-parallel mesh axes ("pod", "data",
    the FSDP shards of "embed"), its tensor-parallel shards kept. The
    backward of the gather reduce-scatters the gradient back to the
    stored placements. Each row's contraction over d_model then runs in
    one product, as on one device. Top-level keys in `skip` (the stacked
    layers, gathered a layer at a time) pass as they are; so does the
    whole tree without rules."""
    if rules is None:
        return tree
    from repro_torch.tree import tree_map
    if skip:
        return {k: v if k in skip else tree_map(_gather_dp, v)
                for k, v in tree.items()}
    return tree_map(_gather_dp, tree)


def _gather_dp(x):
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in ("pod", "data") else p
                 for i, p in enumerate(x.placements))
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def local_shard(t, mesh, spec):
    """A tensor that every rank holds whole (drawn from one seed) as a
    DTensor at `spec`'s placements: each rank keeps a copy of its own
    shard (never a view of `t`, which in-place updates would reach), with
    no communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    at = spec_placements(mesh, spec)
    d = distribute_tensor(t, mesh, at, src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), mesh, at,
                              shape=d.shape, stride=d.stride())


def dtensor_mode(rules: Optional[Rules]):
    """The context a sharded step runs in: plain tensors that meet a
    DTensor (positions, masks, constants: the same on every rank) count
    as replicated. A null context without rules."""
    import contextlib
    if rules is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def tree_pspecs(abstract_tree, rules: Rules):
    """Map a tree of PSpec leaves to pspec tuples."""
    from repro_torch.models.params import PSpec
    from repro_torch.tree import tree_map
    return tree_map(lambda l: rules.pspec(*l.axes) if isinstance(l, PSpec)
                    else (), abstract_tree)
