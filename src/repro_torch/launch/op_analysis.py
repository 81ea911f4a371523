"""Per-step totals of a traced step: the port of
`repro.launch.hlo_analysis`.

The JAX module re-derives a step's roofline terms from the compiled HLO,
multiplying each loop body by a trip count it reconstructs from the
loop's condition. Torch has no HLO: `OpAnalysis`, a `TorchDispatchMode`
entered around the step, reads the ops the step dispatches instead. A
Python loop runs, so each iteration is counted as it runs: the trip
counts come for free. It totals

  * `flops`: matmul-class ops as the HLO analysis counts dots, 2 *
    prod(out) * prod(contracting), from `torch.utils.flop_counter`'s
    formula registry (an op not in it is decomposed first, as
    `FlopCounterMode` does, so the totals are that mode's), plus each
    kernel's own;
  * `bytes_accessed`: operand plus result bytes of every op; views,
    metadata and allocation ops move nothing and are skipped, as
    `SKIP_BYTES_OPS` skips bitcast / tuple there; plus each kernel's
    bound bytes;
  * `ops_by_name`: how many times each aten op ran;
  * `kernels`: launches, FLOPs and bytes per kernel entry of
    `kernels/ops.py`, reported by their meta routes (`kernels/meta.py`);
  * `peak_live_bytes`: the most bytes the tensors the step made held at
    once (each op result from its op until it is freed; an in-place
    result and a view are not new), the step's temporaries and outputs;
  * `shapes`: with a watch list of (shape, dtype) patterns, how many op
    results (views aside: they make no tensor) matched each, in any dim
    order, and by which ops.

On `meta` tensors nothing is computed or allocated, so a step of any
size traces on the host.
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import meta as kmeta

aten = torch.ops.aten

# metadata queries: not ops of the step (FlopCounterMode's own list)
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format,
             aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default,
             aten.sym_stride.default, aten.storage_offset.default,
             aten.sym_storage_offset.default, aten.numel.default,
             aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}

# ops that allocate or read metadata: no bytes move
SKIP_BYTES_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "lift_fresh", "_local_scalar_dense"}


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpAnalysis(TorchDispatchMode):
    """Totals of the ops dispatched while entered; `watch` is a list of
    (shape, dtype) patterns whose matching results are counted."""

    def __init__(self, watch=()):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.ops_by_name = Counter()
        self.kernels: dict[str, dict] = {}
        self.watch = [(tuple(sorted(s)), d) for s, d in watch]
        self.shapes = [Counter() for _ in self.watch]
        self.live = {}          # id of a tensor the step made -> bytes
        self.live_bytes = 0
        self.peak_live_bytes = 0

    def __enter__(self):
        # entered again by itself around a decomposition: observe once
        self._depth = getattr(self, "_depth", 0) + 1
        if self._depth == 1:
            kmeta.OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            kmeta.OBSERVERS.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name: str, flops: int, n_bytes: int) -> None:
        """One launch of kernel entry `name` (from its meta route)."""
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += n_bytes
        self.flops += flops
        self.bytes_accessed += n_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        packet = func._overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = packet.__name__
        self.ops_by_name[name] += 1
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if _is_view(func):
            return out
        if name not in SKIP_BYTES_OPS:
            self.bytes_accessed += _tensor_bytes((args, kwargs)) \
                + _tensor_bytes(out)
        if not any(r.alias_info for r in func._schema.returns):
            for t in tree_leaves(out):       # not written into an operand
                if isinstance(t, torch.Tensor):
                    self._made(t)
        for i, (shape, dtype) in enumerate(self.watch):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.dtype == dtype \
                        and tuple(sorted(t.shape)) == shape:
                    self.shapes[i][name] += 1
        return out

    def _made(self, t: torch.Tensor) -> None:
        key = id(t)
        n = t.numel() * t.element_size()
        self.live[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(t, self._freed, key)

    def _freed(self, key) -> None:
        self.live_bytes -= self.live.pop(key)

    def totals(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "ops_by_name": dict(self.ops_by_name),
                "peak_live_bytes": self.peak_live_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "shapes": [dict(c) for c in self.shapes]}


def analyze(fn, *args, watch=(), **kwargs):
    """(fn(*args, **kwargs), the totals of the ops it dispatched)."""
    with OpAnalysis(watch) as a:
        out = fn(*args, **kwargs)
    return out, a.totals()
