"""Trees of tensors: nested dicts, tuples (NamedTuples), lists and None
over leaves, flattened in `jax.tree.flatten`'s order (dict keys sorted,
tuple and NamedTuple fields in order, None holding no leaf). The order is
what the checkpoint format numbers leaves by."""
from __future__ import annotations


def flatten(tree):
    """(leaves, treedef)."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k]) for k in keys])
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return ("namedtuple", type(t), [walk(x) for x in t])
        if isinstance(t, (tuple, list)):
            return (type(t).__name__, None, [walk(x) for x in t])
        if t is None:
            return ("none", None, [])
        leaves.append(t)
        return ("leaf", None, [])

    return leaves, walk(tree)


def unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        kind, aux, kids = d
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(aux, vals))
        if kind == "namedtuple":
            return aux(*vals)
        return tuple(vals) if kind == "tuple" else vals

    return build(treedef)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and of the trees in `rest` (the same
    structure), as `jax.tree.map`."""
    leaves, treedef = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def describe(treedef) -> str:
    """A readable form of a treedef (the checkpoint manifest's)."""
    kind, aux, kids = treedef
    if kind == "leaf":
        return "*"
    if kind == "none":
        return "None"
    inner = ", ".join(describe(k) for k in kids)
    if kind == "dict":
        return "{" + ", ".join(f"'{k}': {describe(c)}"
                               for k, c in zip(aux, kids)) + "}"
    if kind == "namedtuple":
        return f"{aux.__name__}({inner})"
    return f"({inner})" if kind == "tuple" else f"[{inner}]"
