"""Shared-prefix page reuse in the port (`serve/prefix.py`, the share band,
refcounts and copy-on-write of `serve/cache_pool.py`, the engine's
prefix wiring) against the JAX package on the same inputs, made from
seeds with numpy, at the reduced qwen1.5-0.5b config.

- `chain_hashes` and `PrefixIndex` (a numpy-only module, copied) give
  the JAX results on random streams.
- Scripted pool sequences (sharing, copy-on-write in the middle of a
  page and at its start, release, demotion under pressure, eviction at
  refcount 0, a refresh that restamps a shared page once) give the JAX
  pool's page tables, refcounts, free lists, live bytes, counters and
  every arena page >= 1, byte for byte.
- `_cow_page_op` for every (src_mode, dst_mode, aug_bits) gives JAX's
  arenas byte for byte.
- The engine, sharing on, gives the JAX engine's tokens and prefix
  counters on `tests/test_prefix.py`'s prompt streams, and the tokens of
  the port with sharing off.

Pages, tables and counters must match exactly. Tokens are compared
exactly, on prompts whose JAX top-1/top-2 logit margin exceeds
MIN_MARGIN at every decode step (checked). int8 oracles run in this
process; JAX's int4 pack reaches only its Pallas call, which this jax
runs only with `pltpu.TPUCompilerParams` aliased to
`pltpu.CompilerParams`, so the int4 oracles run in a CHILD process that
sets the alias before it imports `repro` (as tests/test_torch_serve.py
does), never here.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro.serve import prefix as jprefix
from repro_torch.configs import get_arch
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import prefix as tprefix
from repro_torch.serve.cache_pool import PagedKVPool, _cow_page_op

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
MIN_MARGIN = 1e-2
PAGE, CHUNK = 8, 8          # tests/test_prefix.py's engine geometry
NORMAL_PAGE = 16384         # reduced qwen: 2 x 2 layers x 4 x 16 x 32 x 2 B


# ---------------------------------------------------------------------------
# the oracles' shared source (runs here and, by source, in the child)
# ---------------------------------------------------------------------------

def _fill(shapes: dict, seed: int) -> dict:
    """Random arena contents as numpy: bf16 planes as float32 values that
    bf16 holds exactly (k / 64, scales k / 4096), packed planes as random
    bytes (uint8) or levels in [-127, 127] (int8)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {}
    for k in ("kn", "vn", "kp", "vp", "ks", "vs"):
        shape, kind = shapes[k]
        if k in ("kn", "vn"):
            out[k] = (rng.integers(-255, 256, shape) / 64.0).astype(
                np.float32)
        elif k in ("ks", "vs"):
            out[k] = (rng.integers(1, 256, shape) / 4096.0).astype(
                np.float32)
        elif kind == "uint8":
            out[k] = rng.integers(0, 256, shape).astype(np.uint8)
        else:
            out[k] = rng.integers(-127, 128, shape).astype(np.int8)
    return out


def _digest(a) -> str:
    """sha256 of an arena's pages >= 1 (page 0 is the write-dump page)."""
    import hashlib
    import numpy as np
    a = np.ascontiguousarray(a[:, 1:])
    if str(a.dtype) == "bfloat16":
        a = a.view(np.uint16)
    return hashlib.sha256(a.tobytes()).hexdigest()


def _run_script(p, idx, script: list) -> dict:
    """Drive pool `p` (and its prefix index `idx`) through `script`; the
    state after every op and the pool's counters at the end. The same
    code drives the JAX pool and the port's."""
    import numpy as np
    page = p.geom.page_size
    steps = []
    for step, op in enumerate(script):
        kind, args = op[0], op[1:]
        ret = None
        if kind == "admit":
            row, n, sh = args
            # an entry evicted earlier in the script is a miss
            shared = (None if sh is None or sh[0] not in idx.entries
                      else (p.entry_row(sh[0]), sh[1]))
            ret = bool(p.admit_row(row, n, step, shared=shared))
        elif kind == "register":
            src_row, n_pages, base = args
            slot = idx.acquire_slot(p, step)
            ret = slot
            if slot is not None:
                erow = p.entry_row(slot)
                p.register_entry_pages(erow, src_row, n_pages, step)
                idx.add_entry(slot, erow, np.arange(
                    base, base + n_pages * page, dtype=np.int32), step)
        elif kind == "ensure":
            ret = bool(p.ensure_position(args[0], args[1], step))
        elif kind == "release":
            p.release_row(args[0])
        elif kind == "refresh":
            due = p.refresh_due(step)
            for key in due:
                p.refresh(key, step)
            ret = sorted([int(r), int(l)] for r, l in due)
        elif kind == "note":
            p.note_token_writes(np.array([args[0]]), np.array([args[1]]),
                                step)
        elif kind == "can":
            ret = bool(p.can_admit_tokens(args[0]))
        elif kind == "evict":
            ret = bool(idx.evict_one(p, step))
        elif kind == "reclaim":
            ret = bool(p._reclaim_prefix(step))
        elif kind == "augment":
            p.augment_page(args[0], args[1], step)
        else:
            raise ValueError(kind)
        steps.append({
            "op": kind, "ret": ret,
            "table": np.asarray(p.page_table).tolist(),
            "mode": np.asarray(p.page_mode).tolist(),
            "alloc": np.asarray(p.allocated).tolist(),
            "live": int(p.live_bytes),
            "policies": sorted([int(r), int(l)] for r, l in p.policies),
            "refcount": sorted([int(m), int(ph), int(rc)]
                               for (m, ph), rc in p._refcount.items()),
            "free": [list(map(int, p.free_normal)),
                     list(map(int, p.free_packed))]})
    return {"steps": steps, "describe": {k: v for k, v in p.describe().items()
                                         if isinstance(v, (int, float, str))},
            "index": idx.describe()}


def _jax_pool_script(aug_bits: int, pool_mode: str, budget, script: list,
                     seed: int) -> dict:
    """The JAX pool through `script`, its arenas filled by `_fill`."""
    import dataclasses
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.serve.cache_pool import PagedKVPool
    from repro.serve.prefix import PrefixIndex
    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode=f"int{aug_bits}", pool_mode=pool_mode,
        prefix_cache=2))
    p = PagedKVPool(cfg, max_batch=2, max_seq=64, budget_bytes=budget,
                    retention_steps=2)
    shapes = {k: (tuple(v.shape), "bf16" if v.dtype == jnp.bfloat16
                  else str(v.dtype)) for k, v in p.arenas.items()}
    p.arenas = {k: jnp.asarray(v, p.arenas[k].dtype)
                for k, v in _fill(shapes, seed).items()}
    idx = PrefixIndex(2, p.geom.page_size)
    p.attach_prefix_index(idx)
    out = _run_script(p, idx, script)
    out["arenas"] = {k: _digest(np.asarray(v)) for k, v in p.arenas.items()}
    return out


def _jax_cow(aug_bits: int, src_mode: int, dst_mode: int, keep: int,
             seed: int) -> dict:
    """JAX's `_cow_page_op` on arenas filled by `_fill`: every arena's
    digest after it."""
    import jax.numpy as jnp
    from repro.serve.cache_pool import _cow_page_op
    shapes = _cow_shapes(aug_bits)
    dt = {"bf16": jnp.bfloat16, "uint8": jnp.uint8, "int8": jnp.int8}
    arenas = {k: jnp.asarray(v, dt[shapes[k][1]])
              for k, v in _fill(shapes, seed).items()}
    out = _cow_page_op(arenas, 1, 2, keep, src_mode=src_mode,
                       dst_mode=dst_mode, aug_bits=aug_bits)
    return {k: _digest(np.asarray(v)) for k, v in out.items()}


def _cow_shapes(aug_bits: int) -> dict:
    """Arenas of 4 pages a plane at the reduced widths (2 layers, 4 KV
    heads, page 16, hd 32)."""
    d = 16 if aug_bits == 4 else 32
    packed = "uint8" if aug_bits == 4 else "int8"
    return {"kn": ((2, 4, 4, 16, 32), "bf16"),
            "vn": ((2, 4, 4, 16, 32), "bf16"),
            "kp": ((2, 4, 4, 16, d), packed), "vp": ((2, 4, 4, 16, d), packed),
            "ks": ((2, 4, 4, 16), "bf16"), "vs": ((2, 4, 4, 16), "bf16")}


# ---------------------------------------------------------------------------
# scripted pool sequences (rows 0-1 decode, rows 2-3 the share band)
# ---------------------------------------------------------------------------

SCRIPTS = {
    # sharing, a mid-page copy in the Augmented plane, a refresh that
    # restamps each shared page once, release that rehomes the clock,
    # eviction only at refcount 0
    "always-augmented": (None, [
        ("admit", 0, 40, None), ("register", 0, 2, 0),
        ("admit", 1, 36, (0, 20)), ("ensure", 1, 20), ("refresh",),
        ("ensure", 1, 32), ("release", 0), ("note", 1, 33), ("refresh",),
        ("can", 64), ("evict",), ("release", 1), ("evict",),
        ("admit", 0, 64, None), ("refresh",)]),
    # a budget of four Normal pages: a copy lands in the Augmented plane,
    # idle prefix pages demote before anything is evicted, a demoted
    # shared page is copied back up, its refresh promotes every alias,
    # eviction last
    "augment-on-pressure": (4 * NORMAL_PAGE, [
        ("admit", 0, 40, None), ("register", 0, 2, 0),
        ("admit", 1, 36, (0, 20)), ("ensure", 1, 20), ("release", 0),
        ("release", 1), ("can", 64), ("admit", 0, 64, None),
        ("release", 0), ("admit", 1, 30, (0, 17)), ("ensure", 1, 17),
        ("ensure", 1, 16), ("refresh",), ("release", 1), ("reclaim",),
        ("can", 64)]),
    # pinned Normal plane, five pages: a Normal copy, allocation failing
    # while the entry is shared, eviction freeing it once it is idle
    "normal-only": (5 * NORMAL_PAGE, [
        ("admit", 0, 40, None), ("register", 0, 3, 100),
        ("admit", 1, 40, (0, 35)), ("ensure", 1, 35), ("ensure", 1, 36),
        ("release", 0), ("admit", 0, 64, None), ("release", 1),
        ("admit", 0, 64, None), ("register", 0, 2, 7), ("release", 0),
        ("can", 80)]),
}
SCRIPT_CASES = [(name, bits) for name in SCRIPTS for bits in (8, 4)]
COW_CASES = [(s, d, bits, keep) for s in (0, 1) for d in (0, 1)
             for bits in (4, 8) for keep in (0, 7, 16)]


def _script_seed(name, bits) -> int:
    return SCRIPT_CASES.index((name, bits))


CHILD = """
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax, jax.numpy as jnp
args = json.loads(sys.argv[1])
%s
out = {"scripts": {}, "cow": {}}
for name, budget, script, seed in args["scripts"]:
    out["scripts"][name] = _jax_pool_script(4, name, budget, script, seed)
for key, (s, d, keep, seed) in args["cow"].items():
    out["cow"][key] = _jax_cow(4, s, d, keep, seed)
with open(args["out"], "w") as f:
    json.dump(out, f)
"""


def _jsonable(script):
    return json.loads(json.dumps(script))


@pytest.fixture(scope="module")
def oracles(tmp_path_factory):
    """Every JAX result of this module: int4 from one child process
    (started first), int8 in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("prefix")
    src = "\n".join(inspect.getsource(f) for f in (
        _fill, _digest, _run_script, _jax_pool_script, _jax_cow,
        _cow_shapes))
    args = {"out": str(tmp / "int4.json"),
            "scripts": [[name, SCRIPTS[name][0], SCRIPTS[name][1],
                         _script_seed(name, 4)] for name in SCRIPTS],
            "cow": {f"{s}{d}-{keep}": [s, d, keep, COW_CASES.index(
                (s, d, 4, keep))] for s, d, bits, keep in COW_CASES
                if bits == 4}}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen([sys.executable, "-c", CHILD % src,
                              json.dumps(args)], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        res = {("script", name, 8): _jsonable(_jax_pool_script(
            8, name, SCRIPTS[name][0], SCRIPTS[name][1],
            _script_seed(name, 8))) for name in SCRIPTS}
        for s, d, bits, keep in COW_CASES:
            if bits == 8:
                res[("cow", s, d, 8, keep)] = _jax_cow(
                    8, s, d, keep, COW_CASES.index((s, d, 8, keep)))
        log, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    with open(tmp / "int4.json") as f:
        got = json.load(f)
    for name, r in got["scripts"].items():
        res[("script", name, 4)] = r
    for key, r in got["cow"].items():
        s, d, keep = int(key[0]), int(key[1]), int(key.split("-")[1])
        res[("cow", s, d, 4, keep)] = r
    return res


def _torch_arenas(arenas: dict, vals: dict) -> None:
    for k, v in vals.items():
        arenas[k].copy_(torch.from_numpy(v).to(arenas[k].dtype))


def _torch_digests(arenas: dict) -> dict:
    return {k: _digest(v.view(torch.int16).numpy().view(np.uint16)
                       if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in arenas.items()}


def _torch_pool_script(aug_bits, name):
    budget, script = SCRIPTS[name]
    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode=f"int{aug_bits}", pool_mode=name, prefix_cache=2))
    p = PagedKVPool(cfg, max_batch=2, max_seq=64, device=CPU,
                    budget_bytes=budget, retention_steps=2)
    shapes = {k: (tuple(v.shape), "bf16" if v.dtype == torch.bfloat16
                  else str(v.dtype).replace("torch.", ""))
              for k, v in p.arenas.items()}
    _torch_arenas(p.arenas, _fill(shapes, _script_seed(name, aug_bits)))
    idx = tprefix.PrefixIndex(2, p.geom.page_size)
    p.attach_prefix_index(idx)
    out = _run_script(p, idx, script)
    out["arenas"] = _torch_digests(p.arenas)
    return _jsonable(out)


@pytest.mark.parametrize("name,bits", SCRIPT_CASES)
def test_pool_script_matches_jax(oracles, name, bits):
    want = oracles[("script", name, bits)]
    got = _torch_pool_script(bits, name)
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert g == w, (i, SCRIPTS[name][1][i])
    assert got["describe"] == {k: want["describe"][k]
                               for k in got["describe"]}
    assert got["index"] == want["index"]
    assert got["arenas"] == want["arenas"]
    d = got["describe"]
    # the script reaches what it is there for
    if name == "always-augmented":
        assert d["cow_events"] >= 1 and d["refreshes"] > 0
        assert got["index"]["evicted"] == 1
    if name == "augment-on-pressure":
        assert d["cow_events"] >= 2 and d["prefix_demotions"] > 0
        assert d["prefix_evictions"] == 1
    if name == "normal-only":
        assert d["cow_events"] >= 1 and d["prefix_evictions"] >= 1
        assert d["alloc_failures"] > 0


def test_shared_refresh_restamps_once(oracles):
    """A shared page expiring appears ONCE in refresh_due, on its entry
    row's key, however many rows map it."""
    first = oracles[("script", "always-augmented", 8)]["steps"][4]
    # pages (2, 0) and (2, 1) are mapped by rows 0, 1 and the entry row;
    # (0, 2) and (1, 2) are private
    assert first["ret"] == [[0, 2], [1, 2], [2, 0], [2, 1]]


@pytest.mark.parametrize("src_mode,dst_mode,bits,keep", COW_CASES)
def test_cow_page_op_matches_jax(oracles, src_mode, dst_mode, bits, keep):
    shapes = _cow_shapes(bits)
    vals = _fill(shapes, COW_CASES.index((src_mode, dst_mode, bits, keep)))
    dt = {"bf16": torch.bfloat16, "uint8": torch.uint8, "int8": torch.int8}
    arenas = {k: torch.from_numpy(v).to(dt[shapes[k][1]])
              for k, v in vals.items()}
    before = _torch_digests(arenas)
    _cow_page_op(arenas, 1, 2, keep, src_mode=src_mode, dst_mode=dst_mode,
                 aug_bits=bits)
    got = _torch_digests(arenas)
    assert got == oracles[("cow", src_mode, dst_mode, bits, keep)]
    written = ("kn", "vn") if dst_mode == 0 else ("kp", "vp", "ks", "vs")
    assert all(got[k] != before[k] for k in written)


# ---------------------------------------------------------------------------
# PrefixIndex: the copied module against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_chain_hashes_and_match_equal_jax(seed):
    rng = np.random.default_rng(seed)
    entries = [rng.integers(0, 50, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 6, size=4) * PAGE]
    base = entries[0]
    for e in entries[1:]:
        e[:PAGE] = base[:PAGE]             # a shared first page
    idx = {m: m.PrefixIndex(3, PAGE) for m in (jprefix, tprefix)}
    for m, ix in idx.items():
        for step, e in enumerate(entries[:3]):
            ix.add_entry(ix.acquire_slot(None, step), 10 + step, e, step)
    for _ in range(20):
        src = entries[int(rng.integers(0, 4))]
        q = np.concatenate([src[:int(rng.integers(0, src.size + 1))],
                            rng.integers(0, 50, size=int(
                                rng.integers(0, 2 * PAGE))).astype(
                                np.int32)])
        assert jprefix.chain_hashes(q, PAGE) == tprefix.chain_hashes(q,
                                                                     PAGE)
        (je, jm_), (te, tm) = (idx[jprefix].match(q), idx[tprefix].match(q))
        assert jm_ == tm and (je is None) == (te is None)
        if je is not None:
            assert (je.slot, je.row) == (te.slot, te.row)
    assert idx[jprefix].describe() == idx[tprefix].describe()


class _StubPool:
    """What `PrefixIndex.evict_one` reads of a pool: per-entry-row page
    refcounts, `free_row` and the eviction counter."""

    def __init__(self, refcounts: dict):
        self.refcounts = refcounts            # row -> [refcount per page]
        self.allocated = np.zeros((max(refcounts) + 1, 4), bool)
        for r, c in refcounts.items():
            self.allocated[r, :len(c)] = True
        self.freed = []
        self.stats = {"prefix_evictions": 0}

    def page_refcount(self, row, lp):
        return self.refcounts[row][lp]

    def free_row(self, row):
        self.freed.append(row)
        self.allocated[row] = False


@pytest.mark.parametrize("seed", range(4))
def test_evict_one_equals_jax(seed):
    """LRU among idle entries only (every page at refcount 1), the same
    victims in the same order."""
    runs = {}
    for m in (jprefix, tprefix):
        r = np.random.default_rng(seed)
        ix = m.PrefixIndex(4, PAGE)
        refc = {}
        for step in range(4):
            n = int(r.integers(1, 4))
            ix.add_entry(ix.acquire_slot(None, step), 20 + step,
                         r.integers(0, 9, size=n * PAGE).astype(np.int32),
                         int(r.integers(0, 10)))
            # entry 0 idle, entry 1 shared, the others drawn
            idle = step == 0 or (step > 1 and r.random() < 0.6)
            refc[20 + step] = [1] * (n - 1) + [1 if idle else 2]
        pool = _StubPool(refc)
        got = [ix.evict_one(pool, 0) for _ in range(5)]
        runs[m] = (got, pool.freed, pool.stats, ix.describe())
    assert runs[jprefix] == runs[tprefix]
    assert 0 < len(runs[tprefix][1]) < 4    # some entries stay shared


# ---------------------------------------------------------------------------
# the engine: tokens and prefix counters against the JAX engine
# ---------------------------------------------------------------------------

def _prompts(seed=0):
    """`tests/test_prefix.py`'s stream: a 4-page system prompt, a tail `a`
    and `b`, which diverges from `a` at its first token."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, 100, size=(4 * PAGE,)).astype(np.int32)
    a = rng.integers(0, 100, size=(9,)).astype(np.int32)
    b = (a + 1) % 100
    return sys_p, a, b


def _scenarios() -> dict:
    sys_p, a, b = _prompts()
    c = a.copy()
    c[4:] = (c[4:] + 7) % 100
    rng = np.random.default_rng(3)
    sp2 = rng.integers(0, 100, size=(2 * PAGE,)).astype(np.int32)
    return {
        # fed == the cached run: zero prefill, no copy
        "full-hit": [np.concatenate([sys_p, a[:1]]),
                     np.concatenate([sys_p, a[1:2]])],
        # divergence on a page boundary: no copy
        "boundary": [np.concatenate([sys_p, a[:5]]),
                     np.concatenate([sys_p, b[:5]])],
        # divergence mid-page inside the entry: one copy at prefill
        "mid-page": [np.concatenate([sys_p, a]),
                     np.concatenate([sys_p, c])],
        # the prompt ends inside a shared page: one copy at decode
        "decode-write": [np.concatenate([sys_p, a]),
                         np.concatenate([sys_p, a[:4]])],
        # three requests on one 2-page system prompt
        "three": [np.concatenate([sp2, rng.integers(0, 100, size=(5,))
                                  .astype(np.int32)]) for _ in range(3)],
    }


SCENARIOS = _scenarios()
PREFIX_KEYS = ("hits", "misses", "dispatches_saved", "cow_events",
               "prefill_dispatches", "tokens_shared", "registered")


def _engine_cfg(get):
    cfg = get("qwen1.5-0.5b").reduced()
    return dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, page_size=PAGE))


@pytest.fixture(scope="module")
def dense_params():
    cfg = jax_get_arch("qwen1.5-0.5b").reduced()
    return jax_init_params(jm.abstract_params(dataclasses.replace(
        cfg, amc=dataclasses.replace(cfg.amc, weight_mode="normal"))),
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_params(dense_params):
    return from_numpy_tree(jax.tree.map(np.asarray, dense_params), CPU)


def _jax_engine(params, prompts, max_new):
    """The JAX engine, sharing on, on its reference paths: tokens, the
    smallest top-1/top-2 margin of any decode step, prefix counters."""
    from jax.sharding import AxisType
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JEngine

    class RecordingEngine(JEngine):
        min_margin = float("inf")

        def _dispatch(self, fn, batch):
            logits = super()._dispatch(fn, batch)
            if fn is self._decode:
                rows = np.asarray(batch["write_mask"])
                lg = np.asarray(logits[:, -1, :self.cfg.vocab],
                                np.float32)[rows]
                if lg.size:
                    top = np.sort(lg, axis=-1)[:, -2:]
                    self.min_margin = min(self.min_margin, float(
                        (top[:, 1] - top[:, 0]).min()))
            return logits

    cfg = _engine_cfg(jax_get_arch)
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl="dequant", matmul_impl="dense"))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    eng = RecordingEngine(cfg, mesh, params=params, max_batch=4, max_seq=96,
                          prefill_chunk=CHUNK, prefix_cache=4)
    for i, p in enumerate(prompts):
        eng.add_request(JRequest(prompt=p, max_new_tokens=max_new, id=i))
    while eng.active.any() or eng._queue:
        eng.step_all()
    st = eng.stats()["prefix"]
    return ({rid: list(map(int, v)) for rid, v in eng.outputs.items()},
            eng.min_margin, {k: st[k] for k in PREFIX_KEYS})


def _torch_engine(params, prompts, max_new, prefix_cache):
    eng = ServeEngine(_engine_cfg(get_arch), device="cpu", params=params,
                      max_batch=4, max_seq=96, prefill_chunk=CHUNK,
                      prefix_cache=prefix_cache)
    for i, p in enumerate(prompts):
        eng.add_request(Request(prompt=p, max_new_tokens=max_new, id=i))
    while eng.active.any() or eng.scheduler.queue:
        eng.step_all()
    return ({rid: list(map(int, v)) for rid, v in eng.outputs.items()},
            eng.stats()["prefix"])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_prefix_matches_jax(dense_params, torch_params, scenario):
    prompts = SCENARIOS[scenario]
    max_new = 3 if scenario == "three" else 4
    want, margin, want_st = _jax_engine(dense_params, prompts, max_new)
    assert margin > MIN_MARGIN, \
        f"prompt set sits on an argmax near-tie ({margin})"
    on, st = _torch_engine(torch_params, prompts, max_new, 4)
    off, _ = _torch_engine(torch_params, prompts, max_new, 0)
    assert on == want
    assert {k: st[k] for k in PREFIX_KEYS} == want_st
    assert on == off                    # sharing changes no token
    assert st["hits"] == len(prompts) - 1 and st["dispatches_saved"] > 0
    want_cow = {"mid-page": 1, "decode-write": 1}.get(scenario, 0)
    assert st["cow_events"] == want_cow


# ---------------------------------------------------------------------------
# sharing under augment-on-pressure, against the JAX engine: the pages a
# budget augments depend on what sharing keeps live, so the tokens of the
# sharing run need not equal those of the run without it — in the JAX
# engine as in the port
# ---------------------------------------------------------------------------

# kv int4, augment-on-pressure, a budget of 9 Normal pages: a 29-token
# system prompt (not a page multiple, so every hit copies the entry's
# boundary page on write) and 8 tails of 2-9 tokens, 4 new tokens each.
# Two prompt seeds: "compare" holds the port to the JAX engine token for
# token, so its JAX decode margins must clear PRESSURE_MARGIN (seed 31:
# >= 0.0625 in both runs); "tokens" (seed 0) is a stream on which
# sharing changes the tokens, compared only within each framework.
PRESSURE = {"sys_len": 29, "max_new": 4, "budget_pages": 9,
            "seeds": {"compare": 31, "tokens": 0}}
PRESSURE_ENGINE = {"max_batch": 4, "max_seq": 96, "prefill_chunk": CHUNK,
                   "kv_mode": "int4", "pool_mode": "augment-on-pressure"}
# on this flow the two frameworks' decode logits differ by up to 0.0156
# (int4 packing turns a one-ulp K/V difference into a whole level), so a
# JAX margin of 0.0156 does not decide a token: 4 bf16 ulps at 1.5
PRESSURE_MARGIN = 0.03


def _pressure_prompts(stream: str) -> list:
    rng = np.random.default_rng(PRESSURE["seeds"][stream])
    sys_p = rng.integers(0, 100, size=PRESSURE["sys_len"]).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(0, 100, size=int(n))
                            .astype(np.int32)])
            for n in rng.integers(2, 10, size=8)]


def _jax_pressure(params, engine: dict, streams: dict, max_new: int,
                  keys: list) -> dict:
    """The JAX engine (page 8, reference paths) on each stream, sharing on
    (4) and off (0): tokens, the smallest decode margin, the (src, dst)
    modes of every copy on write, every augmented (row, page, step),
    prefix counters. Runs by source in the child process."""
    import dataclasses
    import jax
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.serve import Request, ServeEngine
    from repro.serve import cache_pool as CP

    copies, augmented = [], []
    cow_op, augment_page = CP._cow_page_op, CP.PagedKVPool.augment_page

    def recorded_cow(*a, **kw):
        copies.append([kw["src_mode"], kw["dst_mode"]])
        return cow_op(*a, **kw)

    def recorded_augment(self, row, lp, step):
        augmented.append([int(row), int(lp), int(step)])
        return augment_page(self, row, lp, step)

    CP._cow_page_op = recorded_cow
    CP.PagedKVPool.augment_page = recorded_augment

    class RecordingEngine(ServeEngine):
        min_margin = float("inf")

        def _dispatch(self, fn, batch):
            logits = super()._dispatch(fn, batch)
            # wait for every dispatch: the engine rewrites its numpy
            # buffers right after one, and on the CPU backend an
            # in-flight prefill chunk may still read them
            jax.block_until_ready(logits)
            if fn is self._decode:
                rows = np.asarray(batch["write_mask"])
                lg = np.asarray(logits[:, -1, :self.cfg.vocab],
                                np.float32)[rows]
                if lg.size:
                    top = np.sort(lg, axis=-1)[:, -2:]
                    self.min_margin = min(self.min_margin, float(
                        (top[:, 1] - top[:, 0]).min()))
            return logits

    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, page_size=8, kv_impl="dequant", matmul_impl="dense"))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    for name, ps in streams.items():
        for pc in (4, 0):
            copies.clear()
            augmented.clear()
            eng = RecordingEngine(cfg, mesh, params=params, prefix_cache=pc,
                                  **engine)
            toks = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                         max_new_tokens=max_new, id=i)
                                 for i, p in enumerate(ps)])
            st = eng.stats()
            out[f"{name}/{pc}"] = {
                "tokens": {str(k): [int(t) for t in v]
                           for k, v in toks.items()},
                "min_margin": eng.min_margin, "copies": list(copies),
                "augmented": list(augmented),
                "prefix": {k: st["prefix"].get(k) for k in keys}}
    return out


PRESSURE_CHILD = """
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax, jax.numpy as jnp
args = json.loads(sys.argv[1])
flat = np.load(args["params"])
params = {}
for key in flat.files:
    a = flat[key]
    if a.dtype == np.uint16:
        a = a.view(jnp.bfloat16)
    node = params
    *path, leaf = key.split("/")
    for k in path:
        node = node.setdefault(k, {})
    node[leaf] = jnp.asarray(a)
%s
out = _jax_pressure(params, args["engine"], args["streams"],
                    args["max_new"], args["keys"])
with open(args["out"], "w") as f:
    json.dump(out, f)
"""


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _pressure_budget() -> int:
    from repro_torch.serve.cache_pool import PageGeometry
    cfg = get_arch("qwen1.5-0.5b").reduced()
    return PRESSURE["budget_pages"] * PageGeometry(
        cfg.n_layers, cfg.n_kv_heads, cfg.hd, PAGE, 4).page_bytes_normal


@pytest.fixture(scope="module")
def jax_pressure(dense_params, tmp_path_factory):
    """Every JAX run from one child process (the int4 pack reaches its
    Pallas call, which runs only with the TPUCompilerParams alias)."""
    tmp = tmp_path_factory.mktemp("pressure")
    np.savez(tmp / "params.npz", **{
        k: (np.asarray(v).view(np.uint16)
            if np.asarray(v).dtype.name == "bfloat16" else np.asarray(v))
        for k, v in _flatten(jax.tree.map(np.asarray, dense_params))})
    args = {"params": str(tmp / "params.npz"), "out": str(tmp / "out.json"),
            "engine": {**PRESSURE_ENGINE,
                       "pool_budget_bytes": _pressure_budget()},
            "streams": {name: [p.tolist() for p in _pressure_prompts(name)]
                        for name in PRESSURE["seeds"]},
            "max_new": PRESSURE["max_new"], "keys": list(PREFIX_KEYS)}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-c",
         PRESSURE_CHILD % inspect.getsource(_jax_pressure),
         json.dumps(args)], env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    with open(tmp / "out.json") as f:
        return json.load(f)


def _torch_pressure(params, monkeypatch, stream: str, prefix_cache: int):
    """The port on `stream`: tokens, copies, augmented pages, stats."""
    from repro_torch.serve import cache_pool as CP
    copies, augmented = [], []
    cow_op, augment_page = CP._cow_page_op, CP.PagedKVPool.augment_page

    def recorded_cow(*a, **kw):
        copies.append([kw["src_mode"], kw["dst_mode"]])
        return cow_op(*a, **kw)

    def recorded_augment(self, row, lp, step):
        augmented.append([int(row), int(lp), int(step)])
        return augment_page(self, row, lp, step)

    monkeypatch.setattr(CP, "_cow_page_op", recorded_cow)
    monkeypatch.setattr(CP.PagedKVPool, "augment_page", recorded_augment)
    eng = ServeEngine(_engine_cfg(get_arch), device="cpu", params=params,
                      prefix_cache=prefix_cache,
                      pool_budget_bytes=_pressure_budget(), **PRESSURE_ENGINE)
    out = eng.generate([Request(prompt=p, max_new_tokens=PRESSURE["max_new"],
                                id=i)
                        for i, p in enumerate(_pressure_prompts(stream))])
    monkeypatch.undo()
    return ({str(k): list(map(int, v)) for k, v in out.items()}, copies,
            augmented, eng.stats())


@pytest.mark.parametrize("prefix_cache", [4, 0])
def test_pressure_sharing_matches_jax(jax_pressure, torch_params,
                                      monkeypatch, prefix_cache):
    """Under augment-on-pressure at kv int4, with a budget at which copies
    on write land in the Augmented plane (kernel 3b's path on a card), the
    port gives the JAX engine's tokens, copies (source and destination
    modes, in order), augmented pages (row, page, step, in order) and
    prefix counters, sharing on and off. Sharing keeps the entry's pages
    live, so the budget augments other pages than without it, in both
    engines: token identity on against off is the reference's invariant
    only where no page migrates (test_engine_prefix_matches_jax)."""
    want = jax_pressure[f"compare/{prefix_cache}"]
    assert want["min_margin"] > PRESSURE_MARGIN, \
        f"prompt set sits on an argmax near-tie ({want['min_margin']})"
    toks, copies, augmented, st = _torch_pressure(
        torch_params, monkeypatch, "compare", prefix_cache)
    assert toks == want["tokens"]
    assert copies == want["copies"]
    assert augmented == want["augmented"]
    assert {k: st["prefix"].get(k) for k in PREFIX_KEYS} == want["prefix"]
    if prefix_cache:
        assert [0, 1] in copies                # Normal -> Augmented copy
        assert (st["prefix"]["hits"], st["prefix"]["misses"]) == (7, 1)
        assert augmented != jax_pressure["compare/0"]["augmented"]


def test_pressure_sharing_changes_tokens_in_both_engines(jax_pressure,
                                                         torch_params,
                                                         monkeypatch):
    """On the "tokens" stream, sharing on against off changes which pages
    the budget augments and, through their int4 rounding, the tokens of
    some requests: in the JAX engine and in the port alike, each compared
    with itself. The two runs' pool decisions are the JAX engine's in
    both, exactly (they do not depend on token values)."""
    runs = {}
    for pc in (4, 0):
        want = jax_pressure[f"tokens/{pc}"]
        toks, copies, augmented, _ = _torch_pressure(
            torch_params, monkeypatch, "tokens", pc)
        assert (copies, augmented) == (want["copies"], want["augmented"])
        runs[pc] = toks
    on, off = jax_pressure["tokens/4"], jax_pressure["tokens/0"]
    assert [0, 1] in on["copies"]
    assert on["augmented"] != off["augmented"]
    assert on["tokens"] != off["tokens"]
    assert runs[4] != runs[0]
