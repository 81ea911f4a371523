"""The paged KV write (`ops.paged_kv_write`: one layer's K and V rows, the
page lookup, the write and commit masks, the pack and the stores into the
arena views) against the JAX package's `_paged_scatter`
(`repro/models/transformer.py`) on the same pools and rows, made from a
seed with numpy, at the reduced qwen1.5-0.5b and granite-3-2b widths.

On the CPU `ops.paged_kv_write` runs `paged_kv_write_plain`; the CUDA
kernel is held against that plain version on the card
(tests/test_torch_gpu.py). The raw bytes of every arena page >= 1 must be
equal (kn vn kp vp ks vs); page 0, the write-dump page, takes the
masked-off rows, and two of them landing on one dump slot leave it
unspecified.

int8 runs in this process: JAX's int8 pack is jnp. JAX's int4 pack
reaches only its Pallas call (`repro/kernels/ops.py:quantize_pack_kv`),
which this jax runs in interpret mode only with `pltpu.TPUCompilerParams`
aliased to `pltpu.CompilerParams`; that alias is set in a CHILD process
before it imports `repro` (as tests/test_torch_serve.py does), never here.
"""
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import quantize_pack_kv as qpk
from repro_torch.models.params import from_numpy_tree

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
ARENAS = ("kn", "vn", "kp", "vp", "ks", "vs")
ARCHS = ("qwen1.5-0.5b", "granite-3-2b")
POLICIES = ("always-augmented", "normal-only", "augment-on-pressure")
# (T, commit): a decode token, a prefill chunk, and a verify window with
# no commit mask (the verify scatter), all accepted and partly accepted
# (the commit pass)
SHAPES = ((1, "none"), (32, "none"), (4, "none"), (4, "all"), (4, "mixed"))
B, MAXP = 4, 4


def _cases():
    out = []
    for arch in ARCHS:
        for policy in POLICIES:
            for bits in (4, 8):
                for T, commit in SHAPES:
                    out.append((arch, policy, bits, T, commit))
    return out


CASES = _cases()


def case_key(case) -> str:
    arch, policy, bits, T, commit = case
    return f"{arch}-{policy}-int{bits}-T{T}-{commit}"


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))


def make_case(case) -> dict:
    """Arena views of one layer (random contents, both planes sized as the
    pool sizes them for the policy), a page table of distinct physical
    pages in the plane each page's mode picks (mixed modes under
    augment-on-pressure), and K/V rows with half-step ties and zero rows.
    Row 1 is write-masked; row 2 sits past the table (a stale position,
    write-masked, clamped by the lookup); row 3 loses its last token to
    the write mask."""
    from repro_torch.configs import get_arch
    arch, policy, bits, T, commit = case
    cfg = get_arch(arch).reduced()
    KV, hd, page = cfg.n_kv_heads, cfg.hd, cfg.amc.page_size
    rng = np.random.default_rng(CASES.index(case))
    Nn = 1 + (0 if policy == "always-augmented" else B * MAXP)
    Np = 1 + (0 if policy == "normal-only" else B * MAXP)
    d_store = hd // 2 if bits == 4 else hd
    c = {"kn": _bf16(rng.standard_normal((Nn, KV, page, hd))),
         "vn": _bf16(rng.standard_normal((Nn, KV, page, hd)))}
    for k in ("kp", "vp"):
        c[k] = (rng.integers(0, 256, (Np, KV, page, d_store)).astype(np.uint8)
                if bits == 4 else
                rng.integers(-127, 128, (Np, KV, page, d_store)
                             ).astype(np.int8))
    c["ks"] = _bf16(rng.random((Np, KV, page)) * 0.1)
    c["vs"] = _bf16(rng.random((Np, KV, page)) * 0.1)
    if policy == "augment-on-pressure":
        modes = rng.integers(0, 2, (B, MAXP))
        modes[0, :2] = [0, 1]                  # both planes in row 0
    else:
        modes = np.full((B, MAXP), int(policy == "always-augmented"))
    free = {0: list(rng.permutation(Nn - 1) + 1),
            1: list(rng.permutation(Np - 1) + 1)}
    c["modes"] = modes.astype(np.int32)
    c["table"] = np.array([[free[m].pop() for m in r] for r in modes],
                          np.int32)
    scale = rng.random((B, T, KV, 1)) * 8
    for k in ("k", "v"):
        x = rng.standard_normal((B, T, KV, hd)) * scale
        x[:, :, 0] = np.round(x[:, :, 0] * 2) / 2          # exact half steps
        x[0, 0, 1] = 0.0                                     # amax == 0
        c[k] = _bf16(x)
    starts = rng.integers(0, MAXP * page - T + 1, B)
    starts[2] = MAXP * page + 3                              # past the table
    c["pos"] = (starts[:, None] + np.arange(T)[None, :]).astype(np.int32)
    write = np.ones((B, T), bool)
    write[1] = False
    write[2] = False
    write[3, -1] = False
    c["write"] = write
    if commit == "all":
        c["commit"] = np.ones((B, T), bool)
    elif commit == "mixed":
        acc = rng.integers(1, T + 1, B)
        acc[0] = 2
        c["commit"] = np.arange(T)[None, :] < acc[:, None]
    return c


def _jax_scatter(arch, kv_mode, policy, c):
    """The JAX package's scatter of one case: the six arenas as numpy.
    Runs both here (int8) and, by source, in the int4 child process."""
    import dataclasses
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch
    from repro.models import transformer as jt
    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode=kv_mode, pool_mode=policy))
    names = ("kn", "vn", "kp", "vp", "ks", "vs")
    meta = {"page_table": jnp.asarray(c["table"]),
            "page_modes": jnp.asarray(c["modes"])}
    commit = c.get("commit")
    out = jt._paged_scatter(
        cfg, {k: jnp.asarray(c[k]) for k in names}, jnp.asarray(c["k"]),
        jnp.asarray(c["v"]), jnp.asarray(c["pos"]), meta,
        jnp.asarray(c["write"]),
        None if commit is None else jnp.asarray(commit))
    return {k: np.asarray(out[k]) for k in names}


CHILD = """
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax.numpy as jnp
BF16 = ("kn", "vn", "ks", "vs", "k", "v")
args = json.loads(sys.argv[1])
flat = np.load(args["cases"])
%s
out = {}
for spec in args["specs"]:
    key = spec["key"]
    c = {}
    for name in flat.files:
        if name.startswith(key + "/"):
            a = flat[name]
            leaf = name[len(key) + 1:]
            c[leaf] = a.view(jnp.bfloat16) if leaf in BF16 else a
    res = _jax_scatter(spec["arch"], "int4", spec["policy"], c)
    for k, a in res.items():
        out[key + "/" + k] = a.view(np.uint16) if str(a.dtype) == "bfloat16" \\
            else a
np.savez(args["out"], **out)
"""


def _bits(a: np.ndarray) -> np.ndarray:
    """Raw bytes of an arena (bf16 as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


@pytest.fixture(scope="module")
def int4_oracle(tmp_path_factory):
    """JAX's arenas after the scatter for every int4 case, from one child
    process."""
    tmp = tmp_path_factory.mktemp("paged_write")
    specs, flat = [], {}
    for case in CASES:
        if case[2] != 4:
            continue
        key = case_key(case)
        specs.append({"key": key, "arch": case[0], "policy": case[1]})
        for name, a in make_case(case).items():
            flat[f"{key}/{name}"] = _bits(a)
    np.savez(tmp / "cases.npz", **flat)
    args = {"cases": str(tmp / "cases.npz"), "out": str(tmp / "out.npz"),
            "specs": specs}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-c", CHILD % inspect.getsource(_jax_scatter),
         json.dumps(args)], env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    out = np.load(tmp / "out.npz")
    return {name: out[name] for name in out.files}


def torch_write(case, c) -> dict:
    """`ops.paged_kv_write` on CPU tensors of the case: the six arenas
    after it, as numpy."""
    arch, policy, bits, T, commit = case
    t = {k: from_numpy_tree(np.asarray(v), CPU) for k, v in c.items()}
    # the engine hands decode steps int32 positions and windows / chunks
    # int64 (starts + arange)
    pos = t["pos"] if T == 1 else t["pos"].long()
    ops.paged_kv_write(*(t[k] for k in ARENAS), t["k"], t["v"], pos,
                       t["write"], t.get("commit"), t["table"], t["modes"],
                       page_size=t["kn"].shape[2], policy=policy,
                       aug_bits=bits)
    return {k: (t[k].view(torch.int16).numpy().view(np.uint16)
                if t[k].dtype == torch.bfloat16 else t[k].numpy())
            for k in ARENAS}


def assert_pages_equal(got: dict, want: dict, before: dict, case) -> None:
    """Every arena page >= 1 byte-identical; and the write is not vacuous:
    some page >= 1 of a plane the policy writes changed."""
    changed = 0
    for k in ARENAS:
        g, w = got[k][1:], _bits(want[k])[1:]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        diff = np.argwhere(g != w)
        assert diff.size == 0, (case, k, diff[:5].tolist())
        changed += int((g != _bits(before[k])[1:]).sum())
    assert changed > 0, case


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == 8],
                         ids=case_key)
def test_paged_write_int8_matches_jax_scatter(case):
    c = make_case(case)
    want = _jax_scatter(case[0], "int8", case[1], c)
    assert_pages_equal(torch_write(case, c), want, c, case)


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == 4],
                         ids=case_key)
def test_paged_write_int4_matches_jax_scatter(case, int4_oracle):
    c = make_case(case)
    key = case_key(case)
    want = {k: int4_oracle[f"{key}/{k}"] for k in ARENAS}
    assert_pages_equal(torch_write(case, c), want, c, case)


def test_rejected_and_masked_rows_land_as_the_contract_says():
    """A commit == False token with write == True leaves zero bytes and a
    scale of exactly 1.0 at its slot (Augmented page) or a zero bf16 row
    (Normal page); a write == False token changes no page >= 1."""
    case = ("granite-3-2b", "augment-on-pressure", 4, 4, "mixed")
    c = make_case(case)
    got = torch_write(case, c)
    page = 16
    seen = set()
    for b in range(B):
        for t in range(4):
            if not c["write"][b, t] or c["commit"][b, t]:
                continue
            lp, slot = divmod(int(c["pos"][b, t]), page)
            phys, mode = int(c["table"][b, lp]), int(c["modes"][b, lp])
            seen.add(mode)
            if mode == 1:
                assert not got["kp"][phys, :, slot].any()
                assert not got["vp"][phys, :, slot].any()
                assert (got["ks"][phys, :, slot] == 0x3F80).all()  # 1.0
                assert (got["vs"][phys, :, slot] == 0x3F80).all()
            else:
                assert not got["kn"][phys, :, slot].any()
                assert not got["vn"][phys, :, slot].any()
    assert seen, "the case must reject a written token"
    # row 1 is write-masked: its pages keep their bytes
    for k, plane in (("kn", 0), ("kp", 1)):
        for lp in range(MAXP):
            if c["modes"][1, lp] == plane:
                phys = int(c["table"][1, lp])
                assert np.array_equal(got[k][phys], _bits(c[k])[phys])


# ---------------------------------------------------------------------------
# what the wrapper hands the kernel library
# ---------------------------------------------------------------------------

class _RecordingLibrary:
    """Stands in for the kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _tensors(case, k_view=None):
    c = make_case(case)
    t = {k: from_numpy_tree(np.asarray(v), CPU) for k, v in c.items()}
    if k_view is not None:
        t["k"] = k_view(t["k"])
    return t


@pytest.mark.parametrize("policy,planes", [("always-augmented", 2),
                                           ("normal-only", 1),
                                           ("augment-on-pressure", 3)])
@pytest.mark.parametrize("bits", [4, 8])
def test_paged_write_plan_hands_shapes_strides_policy_and_bits(
        policy, planes, bits, monkeypatch):
    """The wrapper passes the arena views and rows in place (rows by
    stride: a head-strided view of k_new is not copied), the shapes, the
    pool's table width, the position width, the policy's planes and the
    pack's bits; it allocates nothing."""
    fake = _RecordingLibrary()
    monkeypatch.setattr(qpk, "library", lambda: fake)
    monkeypatch.setattr(qpk.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    case = ("qwen1.5-0.5b", policy, bits, 4, "mixed")
    # K laid out (B, KV, T, hd) and seen as (B, T, KV, hd): strided rows
    t = _tensors(case, lambda k: k.transpose(1, 2).contiguous()
                 .transpose(1, 2))
    k, v = t["k"], t["v"]
    assert not k.is_contiguous() and k.stride(-1) == 1
    for pos in (t["pos"], t["pos"].long()):
        assert qpk._write_launch(
            *(t[n] for n in ARENAS), k, v, pos, t["write"], t["commit"],
            t["table"], t["modes"], 16, policy, bits)
        name, args = fake.calls.pop()
        assert name == "paged_kv_write"
        ptrs, ints, stream = args[:13], args[13:-1], args[-1]
        assert ptrs == (k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                        t["write"].data_ptr(), t["commit"].data_ptr(),
                        t["table"].data_ptr(), t["modes"].data_ptr(),
                        *(t[n].data_ptr() for n in ARENAS))
        B_, T_, KV, D = k.shape
        assert ints == (B_, T_, KV, D, 16, MAXP, *k.stride()[:3],
                        *v.stride()[:3], int(pos.dtype == torch.int64),
                        planes, bits)
        assert stream == 7
    assert qpk._write_launch(*(t[n] for n in ARENAS), k, v, t["pos"],
                             t["write"], None, t["table"], t["modes"], 16,
                             policy, bits)
    assert fake.calls.pop()[1][4] is None              # no commit mask
    # a row whose elements are strided is copied, contiguously
    ks = torch.stack([k, k], dim=-1)[..., 0]
    assert ks.stride(-1) == 2
    qpk._write_launch(*(t[n] for n in ARENAS), ks, v, t["pos"], t["write"],
                      None, t["table"], t["modes"], 16, policy, bits)
    args = fake.calls.pop()[1]
    assert args[0] != ks.data_ptr() and args[19:22] == (
        k.shape[1] * k.shape[2] * k.shape[3], k.shape[2] * k.shape[3],
        k.shape[3])


def test_paged_write_wrapper_refuses_what_the_kernel_does_not_take(
        monkeypatch):
    fake = _RecordingLibrary()
    monkeypatch.setattr(qpk, "library", lambda: fake)
    monkeypatch.setattr(qpk.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    t = _tensors(("granite-3-2b", "augment-on-pressure", 4, 4, "all"))
    arenas = [t[n] for n in ARENAS]

    def call(**kw):
        a = {"arenas": arenas, "k": t["k"], "v": t["v"], "pos": t["pos"],
             "write": t["write"], "commit": t["commit"],
             "table": t["table"], "modes": t["modes"], "bits": 4, **kw}
        qpk._write_launch(*a["arenas"], a["k"], a["v"], a["pos"],
                          a["write"], a["commit"], a["table"], a["modes"],
                          16, "augment-on-pressure", a["bits"])

    with pytest.raises(ValueError, match="aug_bits"):
        call(bits=6)
    with pytest.raises(ValueError, match="bf16"):
        call(k=t["k"].float())
    with pytest.raises(ValueError, match="kp"):
        call(bits=8)                          # uint8 arenas, int8 pack
    with pytest.raises(ValueError, match="contiguous"):
        strided = list(arenas)
        strided[0] = torch.cat([arenas[0], arenas[0]], dim=-1)[..., ::2]
        call(arenas=strided)
    with pytest.raises(ValueError, match="pos"):
        call(pos=t["pos"].float())
    with pytest.raises(ValueError, match="commit"):
        call(commit=t["commit"].int())
    with pytest.raises(ValueError, match="page_modes"):
        call(modes=t["modes"].long())
    with pytest.raises(ValueError, match="even"):
        call(k=t["k"][..., :31], v=t["v"][..., :31])
    assert fake.calls == []
    with pytest.raises(ValueError, match="CUDA"):
        qpk.paged_kv_write_cuda(*arenas, t["k"], t["v"], t["pos"],
                                t["write"], None, t["table"], t["modes"],
                                page_size=16, policy="always-augmented",
                                aug_bits=4)
    assert qpk.paged_kv_write_cuda.launches == 0
