"""Every arch of the JAX registry in the port: tests/test_arch_smoke.py's
forward, train-step and decode-step smokes and
`test_all_archs_have_exact_assigned_dims` over all ten, and the two dense dual archs the port serves last, minicpm-2b (MHA
36 of 64, tied head) and minitron-8b (GQA 32/8 of 128, untied head),
whose reduced engines (dual weights, int4 KV) are held to the JAX
engine's tokens.

The decode step runs each family's serving step (`make_store` +
`make_step_fns`, what `ServeEngine` dispatches) on seeded weights. The
JAX engines run in ONE child process that aliases
`pltpu.TPUCompilerParams` to `pltpu.CompilerParams` before it imports
`repro` (the int4 pool packs through a Pallas call), on their reference
routes (kv_impl="dequant", matmul_impl="dense"), waiting for every
dispatch; the port's engines run their kernel routes (plain versions on
the CPU) meanwhile. The reduced configs of the two archs differ only in
the head (tied against untied; `reduced()` takes both to 4 heads of 32).
Tokens are compared request by request up to the end or to a step where
the JAX engine's top-1/top-2 margin is at most MIN_MARGIN (the reduced
logits are coarse, so exact ties are common) and the argmaxes part there.
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

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import augment
from repro_torch.models.params import from_numpy_tree, init_params
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import state_store

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
ALL_ARCHS = sorted(JAX_ARCHS)
NEW_ARCHS = ("minicpm-2b", "minitron-8b")
MIN_MARGIN = 1e-2


def test_the_port_serves_every_jax_arch():
    assert sorted(ARCHS) == ALL_ARCHS


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_step_smoke(arch):
    """One decode step of the family's serving step at the reduced config,
    weights packed as the config says: logits (B, 1, vocab_padded),
    finite, and a state of the same structure."""
    cfg = get_arch(arch).reduced()
    dense = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    params = augment.augment_params(cfg, init_params(dense, seed=0,
                                                     device=CPU))
    B = 2
    store = state_store.make_store(cfg, max_batch=B, max_seq=32, device=CPU)
    for r in range(B):
        assert store.admit_row(r, 8, 0)
    before = jax.tree_util.tree_structure(store.state)
    step = state_store.make_step_fns(cfg)["decode"]
    batch = {**store.device_tables(),
             "tokens": torch.ones((B, 1), dtype=torch.int32),
             "positions": torch.zeros(B, dtype=torch.int32),
             "write_mask": torch.ones(B, dtype=torch.bool)}
    with torch.no_grad():
        logits, state = step(params, store.state, batch)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_padded)
    assert torch.isfinite(logits[..., :cfg.vocab].float()).all()
    assert jax.tree_util.tree_structure(state) == before


def _smoke_batch(cfg, B: int, S: int, seed: int) -> dict:
    """tokens, and frames / patches (bf16) for the audio / vlm families,
    as tests/test_arch_smoke.py:_batch_for draws them."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     dtype=torch.int32)}
    if cfg.encdec is not None:
        batch["frames"] = torch.randn(
            (B, cfg.encdec.n_frames, cfg.encdec.frame_dim),
            generator=gen).bfloat16()
    if cfg.vision is not None:
        batch["patches"] = torch.randn(
            (B, cfg.vision.n_patches, cfg.vision.vision_dim),
            generator=gen).bfloat16()
    return batch


@pytest.fixture
def one_torch_thread():
    """Reduced models: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_smoke(arch, one_torch_thread):
    """tests/test_arch_smoke.py:36: the full-sequence forward of every
    arch, logits (B, S, vocab_padded), no NaN."""
    from repro_torch.models import model as tm
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, seed=0, device=CPU)
    B, S = 2, 32
    with torch.no_grad():
        logits = tm.forward(cfg, params, _smoke_batch(cfg, B, S, 1),
                            q_chunk=16)
    assert tuple(logits.shape) == (B, S, cfg.vocab_padded)
    assert not torch.isnan(logits).any()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_smoke(arch, one_torch_thread):
    """tests/test_arch_smoke.py:47: one AdamW `make_train_step` step of a
    float32 tree on every arch: the loss finite, the params moved."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.tree import flatten, tree_map
    cfg = get_arch(arch).reduced()
    params = tree_map(lambda t: t.float(),
                      init_params(cfg, seed=0, device=CPU))
    before = [t.clone() for t in flatten(params)[0]]
    B, S = 2, 32
    batch = _smoke_batch(cfg, B, S, 1)
    batch["targets"] = torch.randint(
        0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(2),
        dtype=torch.int32)
    state = step_lib.TrainState(params, adamw.adamw_init(params),
                                torch.zeros((), dtype=torch.int32))
    step = step_lib.make_train_step(
        cfg, step_lib.TrainSettings(lr=1e-3, q_chunk=16))
    new, loss = step(state, batch)
    assert np.isfinite(float(loss)), loss
    moved = max(float((a - b).abs().max())
                for a, b in zip(flatten(new.params)[0], before))
    assert moved > 0


def test_all_archs_have_exact_assigned_dims():
    """The configs carry the exact assigned numbers (tests/
    test_arch_smoke.py's table), and every field the port reads equals
    the JAX config's."""
    spec = {
        "qwen3-moe-30b-a3b": (48, 2048, 32, 4, 768, 151936),
        "grok-1-314b": (64, 6144, 48, 8, 32768, 131072),
        "whisper-tiny": (4, 384, 6, 6, 1536, 51865),
        "minitron-8b": (32, 4096, 32, 8, 16384, 256000),
        "granite-3-2b": (40, 2048, 32, 8, 8192, 49155),
        "qwen1.5-0.5b": (24, 1024, 16, 16, 2816, 151936),
        "minicpm-2b": (40, 2304, 36, 36, 5760, 122753),
        "llama-3.2-vision-11b": (40, 4096, 32, 8, 14336, 128256),
        "mamba2-130m": (24, 768, 0, 0, 0, 50280),
        "recurrentgemma-9b": (38, 4096, 16, 1, 12288, 256000),
    }
    assert sorted(spec) == ALL_ARCHS
    for name, (L, d, H, KV, ff, V) in spec.items():
        c = get_arch(name)
        assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
                c.vocab) == (L, d, H, KV, ff, V), name
        j = jax_get_arch(name)
        for full in (True, False):
            t, jj = (c, j) if full else (c.reduced(), j.reduced())
            for f in ("name", "family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab", "hd", "vocab_padded",
                      "qkv_bias", "rope_theta", "norm_eps",
                      "tie_embeddings", "act", "source"):
                assert getattr(t, f) == getattr(jj, f), (name, full, f)
            for f in ("weight_mode", "kv_mode", "aug_bits",
                      "resolved_pool_mode", "num_arrays", "placement"):
                assert getattr(t.amc, f) == getattr(jj.amc, f), (name, f)
    assert ARCHS["mamba2-130m"].ssm.state_dim == 128
    assert ARCHS["qwen3-moe-30b-a3b"].moe.n_experts == 128
    assert ARCHS["qwen3-moe-30b-a3b"].moe.top_k == 8
    assert ARCHS["grok-1-314b"].moe.n_experts == 8
    assert ARCHS["grok-1-314b"].moe.top_k == 2
    assert ARCHS["qwen1.5-0.5b"].qkv_bias
    assert ARCHS["minicpm-2b"].vocab_padded == 122880
    assert ARCHS["minicpm-2b"].tie_embeddings
    assert not ARCHS["minitron-8b"].tie_embeddings
    assert ARCHS["minitron-8b"].hd == 128 and ARCHS["minicpm-2b"].hd == 64
    for name in NEW_ARCHS:
        assert ARCHS[name].amc.weight_mode == "dual"
        assert ARCHS[name].amc.kv_mode == "int4"


def test_new_archs_pack_their_dual_pairs():
    """At the reduced widths: wk/wv and w_gate/w_up paired into one int4
    buffer each, wq / wo / w_down (and an untied head) left bf16."""
    for name in NEW_ARCHS:
        cfg = get_arch(name).reduced()
        dense = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, weight_mode="normal"))
        p = augment.augment_params(cfg, init_params(dense, seed=0,
                                                    device=CPU))
        attn, mlp = p["layers"]["attn"], p["layers"]["mlp"]
        assert attn["wkv_buf"].dtype == torch.uint8
        assert mlp["w_gate_up_buf"].dtype == torch.uint8
        for k in ("wq", "wo"):
            assert attn[k].dtype == torch.bfloat16
        assert mlp["w_down"].dtype == torch.bfloat16
        assert ("head" in p) == (not cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# the reduced engines against the JAX engine's tokens
# ---------------------------------------------------------------------------

def _streams() -> dict:
    """name -> (arch, engine kwargs, prompt lengths, max_new, seed)."""
    out = {}
    for arch in NEW_ARCHS:
        out[f"tokens/{arch}"] = (arch, {"max_batch": 2, "max_seq": 64,
                                        "prefill_chunk": 8},
                                 [20, 14, 9, 25, 5], 6, 4)
        out[f"spec3/{arch}"] = (arch, {"max_batch": 2, "max_seq": 64,
                                       "prefill_chunk": 8, "spec_k": 3},
                                [20, 14, 9, 25, 5], 6, 4)
    return out


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=n).astype(np.int32).tolist()
            for n in lens]


def _jax_runs(params: dict, streams: dict) -> dict:
    """Every stream through the JAX engine, with each emitted token's
    decode margin (request id -> output index -> margin). Runs by source
    in the child process."""
    import dataclasses
    import jax
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.serve import Request, ServeEngine

    class Recording(ServeEngine):
        def _dispatch(self, fn, batch):
            logits = super()._dispatch(fn, batch)
            jax.block_until_ready(logits)
            if fn is self._decode:
                lg = np.asarray(logits[:, -1, :self.cfg.vocab], np.float32)
                top = np.sort(lg, axis=-1)[:, -2:]
                for row in np.flatnonzero(np.asarray(batch["write_mask"])):
                    rid = self.slot_req[row].id
                    at = len(self.outputs.get(rid, []))
                    self.margins.setdefault(str(rid), {})[str(at)] = \
                        float(top[row, 1] - top[row, 0])
            return logits

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    for name, (arch, kw, lens, max_new, seed) in streams.items():
        if "spec_k" in kw:
            continue              # the port's own invariant (stepwise)
        cfg = get_arch(arch).reduced()
        cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, kv_impl="dequant", matmul_impl="dense"))
        eng = Recording(cfg, mesh, params=params[arch], **kw)
        eng.margins = {}
        toks = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                     max_new_tokens=max_new, id=i)
                             for i, p in enumerate(_prompts(lens, seed))])
        out[name] = {"tokens": {str(k): [int(t) for t in v]
                                for k, v in toks.items()},
                     "margins": eng.margins}
    return out


CHILD = """
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax, jax.numpy as jnp
args = json.loads(sys.argv[1])
params = {}
for arch, path in args["params"].items():
    flat = np.load(path)
    tree = params.setdefault(arch, {})
    for key in flat.files:
        a = flat[key]
        if a.dtype == np.uint16:
            a = a.view(jnp.bfloat16)
        node = tree
        *parts, leaf = key.split("/")
        for k in parts:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a)
%s
out = _jax_runs(params, args["streams"])
with open(args["out"], "w") as f:
    json.dump(out, f)
"""


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def dense_params():
    """Each new arch's dense weights from the JAX initialiser at seed 0."""
    out = {}
    for arch in NEW_ARCHS:
        c = jax_get_arch(arch).reduced()
        c = dataclasses.replace(c, amc=dataclasses.replace(
            c.amc, weight_mode="normal"))
        out[arch] = jax.tree.map(np.asarray, jax.jit(
            lambda k, c=c: jax_init_params(jm.abstract_params(c), k))(
            jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def oracle_child(dense_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("archs")
    paths = {}
    for arch, tree in dense_params.items():
        paths[arch] = str(tmp / f"{arch}.npz")
        np.savez(paths[arch], **{
            k: (v.view(np.uint16) if v.dtype.name == "bfloat16" else v)
            for k, v in _flatten(tree)})
    args = {"params": paths, "streams": _streams(),
            "out": str(tmp / "out.json")}
    src = inspect.getsource(_prompts) + "\n\n" + inspect.getsource(_jax_runs)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD % src, json.dumps(args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield child, args
    if child.poll() is None:
        child.kill()
        child.wait()


@pytest.fixture(scope="module")
def port_runs(oracle_child, dense_params):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for name, (arch, kw, lens, max_new, seed) in _streams().items():
        eng = ServeEngine(get_arch(arch).reduced(), device="cpu",
                          params=from_numpy_tree(dense_params[arch], CPU),
                          **kw)
        toks = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                     max_new_tokens=max_new, id=i)
                             for i, p in enumerate(_prompts(lens, seed))])
        out[name] = {"tokens": {str(k): list(map(int, v))
                                for k, v in toks.items()},
                     "spec": eng.stats()["spec"]}
    torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def oracles(oracle_child, port_runs):
    child, args = oracle_child
    log, _ = child.communicate(timeout=600)
    assert child.returncode == 0, log[-4000:]
    with open(args["out"]) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_tokens_match_jax(oracles, port_runs, arch):
    """Five requests on two rows (queueing, row reuse, chunked prefill),
    dual weights, int4 KV: the port's tokens equal the JAX engine's,
    request by request, up to the end or to a JAX near-tie where the two
    argmaxes part; at least three quarters of the tokens compared."""
    want = oracles[f"tokens/{arch}"]
    got = port_runs[f"tokens/{arch}"]["tokens"]
    assert sorted(got) == sorted(want["tokens"])
    compared = total = 0
    for rid, ref in want["tokens"].items():
        total += len(ref)
        for i, (a, b) in enumerate(zip(got[rid], ref)):
            if a != b:
                m = want["margins"][rid][str(i)]
                assert m <= MIN_MARGIN, (arch, rid, i, m)
                break
            compared += 1
    assert compared * 4 >= total * 3, (compared, total)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_spec_decode_equals_stepwise(port_runs, arch):
    """spec_k=3 (dequant draft, window verify through kernel 5's plain
    version, masked commit) emits the stepwise tokens on every request."""
    step, spec = port_runs[f"tokens/{arch}"], port_runs[f"spec3/{arch}"]
    assert spec["tokens"] == step["tokens"]
    st = spec["spec"]
    assert st["enabled"] and st["verify_dispatches"] > 0
