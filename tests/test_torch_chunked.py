"""Chunked (window-wise) prefill, module step 9c, against the JAX package
and against the port's own one-shot prefill.

A chunked prefill allocates the cache at capacity S and runs the prompt
through it ``prefill_chunk`` tokens at a time: every attention layer
writes the chunk's K/V (MLA: its latent) at the cursor and attends over
the cache's first ``cursor + chunk`` slots, the SSM layers carry their
conv tails and state from one window to the next.  Held here for the
four families of the JAX package's
``test_models_smoke.py::test_chunked_prefill_matches_one_shot`` (qwen3,
deepseek-v3, mamba2, zamba2) at their SMOKE sizes: the port's chunked
prefill against its one-shot prefill and against the JAX chunked prefill
(``attn_impl="reference"``); the GQA and Mamba2 blocks alone; the route
into the flash kernel (``q_off`` = the cursor, no ``k_valid_len``); the
kernel's plain version at MLA's split head dims; the refusals; the serve
driver with ``--prefill-chunk``; and two faults of the JAX reference that
hold this slice to its plain path.

Tolerances: float32 within 1e-4 (rtol and atol) of the JAX package, and of
the one-shot prefill; bfloat16 chunked against one-shot within the JAX
test's own bound, ``0.05 · max|one-shot|``.  MoE configs run at capacity
factor 32, as in the JAX test, so that no expert drops an entry in either
prefill (the two compute capacities from 8 and 32 tokens).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.launch import steps as JS
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import serve as TSV
from repro_torch.launch import steps as TS
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, warm_jax  # noqa: F401
from _torch_helpers import jax_init_f32

ARCHS = ("qwen3_1_7b", "deepseek_v3_671b", "mamba2_130m", "zamba2_7b")
F32_TOL = 1e-4
CHUNK = 8
SEQ = 32


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.array(x, np.float32)


def assert_f32_close(got, want):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def configs(arch, dtype):
    """The SMOKE configs (MoE at capacity factor 32) in ``dtype``."""
    jc = j_get_smoke(arch).replace(remat="none", attn_impl="reference")
    tc = get_smoke(arch)
    if jc.moe:
        moe = {**jc.moe, "capacity_factor": 32.0}
        jc, tc = jc.replace(moe=moe), tc.replace(moe=moe)
    if dtype == "f32":
        jc = jc.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32)
        tc = tc.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    return jc, tc


def _tokens(seed, b=2, s=SEQ, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def models():
    """``get(arch, dtype)`` → (JAX config, port config, JAX params, port
    params), made once per module from the JAX f32 init (zamba2's LoRA
    ``b`` drawn away from its zero init)."""
    made = {}

    def get(arch, dtype):
        if (arch, dtype) not in made:
            jc, tc = configs(arch, dtype)
            jc32, _ = configs(arch, "f32")
            jp = jax_init_f32(jc32)
            if "shared_lora" in jp:
                b = jp["shared_lora"]["b"]
                draw = np.random.default_rng(7).normal(size=b.shape) * 0.1
                jp = {**jp, "shared_lora": {**jp["shared_lora"],
                                            "b": jnp.asarray(draw.astype(
                                                np.float32))}}
            pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
            made[arch, dtype] = (jc, tc, jp, convert.from_jax_params(
                pnp, tc, device="cpu"))
        return made[arch, dtype]
    return get


_JAX_STEPS = {}


def _jax_prefill(jc):
    """The jitted JAX prefill step, one per config (keyed by repr: configs
    hold dicts)."""
    key = repr(jc)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(JS.make_prefill_step(jc))
    return _JAX_STEPS[key]


@pytest.fixture(scope="module")
def jax_chunked(models):
    """Every arch's JAX chunked prefill of the same tokens, compiled on
    four threads first."""
    calls = []
    for arch in ARCHS:
        jc, _, jp, _ = models(arch, "f32")
        step = _jax_prefill(jc.replace(prefill_chunk=CHUNK))
        calls.append(lambda step=step, jp=jp: step(
            jp, jnp.asarray(_tokens(0))))
    warm_jax(calls)
    return {arch: call() for arch, call in zip(ARCHS, calls)}


# -- the whole model -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_one_shot(models, arch, dtype):
    """The port's counterpart of the JAX package's
    ``test_chunked_prefill_matches_one_shot``: four windows of 8 tokens
    give the one-shot prefill's last logits and cache."""
    _, tc, _, tp = models(arch, dtype)
    toks = torch.from_numpy(_tokens(1))
    l1, c1 = TS.make_prefill_step(tc)(tp, toks)
    l2, c2 = TS.make_prefill_step(tc.replace(prefill_chunk=CHUNK))(tp, toks)
    assert sorted(c1) == sorted(c2)
    if dtype == "f32":
        assert_f32_close(l2, l1)
        for name in c1:
            for key in c1[name]:
                assert_f32_close(c2[name][key], c1[name][key])
    else:
        d = float((l1 - l2).abs().max())
        assert d / (float(l1.abs().max()) + 1e-6) < 0.05, (arch, d)
    for name in c2:
        if "len" in c2[name]:
            assert c2[name]["len"].tolist() == [SEQ] * len(c2[name]["len"])


@pytest.mark.parametrize("route", ["ref", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_jax(models, jax_chunked, arch, route):
    """The port's chunked prefill against the JAX chunked prefill
    (``attn_impl="reference"``) on the same weights and tokens, in float32:
    the last logits and every cache tensor."""
    _, tc, _, tp = models(arch, "f32")
    jl, jcache = jax_chunked[arch]
    tl, tcache = TS.make_prefill_step(tc.replace(
        prefill_chunk=CHUNK, attn_impl=route))(tp, torch.from_numpy(
            _tokens(0)))
    assert_f32_close(tl, jl)
    assert sorted(tcache) == sorted(jcache)
    for name, st in jcache.items():
        assert sorted(tcache[name]) == sorted(st)
        for key, want in st.items():
            assert_f32_close(tcache[name][key], want)


def test_chunked_attention_takes_the_kernel_at_the_cursor(models,
                                                          monkeypatch):
    """Every attention call of a chunked prefill reaches the flash wrapper
    (no ``k_valid_len``, which would keep it on the plain path) with
    ``q_off`` = the cursor, a Python int, over the cache's first ``cursor +
    chunk`` slots; MLA at its split head dims.  No layer reads the cursor
    back from the tensor ``len``."""
    calls = []
    real = t_flash.flash_attention

    def spy(q, k, v, **kw):
        calls.append((kw["q_off"], q.shape[1], k.shape[1], q.shape[-1],
                      v.shape[-1]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(t_flash, "flash_attention", spy)

    def no_item(self):
        raise AssertionError("a layer read a tensor back to the host")
    for arch, width in (("qwen3_1_7b", (16, 16)),
                        ("deepseek_v3_671b", (24, 16))):
        _, tc, _, tp = models(arch, "f32")
        calls.clear()
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "item", no_item)
            m.setattr(torch.Tensor, "__int__", no_item)
            TS.make_prefill_step(tc.replace(prefill_chunk=CHUNK))(
                tp, torch.from_numpy(_tokens(2)))
        want = [(c, CHUNK, c + CHUNK) + width
                for c in range(0, SEQ, CHUNK) for _ in range(tc.n_layers)]
        assert calls == want
        assert all(type(c[0]) is int for c in calls)


# -- the blocks ---------------------------------------------------------------------

@pytest.mark.parametrize("cursor", [0, 8])
def test_gqa_chunked_prefill_matches_jax(models, cursor):
    """qwen3's attention block: a chunk of 8 written at ``cursor`` into a
    16-slot cache that holds the JAX K/V before it."""
    jc, tc, jp, tp = models("qwen3_1_7b", "f32")
    jpa, tpa = jp["dense_stack"], tp["dense_stack"][0]["attn"]
    jpa = jax.tree.map(lambda a: a[0], jpa)["attn"]
    x = np.random.default_rng(3).normal(
        size=(2, cursor + 8, jc.d_model)).astype(np.float32)
    shape = (2, 16, jc.n_kv_heads, jc.dh)
    cache_j = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
               "len": jnp.int32(0)}
    step = jax.jit(lambda c, xx, pos: JA.gqa_attention(
        jpa, jc, xx, mode="chunked_prefill", cache=c, positions=pos))
    if cursor:
        _, cache_j = step(cache_j, jnp.asarray(x[:, :cursor]),
                          jnp.arange(cursor, dtype=jnp.int32))
    pos = np.arange(cursor, cursor + 8, dtype=np.int32)
    out_j, new_j = step(cache_j, jnp.asarray(x[:, cursor:]), jnp.asarray(pos))
    cache_t = {key: torch.from_numpy(f32(cache_j[key])) for key in ("k", "v")}
    cache_t["len"] = torch.tensor(cursor, dtype=torch.int32)
    k_buf = cache_t["k"]
    out_t, new_t = TA.gqa_attention(
        tpa, tc, torch.from_numpy(x[:, cursor:]), mode="chunked_prefill",
        cache=cache_t, positions=torch.from_numpy(pos), cursor=cursor)
    assert_f32_close(out_t, out_j)
    for key in ("k", "v"):
        assert_f32_close(new_t[key], new_j[key])
    assert int(new_t["len"]) == cursor + 8
    assert new_t["k"] is k_buf                     # written in place


def test_mamba_chunked_prefill_matches_jax(models):
    """mamba2's block over three windows (8, 8, 16 tokens), each from the
    conv tails and the state the window before left: against the JAX block
    window by window, and against one prefill of all 32 tokens."""
    jc, tc, jp, tp = models("mamba2_130m", "f32")
    jpm = jax.tree.map(lambda a: a[0], jp["mamba_stack"])["mixer"]
    tpm = tp["mamba_stack"][0]["mixer"]
    x = np.random.default_rng(4).normal(
        size=(2, SEQ, jc.d_model)).astype(np.float32) * 0.5
    block = jax.jit(lambda c, xx: JSSM.mamba2_block(
        jpm, jc, xx, mode="chunked_prefill", cache=c))
    cache_j = jax.tree.map(jnp.asarray, JSSM.init_ssm_cache(jc, 2))
    cache_t = TSSM.init_ssm_cache(tc, 2, device="cpu")
    outs = []
    for lo, hi in ((0, 8), (8, 16), (16, 32)):
        out_j, cache_j = block(cache_j, jnp.asarray(x[:, lo:hi]))
        out_t, cache_t = TSSM.mamba2_block(
            tpm, tc, torch.from_numpy(x[:, lo:hi]), mode="chunked_prefill",
            cache=cache_t)
        assert_f32_close(out_t, out_j)
        for key in ("conv_x", "conv_bc", "h"):
            assert_f32_close(cache_t[key], cache_j[key])
        outs.append(out_t)
    one, one_cache = TSSM.mamba2_block(tpm, tc, torch.from_numpy(x),
                                       mode="prefill")
    assert_f32_close(torch.cat(outs, dim=1), one)
    assert_f32_close(cache_t["h"], one_cache["h"])
    with pytest.raises(ValueError, match="needs a cache"):
        TSSM.mamba2_block(tpm, tc, torch.from_numpy(x),
                          mode="chunked_prefill")


# -- the kernel's plain version at MLA's head dims ---------------------------------

@pytest.mark.parametrize("q_off", [0, 40])
def test_flash_ref_takes_dv_other_than_dqk(q_off):
    """The plain version of the flash kernel at q/k head dim 48 and v head
    dim 32 (MLA's 192/128 at a quarter), GQA 2, causal, queries from
    ``q_off`` over more keys than queries: against the JAX plain version,
    and through the model-layout wrapper."""
    rng = np.random.default_rng(q_off)
    sq, sk = 24, 24 + q_off
    q = rng.normal(size=(2, 4, sq, 48)).astype(np.float32)
    k = rng.normal(size=(2, 2, sk, 48)).astype(np.float32)
    v = rng.normal(size=(2, 2, sk, 32)).astype(np.float32)
    kw = dict(causal=True, q_off=q_off, sm_scale=0.125)
    got = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                              **kw)
    assert got.shape == (2, 4, sq, 32)
    want = j_flash_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    lay = t_flash.flash_attention(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        impl="auto", **kw)
    assert lay.shape == (2, sq, 4, 32)
    np.testing.assert_allclose(lay.transpose(1, 2).numpy(), got.numpy(),
                               rtol=0, atol=0)


def test_flash_head_dims_name_the_instances():
    assert t_flash.head_dims(192, 128) == (192, 128)
    assert t_flash.head_dims(112, 112) == (128, 128)
    assert t_flash.head_dims(48, 48) == (64, 64)
    for bad in ((128, 64), (192, 192), (176, 128), (24, 16), (144, 144)):
        with pytest.raises(ValueError, match=rf"q/k {bad[0]}, v {bad[1]}"):
            t_flash.head_dims(*bad)


# -- the refusals and the driver -----------------------------------------------------

def test_chunked_prefill_refusals(models):
    _, tc, _, tp = models("qwen3_1_7b", "f32")
    with pytest.raises(ValueError, match="not a multiple of prefill_chunk"):
        TS.make_prefill_step(tc.replace(prefill_chunk=12))(
            tp, torch.from_numpy(_tokens(0)))
    for bad in (dict(window=16), dict(family="encdec"),
                dict(encdec={"enc_layers": 1})):
        with pytest.raises(ValueError, match="no sliding window"):
            TS.make_prefill_step(tc.replace(prefill_chunk=CHUNK, **bad))
    with pytest.raises(ValueError, match="needs a cache"):
        TM.forward(tp, tc, torch.zeros(1, 4, dtype=torch.int32),
                   mode="chunked_prefill", cursor=0)
    cache = TM.init_cache(tc, 1, 8, device="cpu")
    slot = {key: t[0] for key, t in cache["dense_stack"].items()}
    lp = tp["dense_stack"][0]["attn"]
    with pytest.raises(ValueError, match="no sliding window"):
        TA.gqa_attention(lp, tc.replace(window=4), torch.zeros(1, 4, 64),
                         mode="chunked_prefill", cache=slot, cursor=0)
    with pytest.raises(ValueError, match="Python int"):
        TA.gqa_attention(lp, tc, torch.zeros(1, 4, 64),
                         mode="chunked_prefill", cache=slot)


def test_forward_takes_the_cursor_from_the_step(models):
    """``forward`` in chunked_prefill mode takes the cursor as a Python int
    (the step's), never a tensor to read back; windows fed by hand give the
    step's cache."""
    _, tc, _, tp = models("zamba2_7b", "f32")
    toks = torch.from_numpy(_tokens(5, s=16))
    cache = TM.init_cache(tc, 2, 16, device="cpu")
    for bad in (None, torch.tensor(0)):
        with pytest.raises(ValueError, match="Python int"):
            TM.forward(tp, tc, toks[:, :8], mode="chunked_prefill",
                       cache=cache, cursor=bad)
    for lo in (0, 8):
        logits, _, cache = TM.forward(tp, tc, toks[:, lo:lo + 8],
                                      mode="chunked_prefill", cache=cache,
                                      cursor=lo)
    _, want = TS.make_prefill_step(tc.replace(prefill_chunk=8))(tp, toks)
    assert cache["shared_attn"]["len"].tolist() == [16, 16]
    for name in want:
        for key in want[name]:
            assert torch.equal(cache[name][key], want[name][key])


def test_serve_driver_with_a_prefill_chunk(models, capsys):
    """The serve driver on a chunked prefill (cache repacked from capacity
    S) makes the one-shot prefill's tokens in float32, and the command line
    takes ``--prefill-chunk``."""
    _, tc, _, tp = models("deepseek_v3_671b", "f32")
    prompts = torch.from_numpy(_tokens(6, s=16))
    one = TSV.serve(tp, tc, prompts, 4)
    chunked = TSV.serve(tp, tc.replace(prefill_chunk=CHUNK), prompts, 4)
    assert torch.equal(one["tokens"], chunked["tokens"])
    assert chunked["cache"]["moe_stack"]["ckv"].shape[2] == 20
    assert_f32_close(chunked["logits"], one["logits"])
    assert TSV.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "16", "--gen", "3",
                     "--prefill-chunk", "8"]) == 0
    assert "[serve] batch=2" in capsys.readouterr().out


# -- faults of the JAX reference that this slice is held away from -------------------

def test_jax_pallas_route_misplaces_later_chunks(models):
    """The JAX wrapper sends a call with ``k_valid_len`` to its plain
    version with ``q_off = 0`` and no valid-length mask
    (``repro/kernels/flash_attention/ops.py:38-40``), so with
    ``attn_impl="pallas"`` a chunk after the first attends as if its
    queries sat at positions 0..chunk-1: the first window's logits agree
    with the reference, a chunked prefill's do not.  The port's kernel
    route agrees with the reference (``test_chunked_prefill_matches_jax``)."""
    jc, _, jp, _ = models("qwen3_1_7b", "f32")
    toks = jnp.asarray(_tokens(0, s=16))
    ref = _jax_prefill(jc.replace(prefill_chunk=CHUNK))(jp, toks)[0]
    pallas = _jax_prefill(jc.replace(prefill_chunk=CHUNK,
                                     attn_impl="pallas"))(jp, toks)[0]
    assert float(jnp.abs(pallas - ref).max()) > 0.1 * float(
        jnp.abs(ref).max())
    first_ref = _jax_prefill(jc.replace(prefill_chunk=CHUNK))(
        jp, toks[:, :CHUNK])[0]
    first_pallas = _jax_prefill(jc.replace(prefill_chunk=CHUNK,
                                           attn_impl="pallas"))(
        jp, toks[:, :CHUNK])[0]
    np.testing.assert_allclose(first_pallas, first_ref, rtol=1e-4,
                               atol=1e-4)


def test_jax_pallas_kernel_gives_v_the_qk_head_dim():
    """``flash_attention_pallas`` gives V's block q's head dim
    (``flash_attention.py:97-99``), so at MLA's split (here 32 against 16)
    its output is 32 wide where the attention is 16 wide: MLA's prefill
    cannot run there, and the port is held to the plain path."""
    rng = np.random.default_rng(0)
    q, k = (jnp.asarray(rng.normal(size=(1, 2, 128, 32)).astype(np.float32))
            for _ in range(2))
    v = jnp.asarray(rng.normal(size=(1, 2, 128, 16)).astype(np.float32))
    out = flash_attention_pallas(q, k, v, causal=True, bq=128, bk=128,
                                 interpret=True)
    assert out.shape[-1] == 32
    assert j_flash_ref(q, k, v, causal=True).shape[-1] == 16
