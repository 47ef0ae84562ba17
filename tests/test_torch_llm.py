"""The port's dense LLM serving path (configs, layers, GQA attention, the
dense model, prefill/serve steps, the serve driver) and the plain version
of its flash-attention kernel, against the JAX package on the same inputs.

Inputs come from numpy seeds; JAX parameters travel to the port through
``convert.from_jax_params``.  The JAX side runs as its own tests run it on
the CPU: its reference paths, and the Pallas kernel in interpret mode.

Tolerances: float32 configurations agree to 1e-4 (the two frameworks sum
in other orders).  bfloat16 rounds in other places in the two frameworks
(each matmul's output, the activations), so bf16 results agree to
``2^-6 · max|reference|``: two bf16 ulps at the top of the reference's
range.  The CUDA kernels run in ``test_torch_cuda.py`` on a card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.launch import steps as JS
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, PORTED, get_config, get_smoke
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention.ref import (bf16_error_bound,
                                                     flash_attention_ref)
from repro_torch.launch import serve as TSV
from repro_torch.launch import steps as TS
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, np_of  # noqa: F401
from _torch_helpers import jax_init_f32

ARCH = "qwen3-1.7b"
F32_TOL = 1e-4


def assert_bf16_close(got, want):
    g = np_of(got).astype(np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=2 ** -6 * np.abs(w).max())


def assert_close(got, want, dtype):
    if dtype == "bf16":
        assert_bf16_close(got, want)
    else:
        np.testing.assert_allclose(np_of(got), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)


def configs(dtype):
    jc = j_get_smoke(ARCH).replace(remat="none")
    tc = get_smoke(ARCH)
    if dtype == "f32":
        jc = jc.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32)
        tc = tc.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    return jc, tc


@pytest.fixture(scope="module")
def smoke_models():
    """The JAX SMOKE qwen3 in f32 and bf16, with the port's copies.  The
    JAX init draws in f32 and casts, so the bf16 weights are the f32 ones
    cast (one init serves both)."""
    out = {}
    jc32, _ = configs("f32")
    params32 = jax_init_f32(jc32)
    for dtype in ("f32", "bf16"):
        jc, tc = configs(dtype)
        params = jax.tree.map(lambda a: a.astype(jc.param_dtype), params32)
        pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
        out[dtype] = (jc, tc, params,
                      convert.from_jax_params(pnp, tc, device="cpu"))
    return out


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# -- configs ------------------------------------------------------------------------

def test_config_matches_jax_field_for_field():
    for getter_t, getter_j in ((get_config, j_get_config),
                               (get_smoke, j_get_smoke)):
        t, j = getter_t("qwen3_1_7b"), getter_j("qwen3_1_7b")
        for f in t.__dataclass_fields__:
            if f in ("param_dtype", "compute_dtype", "attn_impl"):
                continue
            assert getattr(t, f) == getattr(j, f), f
        assert t.param_dtype == t.compute_dtype == torch.bfloat16
        assert t.attn_impl == "auto"
    assert get_config("qwen3-1.7b") is get_config("qwen3_1_7b")
    assert get_config(ARCH).dh == 128


def test_registry_names_and_refusals():
    assert len(ARCH_IDS) == 10
    with pytest.raises(KeyError):
        get_config("gpt-5")
    assert PORTED == ARCH_IDS          # whisper_medium too, since step 9d
    for arch in ARCH_IDS:
        assert get_smoke(arch).name == get_config(arch).name


# -- layers -------------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32) + 7
    for rd in (None, 8):
        jc, js = JL.rope_freqs(16, 1e6, jnp.asarray(pos), rotary_dim=rd)
        tcos, tsin = TL.rope_freqs(16, 1e6, torch.from_numpy(pos),
                                   rotary_dim=rd)
        np.testing.assert_allclose(tcos.numpy(), jc, rtol=0, atol=1e-6)
        want = JL.apply_rope(jnp.asarray(x), jc, js, rotary_dim=rd)
        got = TL.apply_rope(torch.from_numpy(x), tcos, tsin, rotary_dim=rd)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    h = rng.normal(size=(3, 8)).astype(np.float32)
    g = rng.normal(size=(8,)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        jp = {"g": jnp.asarray(g), "b": jnp.asarray(b)}
        tp = {"g": torch.from_numpy(g), "b": torch.from_numpy(b)}
        np.testing.assert_allclose(
            TL.apply_norm(tp, torch.from_numpy(h), kind=kind).numpy(),
            JL.apply_norm(jp, jnp.asarray(h), kind=kind), rtol=1e-5,
            atol=1e-5)
    np.testing.assert_allclose(
        TL.rms_norm_simple(torch.from_numpy(h), torch.from_numpy(g)).numpy(),
        JL.rms_norm_simple(jnp.asarray(h), jnp.asarray(g)), rtol=1e-5,
        atol=1e-5)
    def lin(d_in, d_out):
        return {"w": rng.normal(size=(d_in, d_out)).astype(np.float32),
                "b": rng.normal(size=(d_out,)).astype(np.float32)}
    for act in ("swiglu", "gelu"):
        mlp = {"gate": lin(8, 12), "up": lin(8, 12), "down": lin(12, 8)}
        jp = convert._map(jnp.asarray, mlp)
        tp = convert._map(torch.from_numpy, mlp)
        np.testing.assert_allclose(
            TL.apply_mlp(tp, torch.from_numpy(h), act=act).numpy(),
            JL.apply_mlp(jp, jnp.asarray(h), act=act), rtol=1e-5, atol=1e-5)
    table = rng.normal(size=(11, 8)).astype(np.float32)
    ids = np.array([[1, 10, 3]], np.int32)
    np.testing.assert_array_equal(
        TL.embed({"table": torch.from_numpy(table)}, torch.from_numpy(ids),
                 scale=2.0).numpy(),
        JL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids), scale=2.0))
    np.testing.assert_allclose(
        TL.unembed({"table": torch.from_numpy(table)},
                   torch.from_numpy(h)).numpy(),
        JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(h)),
        rtol=1e-5, atol=1e-5)


# -- flash attention: the kernel's plain version ------------------------------------

FLASH_CASES = [
    dict(b=2, h=4, kv=2, sq=256, sk=256, d=64, causal=True, window=None),
    dict(b=1, h=4, kv=4, sq=512, sk=512, d=32, causal=True, window=128),
    dict(b=2, h=2, kv=1, sq=256, sk=512, d=64, causal=False, window=None),
    dict(b=1, h=8, kv=8, sq=128, sk=128, d=128, causal=True, window=None),
]


def _qkv(c, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(c["b"], c["h"], c["sq"], c["d"])).astype(dtype)
    k = rng.normal(size=(c["b"], c["kv"], c["sk"], c["d"])).astype(dtype)
    v = rng.normal(size=(c["b"], c["kv"], c["sk"], c["d"])).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_ref_matches_jax_ref_and_pallas(case):
    c = FLASH_CASES[case]
    q, k, v = _qkv(c, case)
    qo = c["sk"] - c["sq"] if (c["causal"] and c["sk"] > c["sq"]) else 0
    kw = dict(causal=c["causal"], window=c["window"], q_off=qo)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(got, j_flash_ref(jq, jk, jv, **kw),
                               rtol=3e-4, atol=3e-4)
    pallas = flash_attention_pallas(jq, jk, jv, bq=128, bk=128,
                                    interpret=True, **kw)
    np.testing.assert_allclose(got, pallas, rtol=3e-4, atol=3e-4)


def test_flash_ref_bf16_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    want = flash_attention_pallas(jq, jk, jv, causal=True, bq=128, bk=128,
                                  interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.05,
                               atol=0.05)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(j_flash_ref(jq, jk, jv, causal=True), np.float32),
        rtol=0.05, atol=0.05)


@pytest.mark.parametrize("q_off", [0, 96])
def test_flash_wrapper_model_layout(q_off):
    """[B,S,H,D] in and out, GQA, a non-square q_off case."""
    rng = np.random.default_rng(q_off)
    sq = 32 if q_off else 128
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 128, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 128, 2, 16)).astype(np.float32)
    for impl in ("auto", "ref"):
        got = t_flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                      causal=True, q_off=q_off, impl=impl)
        want = j_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                       q_off=q_off, impl="ref")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _kernel_arithmetic(q, k, v, *, skip_rescale_from=None):
    """The bf16 wgmma kernel's arithmetic in torch: 128-key tiles, scores
    scaled by scale·log2(e) into a running max in those units and p =
    2^(s - m), running max and sum in fp32, P rounded to bf16 once before
    P·V, fp32 accumulator, output rounded once.  ``skip_rescale_from``
    breaks it: tiles from that key on no longer rescale the accumulator."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    kk, vv = (x.float().repeat_interleave(g, 1) for x in (k, v))
    c = math.log2(math.e) / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * c
    s = s.masked_fill(torch.arange(k.shape[2])[None, :]
                      > torch.arange(sq)[:, None], float("-inf"))
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, k.shape[2], 128):
        st = s[..., k0:k0 + 128]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if skip_rescale_from is None or k0 < skip_rescale_from:
            acc = acc * alpha
        acc = acc + p.bfloat16().float() @ vv[..., k0:k0 + 128, :]
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def test_bf16_error_bound_holds_for_the_kernels_arithmetic():
    """The card checks' elementwise bound holds for the kernel's bf16
    arithmetic at the serve path's head width and length (unit-RMS q and
    k, as after the qk-norm), and a kernel that drops the rescale on the
    last key tile only breaks it."""
    gen = torch.Generator().manual_seed(0)

    def unit(x):
        return (x / x.pow(2).mean(-1, keepdim=True).sqrt()).bfloat16()
    q = unit(torch.randn((1, 4, 2048, 128), generator=gen))
    k = unit(torch.randn((1, 2, 2048, 128), generator=gen))
    v = torch.randn((1, 2, 2048, 128), generator=gen).bfloat16()
    want = flash_attention_ref(q, k, v, causal=True)
    bound = bf16_error_bound(q, k, v, want, causal=True)
    err = (_kernel_arithmetic(q, k, v).float() - want.float()).abs()
    assert bool((err <= bound).all())
    assert float(err.norm() / want.float().norm()) <= 2 ** -7
    bad = _kernel_arithmetic(q, k, v, skip_rescale_from=2048 - 128)
    assert not bool(((bad.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "flash_attention_wgmma"), (torch.float32,
                                                "flash_attention")])
def test_flash_route_is_chosen_by_dtype(monkeypatch, dtype, route):
    """bf16 launches the wgmma kernel and fp32 the CUDA-core kernel, by
    dtype alone; a launch that fails raises, with no second launch on the
    other kernel and no plain-version result."""
    from repro_torch.kernels import cuda_lib
    calls = []

    def failing_launch(kernel, *args):
        calls.append(kernel)
        raise RuntimeError(f"{kernel} launch failed")
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *t: None)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(cuda_lib, "launch", failing_launch)
    q = torch.zeros(1, 32, 2, 16, dtype=dtype)
    k = torch.zeros(1, 32, 1, 16, dtype=dtype)
    assert t_flash.kernel_route(dtype) == route
    with pytest.raises(RuntimeError, match=route):
        t_flash.flash_attention(q, k, k, impl="cuda")
    assert calls == [route]
    with pytest.raises(TypeError, match="bf16 or fp32"):
        t_flash.kernel_route(torch.float16)


def test_flash_dispatch_never_falls_back():
    q = torch.zeros(1, 16, 2, 16)
    k = torch.zeros(1, 16, 1, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_flash.flash_attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_flash.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="unknown kernel impl"):
        t_flash.flash_attention(q, k, k, impl="pallas")


# -- attention ----------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,valid,chunk", [
    (True, None, None, 16), (True, 8, None, 16), (False, None, None, 64),
    (True, None, 21, 32)])
def test_chunked_attention_matches_jax(causal, window, valid, chunk):
    rng = np.random.default_rng(0)
    sq = 32 if valid is None else 1
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    qpos = (np.arange(sq) if valid is None else np.array([valid - 1])
            ).astype(np.int32)
    kpos = np.arange(32, dtype=np.int32)
    kw = dict(causal=causal, window=window, chunk=chunk)
    want = JA.chunked_attention(
        *(jnp.asarray(x) for x in (q, k, v)), q_positions=jnp.asarray(qpos),
        k_positions=jnp.asarray(kpos),
        k_valid_len=None if valid is None else jnp.int32(valid), **kw)
    for impl in ("ref", "auto"):      # the plain path, and the flash route
        got = TA.chunked_attention(
            *(torch.from_numpy(x) for x in (q, k, v)),
            q_positions=torch.from_numpy(qpos),
            k_positions=torch.from_numpy(kpos),
            k_valid_len=None if valid is None else torch.tensor(valid),
            impl=impl, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gqa_attention_prefill_and_decode_match_jax(smoke_models):
    jc, tc, jparams, tparams = smoke_models["f32"]
    jp = jax.tree.map(lambda a: a[0], jparams["dense_stack"]["attn"])
    tp = tparams["dense_stack"][0]["attn"]
    x = np.random.default_rng(1).normal(size=(2, 12, jc.d_model)).astype(
        np.float32)
    j_prefill = jax.jit(lambda p, x: JA.gqa_attention(p, jc, x,
                                                      mode="prefill"))
    j_decode = jax.jit(lambda p, x, c: JA.gqa_attention(
        p, jc, x, mode="decode", cache=c,
        positions=jnp.asarray([11], jnp.int32)))
    out_j, cache_j = j_prefill(jp, jnp.asarray(x[:, :11]))
    out_t, cache_t = TA.gqa_attention(tp, tc, torch.from_numpy(x[:, :11]),
                                      mode="prefill")
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=F32_TOL,
                               atol=F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_t[key].numpy(), cache_j[key],
                                   rtol=F32_TOL, atol=F32_TOL)
    assert int(cache_t["len"]) == int(cache_j["len"]) == 11
    # decode the 12th token into a cache of capacity 16
    pad = ((0, 0), (0, 5), (0, 0), (0, 0))
    jcache = {"k": jnp.pad(cache_j["k"], pad), "v": jnp.pad(cache_j["v"], pad),
              "len": cache_j["len"]}
    tcache = {key: torch.from_numpy(np.asarray(jcache[key]))
              for key in ("k", "v")}
    tcache["len"] = torch.tensor(11, dtype=torch.int32)
    for impl in ("ref", "auto"):
        c = {key: t.clone() for key, t in tcache.items()}
        out_j, new_j = j_decode(jp, jnp.asarray(x[:, 11:]), jcache)
        out_t, new_t = TA.gqa_attention(
            tp, tc.replace(attn_impl=impl), torch.from_numpy(x[:, 11:]),
            mode="decode", cache=c, positions=torch.tensor([11]))
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(new_t["k"].numpy(), new_j["k"],
                                   rtol=F32_TOL, atol=F32_TOL)
        assert int(new_t["len"]) == 12
        assert new_t["k"] is c["k"]       # written in place


def test_not_ported_paths_raise(smoke_models):
    _, tc, _, tparams = smoke_models["f32"]
    x = torch.zeros(1, 4, tc.d_model)
    tp = tparams["dense_stack"][0]["attn"]
    # ported in step 9d: the encoder-decoder and learned positions build
    # caches; sinusoidal decoder positions (no shipped config) still raise
    enc = TM.init_cache(get_smoke("whisper-medium").replace(
        param_dtype=torch.float32, compute_dtype=torch.float32), 1, 4,
        device="cpu")
    assert enc["dec_stack"]["k"].shape == (2, 1, 4, 4, 16)
    assert enc["cross_kv"]["k"].shape == (2, 1, 30, 4, 16)
    learned = TM.init_cache(tc.replace(pos_emb="learned"), 1, 4, device="cpu")
    assert learned["dense_stack"]["k"].shape == (2, 1, 4, tc.n_kv_heads,
                                                 tc.dh)
    with pytest.raises(NotImplementedError, match="module step 9"):
        TM.init_cache(tc.replace(pos_emb="sinusoidal"), 1, 4, device="cpu")
    kv = TA.encode_cross_kv(tp, tc, x)
    assert TA.cross_attention(tp, tc, x[:, :1], kv).shape == (1, 1,
                                                               tc.d_model)
    # ported in step 9c: chunked prefill, MLA and the MTP block
    cache = TM.init_cache(tc, 1, 8, device="cpu")["dense_stack"]
    out, new = TA.gqa_attention(tp, tc, x, mode="chunked_prefill",
                                cache={key: t[0] for key, t in cache.items()},
                                cursor=0)
    assert out.shape == x.shape and int(new["len"]) == 4
    assert new["k"].shape == (1, 8, tc.n_kv_heads, tc.dh)
    step = TS.make_prefill_step(tc.replace(prefill_chunk=2))
    logits, pcache = step(tparams, torch.zeros(1, 4, dtype=torch.int32))
    assert logits.shape == (1, tc.vocab)
    assert pcache["dense_stack"]["k"].shape[2] == 4
    mla = {"q_lora_rank": 24, "kv_lora_rank": 8, "qk_nope_dim": 16,
           "qk_rope_dim": 8, "v_head_dim": 16}
    mc = tc.replace(mla=mla)
    mp = TA.init_mla(TM.make_generator(0, "cpu"), mc)
    assert mp["wuq"]["w"].shape == (24, tc.n_heads * 24)
    out, mcache = TA.mla_attention(mp, mc, x, mode="prefill")
    assert out.shape == x.shape
    assert mcache["ckv"].shape == (1, 4, 8) and mcache["kr"].shape == (1, 4, 8)
    ic = TM.init_cache(mc.replace(mtp=True), 1, 4, device="cpu")
    assert ic["dense_stack"]["ckv"].shape == (tc.n_layers, 1, 4, 8)
    mtp = TM.init(TM.make_generator(0, "cpu"), tc.replace(mtp=True))["mtp"]
    assert mtp["proj"].shape == (2 * tc.d_model, tc.d_model)
    # ported since module step 9b: a window (a ring of min(len, window)
    # slots, also on the hybrid's shared block) and the moe family
    assert TM.init_cache(tc.replace(window=4), 1, 6, device="cpu")[
        "dense_stack"]["k"].shape[2] == 4
    out, cache = TA.gqa_attention(tp, tc.replace(window=4), x, mode="prefill")
    assert out.shape == x.shape and cache["k"].shape[1] == 4
    zamba = get_smoke("zamba2-7b")
    assert TM.init_cache(zamba.replace(hybrid={**zamba.hybrid,
                                               "attn_window": 2}),
                         1, 4, device="cpu")["shared_attn"]["k"].shape[2] == 2
    moe = get_smoke("mixtral-8x22b")
    assert TM.init_cache(moe, 1, 4, device="cpu")["moe_stack"]["k"].shape[2] \
        == 4
    assert "moe" in TM.init(TM.make_generator(0, "cpu"),
                            moe.replace(family="moe"))["moe_stack"][0]
    with pytest.raises(ValueError, match="needs a cache"):
        TM.forward(tparams, tc, torch.zeros(1, 4, dtype=torch.int32),
                   mode="chunked_prefill")
    for ported in ("ssm", "hybrid", "moe"):   # ported in steps 9a and 9b
        arch = {"ssm": "mamba2-130m", "hybrid": "zamba2-7b",
                "moe": "mixtral-8x22b"}[ported]
        assert get_smoke(arch).family == ported
        assert TM.init_cache(get_smoke(arch), 1, 4, device="cpu")
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError, match="device='cuda'"):
            TM.make_generator(0)


# -- the dense model and its steps --------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["ref", "auto"])
def test_prefill_step_matches_jax(smoke_models, dtype, route):
    """Last-position logits and the cache, each attention route against its
    JAX counterpart ("reference", and "pallas", which runs the kernel's
    plain version on the CPU in both packages)."""
    jc, tc, jparams, tparams = smoke_models[dtype]
    toks = _tokens(0, 2, 64)
    j_impl = {"ref": "reference", "auto": "pallas"}[route]
    jl, jcache = jax.jit(JS.make_prefill_step(jc.replace(attn_impl=j_impl)))(
        jparams, jnp.asarray(toks))
    tl, tcache = TS.make_prefill_step(tc.replace(attn_impl=route))(
        tparams, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (2, jc.vocab)
    assert_close(tl, jl, dtype)
    got = convert.to_numpy_cache(tcache)["dense_stack"]
    want = jcache["dense_stack"]
    for key in ("k", "v"):
        assert_close(got[key], np.asarray(want[key], np.float32), dtype)
    np.testing.assert_array_equal(got["len"], want["len"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_serve_step_matches_jax(smoke_models, dtype):
    """Four decode steps from the same cache: logits and the cache."""
    jc, tc, jparams, tparams = smoke_models[dtype]
    toks = _tokens(1, 2, 12)
    jcache = JM.init_cache(jc, 2, 16)
    cache_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)
    tcache = convert.from_jax_cache(cache_np, tc, device="cpu")
    jstep = jax.jit(JS.make_serve_step(jc))
    tstep = TS.make_serve_step(tc)
    for t in range(4):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcache = tstep(tparams, tcache, torch.from_numpy(toks[:, t:t + 1]),
                           t)
        assert_close(tl, jl, dtype)
    got = convert.to_numpy_cache(tcache)["dense_stack"]
    for key in ("k", "v"):
        assert_close(got[key], np.asarray(jcache["dense_stack"][key],
                                          np.float32), dtype)
    np.testing.assert_array_equal(got["len"], [4] * jc.n_layers)


def test_serve_driver_tokens_match_jax_steps(smoke_models):
    """fp32: the driver's prefill → repack → greedy decode gives the tokens
    of the same composition of the JAX package's steps."""
    jc, tc, jparams, tparams = smoke_models["f32"]
    prompts, gen = _tokens(2, 3, 24), 6
    res = TSV.serve(tparams, tc, torch.from_numpy(prompts), gen)

    logits, cache = jax.jit(JS.make_prefill_step(jc))(jparams,
                                                      jnp.asarray(prompts))
    st = cache["dense_stack"]
    pad = ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0))
    cache = {"dense_stack": {"k": jnp.pad(st["k"], pad),
                             "v": jnp.pad(st["v"], pad), "len": st["len"]}}
    step = jax.jit(JS.make_serve_step(jc))
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    want = []
    for t in range(prompts.shape[1], prompts.shape[1] + gen):
        want.append(np.asarray(tok))
        logits, cache = step(jparams, cache, tok, jnp.int32(t))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.concatenate(want, axis=1))
    np.testing.assert_allclose(res["logits"].numpy(), logits, rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_array_equal(
        res["cache"]["dense_stack"]["len"].numpy(),
        [prompts.shape[1] + gen] * jc.n_layers)


def test_jax_pallas_route_decode_ignores_the_cache_cursor(smoke_models):
    """Reference-side caveat pinned: the JAX flash wrapper drops
    ``k_valid_len`` and the positions in decode, so its "pallas" route
    attends to cache slot 0 only; the port's kernel route decodes like the
    JAX "reference" route."""
    jc, tc, jparams, tparams = smoke_models["f32"]
    toks = _tokens(3, 2, 8)
    jcache = JM.init_cache(jc, 2, 8)
    tcache = TM.init_cache(tc, 2, 8, device="cpu")
    ref_step = jax.jit(JS.make_serve_step(jc))
    pallas_step = jax.jit(JS.make_serve_step(jc.replace(attn_impl="pallas")))
    tstep = TS.make_serve_step(tc)          # attn_impl "auto"
    jc_p = jcache
    for t in range(8):
        tok = toks[:, t:t + 1]
        want, jcache = ref_step(jparams, jcache, jnp.asarray(tok), jnp.int32(t))
        bad, jc_p = pallas_step(jparams, jc_p, jnp.asarray(tok), jnp.int32(t))
        got, tcache = tstep(tparams, tcache, torch.from_numpy(tok), t)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(np.asarray(bad) - np.asarray(want)).max() > 1e-2


def test_convert_round_trip(smoke_models):
    jc, tc, jparams, tparams = smoke_models["bf16"]
    assert len(tparams["dense_stack"]) == jc.n_layers
    assert tparams["embed"]["table"].dtype == torch.bfloat16
    assert tparams["dense_stack"][1]["attn"]["wq"]["w"].shape == (
        jc.d_model, jc.n_heads * jc.dh)           # [d_in, d_out], as in JAX
    back = convert.to_numpy_params(tparams)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, ref)
    assert TM.param_count(tparams) == sum(a.size for a in jax.tree.leaves(want))


def test_serve_driver_main_runs_on_cpu(capsys):
    assert TSV.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] batch=2 prefill(8 tok)=" in out
    assert "[serve] sample generated ids:" in out
    assert "[serve] peak device memory not measured (cpu)" in out


def test_repack_cache_keeps_the_prompt():
    cache = {"dense_stack": {"k": torch.randn(2, 1, 3, 2, 4),
                             "v": torch.randn(2, 1, 3, 2, 4),
                             "len": torch.tensor([3, 3], dtype=torch.int32)}}
    out = TSV.repack_cache(cache, 5)["dense_stack"]
    assert out["k"].shape == (2, 1, 5, 2, 4)
    assert torch.equal(out["k"][:, :, :3], cache["dense_stack"]["k"])
    assert not out["v"][:, :, 3:].any()
    assert out["len"].tolist() == [3, 3]
    with pytest.raises(ValueError):
        TSV.repack_cache(cache, 2)
