"""The encoder-decoder family of module step 9d (whisper-medium) against the
JAX package at its SMOKE size (2 encoder and 2 decoder layers, d_model 64,
4 heads of 16, 30 frames).

Covered: the registry entry field for field, ``sinusoidal_positions``,
``encode_cross_kv`` and ``cross_attention`` (a prefill's queries and one
decode query), one encoder layer (bidirectional) and one decoder layer
with the encoder's cross K/V, ``forward`` in train mode, the prefill step
(last-position logits and the whole cache, ``cross_kv`` included), decode
steps from a carried-across cache, ``init_cache``, a round trip of the
parameters and caches through ``repro_torch.convert``, ``repack_cache``
leaving ``cross_kv`` as it is, and the serve driver (its tokens against
the same composition of the JAX package's steps, and its command line).
Parameters come from the JAX package's own init, carried across by
``convert.from_jax_params``; tokens and frame embeddings from numpy seeds.

Each module runs on the port's ``ref`` and ``auto`` attention routes (on the
CPU both are plain; ``auto`` is the flash kernel's plain version), against
the JAX package's ``"reference"`` and ``"pallas"`` routes in train and
prefill.  Decode is held against ``"reference"`` only: the JAX flash
wrapper drops the self-attention cache's ``k_valid_len``.  The JAX Pallas
kernel itself cannot take whisper's 1500 frames
(``test_jax_pallas_kernel_refuses_1500_frames``).

Tolerances: float32 within 1e-4; bfloat16 within ``2^-6 · max|reference|``,
as ``tests/test_torch_families.py`` states them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.configs import shapes_for as j_shapes_for
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.launch import steps as JS
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import PORTED, get_config, get_smoke, shapes_for
from repro_torch.launch import serve as TSV
from repro_torch.launch import steps as TS
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, warm_jax  # noqa: F401
from _torch_helpers import jax_init_f32

ARCH = "whisper-medium"
DTYPES = ["f32", "bf16"]
ROUTES = ["ref", "auto"]
J_ROUTE = {"ref": "reference", "auto": "pallas"}
F32_TOL = 1e-4
B, S = 2, 128           # train and prefill: two query chunks of attn_chunk 64
P, GEN = 12, 4          # decode: a prefill of P tokens, then GEN steps


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, dtype):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if dtype == "bf16":
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2 ** -6 * np.abs(w).max())
    else:
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def configs(dtype, route="ref"):
    jc = j_get_smoke(ARCH).replace(remat="none", attn_impl=J_ROUTE[route])
    tc = get_smoke(ARCH).replace(attn_impl=route)
    if dtype == "f32":
        jc = jc.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32)
        tc = tc.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_params(dtype):
    """The JAX init at f32; bf16 is the same arrays cast, as the JAX init
    draws in f32 and casts each leaf."""
    if dtype == "bf16":
        return jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                            _jax_params("f32"))
    jc, _ = configs("f32")
    return jax_init_f32(jc)


@functools.lru_cache(maxsize=None)
def _port_params(dtype):
    _, tc = configs(dtype)
    pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), _jax_params(dtype))
    return convert.from_jax_params(pnp, tc, device="cpu")


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _frames(seed, b=B):
    cfg = get_smoke(ARCH)
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encdec["enc_frames"], cfg.d_model)).astype(np.float32)


def _x(seed, s, dtype):
    """A seeded decoder or encoder state [B, s, d_model] in ``dtype``."""
    d = get_smoke(ARCH).d_model
    x = np.random.default_rng(seed).normal(size=(B, s, d)).astype(np.float32)
    return x if dtype == "f32" else f32(jnp.asarray(x).astype(jnp.bfloat16))


def _as(dtype, x):
    """numpy → a JAX and a port array in ``dtype`` (the same values)."""
    j = jnp.asarray(x).astype(jnp.float32 if dtype == "f32" else jnp.bfloat16)
    t = torch.from_numpy(np.asarray(x)).to(
        torch.float32 if dtype == "f32" else torch.bfloat16)
    return j, t


def _layer(params, stack, i):
    return jax.tree.map(lambda a: a[i], params[stack])


@functools.lru_cache(maxsize=None)
def _jax_fn(kind, dtype, route="ref"):
    """The JAX package's compiled ``kind`` for one dtype and route, made
    once, so that the warm-up and the tests call the same function."""
    jc, _ = configs(dtype, route)
    if kind == "train":
        return jax.jit(lambda p, t, e: JM.forward(p, jc, t, mode="train",
                                                  enc_inputs=e)[0])
    if kind == "prefill":
        return jax.jit(JS.make_prefill_step(jc))
    if kind == "serve":
        return jax.jit(JS.make_serve_step(jc))
    if kind == "cross":
        def cross(pc, xq, xd, e):
            kv = JA.encode_cross_kv(pc, jc, e)
            return (kv, JA.cross_attention(pc, jc, xq, kv),
                    JA.cross_attention(pc, jc, xd, kv))
        return jax.jit(cross)
    if kind == "enc_layer":
        return jax.jit(lambda lp, x: JM.apply_decoder_layer(
            lp, jc, x, mode="train", cache=None,
            positions=jnp.arange(x.shape[1], dtype=jnp.int32),
            use_moe=False, causal=False)[0])
    assert kind == "dec_layer"
    return jax.jit(lambda lp, x, kv: JM.apply_decoder_layer(
        lp, jc, x, mode="prefill", cache=None,
        positions=jnp.arange(x.shape[1], dtype=jnp.int32), use_moe=False,
        enc_kv=kv)[:2])


def _pad_jax_cache(jcache, extra):
    """The decoder's self-attention stack padded by ``extra`` slots; the
    cross K/V stay as they are."""
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    st = jcache["dec_stack"]
    return {"dec_stack": {"k": jnp.pad(st["k"], pad),
                          "v": jnp.pad(st["v"], pad), "len": st["len"]},
            "cross_kv": jcache["cross_kv"]}


def _cache_np(cache):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), cache)


def _assert_cache_close(got_np, want, dtype):
    """Port cache (``convert.to_numpy_cache``) against a JAX cache."""
    assert set(got_np) == set(want) == {"dec_stack", "cross_kv"}
    assert set(got_np["cross_kv"]) == {"k", "v"}
    for name, st in want.items():
        assert set(got_np[name]) == set(st), name
        for key, w in st.items():
            if key == "len":
                np.testing.assert_array_equal(got_np[name][key], w)
            else:
                assert_close(got_np[name][key], w, dtype)


def _jax_decode(dtype, toks, frames):
    """The cache of a JAX prefill of ``toks``' first P tokens over
    ``frames``, its self-attention stack padded to P + GEN slots for the
    decode steps."""
    jp = _jax_params(dtype)
    _, jcache = _jax_fn("prefill", dtype)(jp, jnp.asarray(toks[:, :P]),
                                          jnp.asarray(frames))
    return _pad_jax_cache(jcache, GEN)


@pytest.fixture(scope="module", autouse=True)
def _jax_programs_compiled(_quick_jax_compiles):
    """The parameters, then the JAX side of the comparisons below, made
    first on threads so that their programs compile side by side."""
    warm_jax([functools.partial(_port_params, d) for d in DTYPES])
    frames = jnp.asarray(_frames(0))
    calls = []
    for dtype in DTYPES:
        jp = _jax_params(dtype)
        calls.append(functools.partial(_jax_decode, dtype, _tokens(2, B, P),
                                       _frames(2)))
        for route in ROUTES:
            calls += [
                functools.partial(_jax_fn("train", dtype, route), jp,
                                  jnp.asarray(_tokens(0, B, S)), frames),
                functools.partial(_jax_fn("prefill", dtype, route), jp,
                                  jnp.asarray(_tokens(1, B, S)), frames)]
    warm_jax(calls)


# -- the config, the sinusoids ------------------------------------------------------

def test_config_matches_jax_field_for_field():
    assert "whisper_medium" in PORTED
    for getter_t, getter_j in ((get_config, j_get_config),
                               (get_smoke, j_get_smoke)):
        t, j = getter_t(ARCH), getter_j(ARCH)
        for f in t.__dataclass_fields__:
            if f in ("param_dtype", "compute_dtype", "attn_impl"):
                continue
            assert getattr(t, f) == getattr(j, f), f
        assert t.param_dtype == t.compute_dtype == torch.bfloat16
        assert t.attn_impl == "auto" and t.dh == j.dh
    assert [s.name for s in shapes_for(ARCH)] == [
        s.name for s in j_shapes_for(ARCH)]


@pytest.mark.parametrize("n, d", [(30, 64), (1500, 1024), (7, 6)])
def test_sinusoidal_positions_match_jax(n, d):
    """fp32 within what rounding allows: XLA's and torch's ``exp`` may
    differ by an ulp of ``inv`` (2^-23 relative), which the angle ``pos ·
    inv`` carries times pos < n, plus an ulp of the angle itself; sin and
    cos pass an angle error on at most 1:1."""
    got = TL.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), JL.sinusoidal_positions(n, d),
                               rtol=0, atol=2 * n * 2 ** -23)


# -- cross-attention and the layers -------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(dtype, route):
    """The cross block's K/V of an encoder output, then a prefill's S
    queries and one decode query attending to them."""
    jc, tc = configs(dtype, route)
    pc = _layer(_jax_params(dtype), "dec_stack", 0)["cross"]
    tpc = _port_params(dtype)["dec_stack"][0]["cross"]
    (jxq, txq), (jxd, txd), (je, te) = (
        _as(dtype, _x(seed, s, dtype))
        for seed, s in ((3, S), (4, 1), (5, tc.encdec["enc_frames"])))
    jkv, jout, jdec = _jax_fn("cross", dtype, route)(pc, jxq, jxd, je)
    kv = TA.encode_cross_kv(tpc, tc, te)
    assert kv["k"].shape == (B, 30, tc.n_kv_heads, tc.dh)
    for key in ("k", "v"):
        assert_close(kv[key], jkv[key], dtype)
    assert_close(TA.cross_attention(tpc, tc, txq, kv), jout, dtype)
    assert_close(TA.cross_attention(tpc, tc, txd, kv), jdec, dtype)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_and_decoder_layers_match_jax(dtype, route):
    """Encoder layer 0 (bidirectional self-attention over the frames) and
    decoder layer 1 in prefill with the encoder's cross K/V: the outputs
    and the decoder layer's cache."""
    jc, tc = configs(dtype, route)
    jp, tp = _jax_params(dtype), _port_params(dtype)
    (je, te), (jx, tx) = (_as(dtype, _x(6, 30, dtype)),
                          _as(dtype, _x(7, S, dtype)))
    want = _jax_fn("enc_layer", dtype, route)(_layer(jp, "enc_stack", 0), je)
    got, cache, _, _ = TM.apply_decoder_layer(
        tp["enc_stack"][0], tc, te, mode="train", cache=None,
        positions=torch.arange(30, dtype=torch.int32), causal=False)
    assert cache is None
    assert_close(got, want, dtype)

    lp = _layer(jp, "dec_stack", 1)
    jkv = JA.encode_cross_kv(lp["cross"], jc, want)
    wout, wcache = _jax_fn("dec_layer", dtype, route)(lp, jx, jkv)
    tkv = TA.encode_cross_kv(tp["dec_stack"][1]["cross"], tc,
                             torch.from_numpy(np.array(f32(want))).to(tx.dtype))
    gout, gcache, _, _ = TM.apply_decoder_layer(
        tp["dec_stack"][1], tc, tx, mode="prefill", cache=None,
        positions=torch.arange(S, dtype=torch.int32), enc_kv=tkv)
    assert_close(gout, wout, dtype)
    for key in ("k", "v"):
        assert_close(gcache[key], wcache[key], dtype)
    assert int(gcache["len"]) == S


# -- the model and the steps --------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_train_matches_jax(dtype, route):
    """Logits at every position, the learned positions added."""
    _, tc = configs(dtype, route)
    toks, frames = _tokens(0, B, S), _frames(0)
    want = _jax_fn("train", dtype, route)(_jax_params(dtype),
                                          jnp.asarray(toks),
                                          jnp.asarray(frames))
    got, aux, cache = TM.forward(_port_params(dtype), tc,
                                 torch.from_numpy(toks), mode="train",
                                 enc_inputs=torch.from_numpy(frames))
    assert cache is None and float(aux) == 0.0
    assert got.dtype == torch.float32 and got.shape == (B, S, tc.vocab)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_step_matches_jax(dtype, route):
    """Last-position logits and the whole cache: the decoder's
    self-attention stack and the cross K/V of every decoder layer."""
    _, tc = configs(dtype, route)
    toks, frames = _tokens(1, B, S), _frames(0)
    jl, jcache = _jax_fn("prefill", dtype, route)(
        _jax_params(dtype), jnp.asarray(toks), jnp.asarray(frames))
    tl, tcache = TS.make_prefill_step(tc)(
        _port_params(dtype), torch.from_numpy(toks),
        torch.from_numpy(frames))
    assert tl.dtype == torch.float32 and tl.shape == (B, tc.vocab)
    assert_close(tl, jl, dtype)
    assert tcache["cross_kv"]["k"].shape == (2, B, 30, 4, 16)
    _assert_cache_close(convert.to_numpy_cache(tcache), jcache, dtype)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_jax(dtype, route):
    """A JAX prefill of P tokens carried across (its self-attention stack
    padded to P + GEN slots on each side), then GEN decode steps in each
    package: the logits at each step and the final cache.  The port's
    cross-attention takes the flash route's plain version on ``auto``."""
    _, tc = configs(dtype, route)
    toks, frames = _tokens(2, B, P + GEN), _frames(2)
    jcache = _jax_decode(dtype, toks[:, :P], frames)
    tcache = convert.from_jax_cache(_cache_np(jcache), tc, device="cpu")
    cross = tcache["cross_kv"]["k"]
    jstep, tstep = _jax_fn("serve", dtype), TS.make_serve_step(tc)
    jp, tp = _jax_params(dtype), _port_params(dtype)
    for t in range(P, P + GEN):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        assert_close(tl, jl, dtype)
    assert tcache["cross_kv"]["k"] is cross      # read, never written
    _assert_cache_close(convert.to_numpy_cache(tcache), jcache, dtype)


def test_init_cache_matches_jax():
    for dtype in DTYPES:
        jc, tc = configs(dtype)
        want = JM.init_cache(jc, 2, 24)
        got = TM.init_cache(tc, 2, 24, device="cpu")
        assert set(got) == set(want)
        for name, st in want.items():
            assert set(got[name]) == set(st)
            for key, w in st.items():
                g = got[name][key]
                assert tuple(g.shape) == w.shape, (name, key)
                assert str(g.dtype)[6:] == str(w.dtype), (name, key)
                assert not g.any()


def test_encdec_needs_frames_and_refuses_chunks():
    _, tc = configs("f32")
    tp, toks = _port_params("f32"), torch.zeros((1, 4), dtype=torch.int32)
    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="enc_inputs"):
            TM.forward(tp, tc, toks, mode=mode)
    cache = TM.init_cache(tc, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        TM.forward(tp, tc, toks, mode="chunked_prefill", cache=cache,
                   cursor=0)


# -- convert, repack, the serve driver ----------------------------------------------

def test_convert_round_trip():
    """bf16 parameters (``pos`` and ``enc_pos`` plain leaves, the two
    stacks lists of layers) and a prefill cache there and back, exact."""
    jp, tp = _jax_params("bf16"), _port_params("bf16")
    _, tc = configs("bf16")
    assert len(tp["enc_stack"]) == len(tp["dec_stack"]) == 2
    assert set(tp["dec_stack"][0]) == {"attn_norm", "attn", "cross_norm",
                                       "cross", "mlp_norm", "mlp"}
    assert tp["pos"].shape == (512, 64) and tp["enc_pos"].shape == (30, 64)
    back = convert.to_numpy_params(tp)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, ref)
    assert TM.param_count(tp) == sum(a.size for a in jax.tree.leaves(want))

    jcache = _cache_np(_jax_decode("bf16", _tokens(2, B, P), _frames(2)))
    tcache = convert.from_jax_cache(jcache, tc, device="cpu")
    assert tcache["cross_kv"]["v"].dtype == torch.bfloat16
    assert "len" not in tcache["cross_kv"]
    back = convert.to_numpy_cache(tcache)
    for name, st in jcache.items():
        for key, w in st.items():
            np.testing.assert_array_equal(back[name][key], w)


def test_port_init_matches_jax_init_layout():
    """The port's own seeded init: every leaf of the JAX init at its shape,
    all bf16, ``enc_pos`` the sinusoids cast, the biases zero, and the same
    parameters from the same seed."""
    _, tc = configs("bf16")
    tp = TM.init(TM.make_generator(0, "cpu"), tc)
    want = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0),
                                          j_get_smoke(ARCH))[0])
    got = convert.to_numpy_params(tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(got)] == [
        a.shape for a in jax.tree.leaves(want)]
    assert {str(a.dtype) for a in jax.tree.leaves(want)} == {"bfloat16"}
    dtypes = set()
    convert._map(lambda t: dtypes.add(t.dtype), {
        k: v for k, v in tp.items() if k not in convert.LAYER_STACKS})
    for name in ("enc_stack", "dec_stack"):
        for layer in tp[name]:
            convert._map(lambda t: dtypes.add(t.dtype), layer)
    assert dtypes == {torch.bfloat16}
    np.testing.assert_array_equal(
        f32(tp["enc_pos"]), f32(TL.sinusoidal_positions(30, 64).bfloat16()))
    assert not tp["dec_stack"][0]["cross"]["wk"]["b"].any()
    again = TM.init(TM.make_generator(0, "cpu"), tc)
    assert torch.equal(again["pos"], tp["pos"])
    assert torch.equal(again["dec_stack"][1]["cross"]["wv"]["w"],
                       tp["dec_stack"][1]["cross"]["wv"]["w"])


def test_repack_cache_keeps_cross_kv():
    """The decoder's stack is padded to the decode capacity; the cross K/V
    pass through as the same tensors, bit for bit."""
    _, tc = configs("bf16")
    cache = TM.init_cache(tc, 2, 5, device="cpu")
    for key in ("k", "v"):
        cache["cross_kv"][key].normal_()
        cache["dec_stack"][key].normal_()
    cache["dec_stack"]["len"].fill_(5)
    before = {key: t.clone() for key, t in cache["cross_kv"].items()}
    out = TSV.repack_cache(cache, 9)
    assert out["cross_kv"] is cache["cross_kv"]
    for key in ("k", "v"):
        assert torch.equal(out["cross_kv"][key], before[key])
    k = out["dec_stack"]["k"]
    assert k.shape == (2, 2, 9, tc.n_kv_heads, tc.dh)
    assert torch.equal(k[:, :, :5], cache["dec_stack"]["k"])
    assert not k[:, :, 5:].any()
    assert out["dec_stack"]["len"].tolist() == [5, 5]


def test_serve_driver_tokens_match_jax_steps():
    """fp32: the driver's prefill (with the frames) → repack → greedy
    decode gives the tokens of the same composition of the JAX package's
    steps (its prefill, the self-attention stack padded, its decode)."""
    _, tc = configs("f32")
    prompts, frames = _tokens(2, B, P), _frames(2)
    res = TSV.serve(_port_params("f32"), tc, torch.from_numpy(prompts), GEN,
                    torch.from_numpy(frames))
    jp = _jax_params("f32")
    logits, cache = _jax_fn("prefill", "f32")(jp, jnp.asarray(prompts),
                                              jnp.asarray(frames))
    cache = _pad_jax_cache(cache, GEN)
    step = _jax_fn("serve", "f32")
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    want = []
    for t in range(P, P + GEN):
        want.append(np.asarray(tok))
        logits, cache = step(jp, cache, tok, jnp.int32(t))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.concatenate(want, axis=1))
    assert_close(res["logits"], logits, "f32")
    _assert_cache_close(convert.to_numpy_cache(res["cache"]), cache, "f32")


def test_serve_driver_main_runs_on_cpu(capsys):
    assert TSV.main(["--arch", ARCH, "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] batch=4 prefill(32 tok)=" in out
    assert "[serve] sample generated ids:" in out


def test_frame_embeddings_are_seeded():
    cfg = get_smoke(ARCH)
    a, b = (TSV.frame_embeddings(cfg, 3, TM.make_generator(7, "cpu"))
            for _ in range(2))
    assert a.shape == (3, 30, 64) and a.dtype == torch.bfloat16
    assert torch.equal(a, b)


# -- the reference's caveat ---------------------------------------------------------

def test_jax_pallas_kernel_refuses_1500_frames():
    """``flash_attention_pallas`` asserts ``sk % bk == 0`` with ``bk =
    min(256, Sk)`` (``flash_attention.py:86``), so its ``"pallas"`` route
    cannot run whisper's 1500 frames; the port is held to
    ``"reference"`` there (SMOKE's 30 frames run on both)."""
    q = jnp.zeros((1, 1, 256, 64), jnp.float32)
    kv = jnp.zeros((1, 1, 1500, 64), jnp.float32)
    with pytest.raises(AssertionError):
        flash_attention_pallas(q, kv, kv, causal=False, interpret=True)
