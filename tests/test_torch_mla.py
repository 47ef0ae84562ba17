"""Module step 9c against the JAX package: multi-head latent attention
(MLA) and deepseek-v3-671b at its SMOKE size.

``init_mla`` (the nine leaves, names and layouts), ``mla_attention`` in
prefill, chunked prefill (cursor 0 and past it) and decode, the SMOKE
model's prefill logits and latent cache on both attention routes, decode
steps from a carried cache, ``init_cache``'s latent stacks, the
multi-token-prediction (``mtp``) subtree carried across by
``repro_torch.convert`` and the serve driver.  Parameters come from the JAX
init, carried across by ``convert.from_jax_params``.  The JAX side runs
``attn_impl="reference"``, the plain path, which is right in every mode;
its ``"pallas"`` wrapper drops ``k_valid_len`` and the query offset (ROADMAP
queue 3), so it stands beside the port's ``"auto"`` route only in a
one-shot prefill, where it passes neither.

Tolerances: float32 within 1e-4 (rtol and atol); bfloat16 within
``2^-6 · max|reference|`` (those of ``test_torch_llm.py``).  The sigmoid
router scores bf16 logits (``x @ router`` in the activations' dtype, as in
the JAX package), which tie or nearly tie often enough that an ulp of
difference upstream sends a token to another expert in the two packages;
one such flip on a sequence's last token moves its logits by 20-30%
(relative L2).  So the whole bf16 model runs with ``top_k = n_experts``
(every token to every expert, the same parameters), where no flip can
happen, and float32 runs the SMOKE routing (top 2 of 8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.launch import steps as JS
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import PORTED, get_config, get_smoke
from repro_torch.launch import serve as TSV
from repro_torch.launch import steps as TS
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, warm_jax  # noqa: F401
from _torch_helpers import jax_init_f32

ARCH = "deepseek-v3-671b"
F32_TOL = 1e-4
# a one-shot prefill passes no k_valid_len, so there the JAX "pallas" route
# is right: on the CPU it runs the kernel's plain version, as the port's
# "auto" does (both leave P in fp32 for P·V, where the plain path rounds it
# to bf16)
J_ROUTE = {"ref": "reference", "auto": "pallas"}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.array(x, np.float32)


def assert_close(got, want, dtype):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if dtype == "bf16":
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2 ** -6 * np.abs(w).max())
    else:
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def configs(dtype, all_experts=False):
    """The SMOKE configs in ``dtype``; ``all_experts``: each token routed to
    every expert (``top_k = n_experts``)."""
    jc = j_get_smoke(ARCH).replace(remat="none", attn_impl="reference")
    tc = get_smoke(ARCH)
    if dtype == "f32":
        jc = jc.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32)
        tc = tc.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    if all_experts:
        moe = {**jc.moe, "top_k": jc.moe["n_experts"]}
        jc, tc = jc.replace(moe=moe), tc.replace(moe=moe)
    return jc, tc


def _bf16(jp):
    """The JAX bf16 init from the f32 one: it draws in f32 and casts each
    leaf but those it keeps in fp32 (``layers.FP32_LEAVES``)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in TL.FP32_LEAVES
        else a.astype(jnp.bfloat16), jp)


@pytest.fixture(scope="module")
def models():
    """dtype → (JAX config, port config, JAX params, port params); bf16
    routes every token to every expert."""
    out = {}
    jc32, _ = configs("f32")
    jp32 = jax_init_f32(jc32)
    for dtype, jp in (("f32", jp32), ("bf16", _bf16(jp32))):
        jc, tc = configs(dtype, all_experts=dtype == "bf16")
        pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        out[dtype] = (jc, tc, jp, convert.from_jax_params(pnp, tc,
                                                          device="cpu"))
    return out


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _x(seed, b, s, d, dtype):
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


# -- config and init ----------------------------------------------------------------

def test_config_matches_jax_field_for_field():
    assert "deepseek_v3_671b" in PORTED
    for getter_t, getter_j in ((get_config, j_get_config),
                               (get_smoke, j_get_smoke)):
        t, j = getter_t(ARCH), getter_j(ARCH)
        for f in t.__dataclass_fields__:
            if f in ("param_dtype", "compute_dtype", "attn_impl"):
                continue
            assert getattr(t, f) == getattr(j, f), f
    full = get_config(ARCH)
    assert full.prefill_chunk == 4096 and full.mtp
    assert full.mla["qk_nope_dim"] + full.mla["qk_rope_dim"] == 192
    assert full.mla["v_head_dim"] == 128


def test_init_mla_matches_jax_layout():
    """The seven linear weights and two norm gains, by name, shape and
    dtype."""
    _, tc = configs("bf16")
    jc, _ = configs("bf16")
    jp = jax.eval_shape(lambda k: JA.init_mla(k, jc)[0],
                        jax.random.PRNGKey(0))
    tp = TA.init_mla(TM.make_generator(0, "cpu"), tc)
    flat_j = {jax.tree_util.keystr(path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {jax.tree_util.keystr(path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert sorted(flat_j) == sorted(flat_t)
    assert len(flat_t) == 9
    for name, leaf in flat_t.items():
        assert tuple(leaf.shape) == tuple(flat_j[name].shape), name
        assert leaf.dtype == torch.bfloat16, name


def test_init_cache_matches_jax():
    jc, tc = configs("bf16")
    want = jax.eval_shape(lambda: JM.init_cache(jc, 2, 24))
    got = TM.init_cache(tc, 2, 24, device="cpu")
    assert sorted(got) == sorted(want) == ["dense_stack", "moe_stack"]
    for name, st in want.items():
        assert sorted(got[name]) == sorted(st) == ["ckv", "kr", "len"]
        for key, leaf in st.items():
            assert tuple(got[name][key].shape) == tuple(leaf.shape)
            assert not bool(got[name][key].any())
    assert got["moe_stack"]["ckv"].dtype == torch.bfloat16
    assert got["moe_stack"]["len"].dtype == torch.int32


# -- the MLA block -------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_block():
    """One MLA block's JAX f32 weights and the port's copies per dtype."""
    jc, _ = configs("f32")
    jp = jax.jit(lambda k: JA.init_mla(k, jc)[0])(jax.random.PRNGKey(3))
    pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    out = {}
    for dtype in ("f32", "bf16"):
        jc, tc = configs(dtype)
        jpd = jax.tree.map(lambda a: a.astype(jc.param_dtype), jp)
        out[dtype] = (jc, tc, jpd, convert.from_jax_params(pnp, tc,
                                                           device="cpu"))
    return out


def _jax_mla(jc, mode):
    return jax.jit(lambda p, x, cache, pos: JA.mla_attention(
        p, jc, x, mode=mode, cache=cache, positions=pos))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["ref", "auto"])
def test_mla_prefill_matches_jax(mla_block, dtype, route):
    jc, tc, jp, tp = mla_block[dtype]
    jx, tx = _x(0, 2, 24, jc.d_model, dtype)
    pos = np.arange(24, dtype=np.int32)
    out_j, cache_j = _jax_mla(jc, "prefill")(jp, jx, None, jnp.asarray(pos))
    out_t, cache_t = TA.mla_attention(tp, tc.replace(attn_impl=route), tx,
                                      mode="prefill")
    assert_close(out_t, out_j, dtype)
    for key in ("ckv", "kr"):
        assert_close(cache_t[key], cache_j[key], dtype)
    assert int(cache_t["len"]) == 24


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cursor", [0, 16])
def test_mla_chunked_prefill_matches_jax(mla_block, dtype, cursor):
    """A chunk of 8 tokens written at ``cursor`` into a cache of 32 slots
    that holds the JAX latent of the tokens before it: the output, the
    cache and its length, on both attention routes."""
    jc, tc, jp, tp = mla_block[dtype]
    jx, tx = _x(1, 2, cursor + 8, jc.d_model, dtype)
    cache_j = {key: jnp.zeros((2, 32, w), jc.compute_dtype) for key, w in
               (("ckv", jc.mla["kv_lora_rank"]),
                ("kr", jc.mla["qk_rope_dim"]))}
    cache_j["len"] = jnp.int32(0)
    if cursor:
        pre = _jax_mla(jc, "chunked_prefill")(
            jp, jx[:, :cursor], cache_j, jnp.arange(cursor, dtype=jnp.int32))
        cache_j = pre[1]
    pos = np.arange(cursor, cursor + 8, dtype=np.int32)
    out_j, new_j = _jax_mla(jc, "chunked_prefill")(
        jp, jx[:, cursor:], cache_j, jnp.asarray(pos))
    for route in ("ref", "auto"):
        cache_t = {key: torch.from_numpy(f32(cache_j[key])).to(
            tc.compute_dtype) for key in ("ckv", "kr")}
        cache_t["len"] = torch.tensor(cursor, dtype=torch.int32)
        ckv_buf = cache_t["ckv"]
        out_t, new_t = TA.mla_attention(
            tp, tc.replace(attn_impl=route), tx[:, cursor:],
            mode="chunked_prefill", cache=cache_t,
            positions=torch.from_numpy(pos), cursor=cursor)
        assert_close(out_t, out_j, dtype)
        for key in ("ckv", "kr"):
            assert_close(new_t[key], new_j[key], dtype)
        assert int(new_t["len"]) == int(new_j["len"]) == cursor + 8
        assert new_t["ckv"] is ckv_buf             # written in place


def test_chunked_prefill_needs_an_int_cursor(mla_block):
    jc, tc, jp, tp = mla_block["f32"]
    cache = TM.init_cache(tc.replace(n_layers=1, moe=None), 1, 8,
                          device="cpu")["dense_stack"]
    slot = {key: t[0] for key, t in cache.items()}
    x = torch.zeros(1, 4, tc.d_model)
    for cursor in (None, torch.tensor(0)):
        with pytest.raises(ValueError, match="Python int"):
            TA.mla_attention(tp, tc, x, mode="chunked_prefill", cache=slot,
                             cursor=cursor)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_decode_matches_jax(mla_block, dtype):
    """Three decode steps (the absorbed matmuls in fp32) over a 24-slot
    latent cache holding a JAX prefill of 16 tokens."""
    jc, tc, jp, tp = mla_block[dtype]
    jx, tx = _x(2, 2, 19, jc.d_model, dtype)
    _, pre = _jax_mla(jc, "prefill")(jp, jx[:, :16], None,
                                     jnp.arange(16, dtype=jnp.int32))
    pad = ((0, 0), (0, 8), (0, 0))
    cache_j = {"ckv": jnp.pad(pre["ckv"], pad), "kr": jnp.pad(pre["kr"], pad),
               "len": pre["len"]}
    cache_t = {key: torch.from_numpy(f32(cache_j[key])).to(tc.compute_dtype)
               for key in ("ckv", "kr")}
    cache_t["len"] = torch.tensor(16, dtype=torch.int32)
    step = _jax_mla(jc, "decode")
    for t in range(16, 19):
        out_j, cache_j = step(jp, jx[:, t:t + 1], cache_j,
                              jnp.asarray([t], jnp.int32))
        out_t, cache_t = TA.mla_attention(
            tp, tc, tx[:, t:t + 1], mode="decode", cache=cache_t,
            positions=torch.tensor([t], dtype=torch.int32))
        assert_close(out_t, out_j, dtype)
    for key in ("ckv", "kr"):
        assert_close(cache_t[key], cache_j[key], dtype)
    assert int(cache_t["len"]) == 19


# -- the SMOKE model ----------------------------------------------------------------

_JAX_STEPS = {}


def _jax_prefill(jc):
    """The jitted JAX prefill step, one per config (configs hold dicts, so
    they key by their repr)."""
    key = repr(jc)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(JS.make_prefill_step(jc))
    return _JAX_STEPS[key]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["ref", "auto"])
def test_prefill_matches_jax(models, dtype, route):
    """deepseek-v3 SMOKE (one dense layer, two MoE layers, MLA): the
    last-position logits and the latent cache of a 32-token prefill."""
    jc, tc, jp, tp = models[dtype]
    toks = _tokens(0, 2, 32)
    jl, jcache = _jax_prefill(jc.replace(attn_impl=J_ROUTE[route]))(
        jp, jnp.asarray(toks))
    tl, tcache = TS.make_prefill_step(tc.replace(attn_impl=route))(
        tp, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (2, jc.vocab)
    assert_close(tl, jl, dtype)
    for name in ("dense_stack", "moe_stack"):
        for key in ("ckv", "kr"):
            assert_close(tcache[name][key], jcache[name][key], dtype)
        assert tcache[name]["len"].tolist() == [32] * len(
            jcache[name]["len"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_steps_match_jax(models, dtype):
    """Four greedy-fed decode steps from the JAX prefill cache of 16
    tokens, padded to 20 slots: each step's logits and the final cache."""
    jc, tc, jp, tp = models[dtype]
    toks = _tokens(1, 2, 20)
    _, jcache = _jax_prefill(jc)(jp, jnp.asarray(toks[:, :16]))
    pad = ((0, 0), (0, 0), (0, 4), (0, 0))
    jcache = {name: {"ckv": jnp.pad(st["ckv"], pad),
                     "kr": jnp.pad(st["kr"], pad), "len": st["len"]}
              for name, st in jcache.items()}
    tcache = convert.from_jax_cache(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jcache), tc,
        device="cpu")
    jstep = jax.jit(JS.make_serve_step(jc))
    tstep = TS.make_serve_step(tc)
    for t in range(16, 20):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        assert_close(tl, jl, dtype)
    for name in jcache:
        for key in ("ckv", "kr"):
            assert_close(tcache[name][key], jcache[name][key], dtype)
        assert tcache[name]["len"].tolist() == [20] * len(
            jcache[name]["len"])


def test_mtp_subtree_carries_across(models):
    """The port's ``init`` builds JAX's ``mtp`` subtree (norms, proj, one
    dense MLA layer) leaf for leaf; ``convert`` carries JAX's across and
    back unchanged; serving never reads it."""
    jc, tc, jp, tp = models["bf16"]
    mine = TM.init(TM.make_generator(0, "cpu"), tc)

    def shapes(tree, leaf_shape):
        return {jax.tree_util.keystr(path): tuple(leaf_shape(leaf)) for
                path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = shapes(jp, lambda a: a.shape)
    ours = shapes(mine, lambda t: t.shape)
    # JAX stacks layers on axis 0; the port keeps a list per stack
    assert {k: v for k, v in ours.items() if "stack" not in k} == {
        k: v for k, v in want.items() if "stack" not in k}
    assert sorted(mine["mtp"]) == ["layer", "norm_e", "norm_h", "proj"]
    assert sorted(mine["mtp"]["layer"]["attn"]) == sorted(
        jp["mtp"]["layer"]["attn"])
    assert "mlp" in mine["mtp"]["layer"]
    assert TM.param_count(mine) == sum(
        a.size for a in jax.tree.leaves(jp))
    back = convert.to_numpy_params(tp)["mtp"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp["mtp"])[0]:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, np.asarray(leaf, np.float32))
    # serving is the same with the mtp subtree gone
    toks = torch.from_numpy(_tokens(2, 1, 8))
    no_mtp = {k: v for k, v in tp.items() if k != "mtp"}
    a, _ = TS.make_prefill_step(tc)(tp, toks)
    b, _ = TS.make_prefill_step(tc)(no_mtp, toks)
    assert torch.equal(a, b)


def test_serve_driver_matches_jax_steps(models):
    """The serve driver (one-shot prefill, repack of the latent cache,
    greedy decode) in f32 makes the tokens that JAX's steps make."""
    jc, tc, jp, tp = models["f32"]
    toks = _tokens(3, 2, 16)
    res = TSV.serve(tp, tc, torch.from_numpy(toks), 4)
    assert res["cache"]["moe_stack"]["ckv"].shape[2] == 20
    jl, jcache = _jax_prefill(jc)(jp, jnp.asarray(toks))
    pad = ((0, 0), (0, 0), (0, 4), (0, 0))
    jcache = {name: {"ckv": jnp.pad(st["ckv"], pad),
                     "kr": jnp.pad(st["kr"], pad), "len": st["len"]}
              for name, st in jcache.items()}
    jstep = jax.jit(JS.make_serve_step(jc))
    out = []
    tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    for t in range(16, 20):
        out.append(np.asarray(tok))
        jl, jcache = jstep(jp, jcache, tok, jnp.int32(t))
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.concatenate(out, axis=1))
    assert_close(res["logits"], jl, "f32")


def test_serve_driver_main_runs_on_cpu(capsys):
    assert TSV.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "16", "--gen", "3"]) == 0
    assert "[serve] batch=2" in capsys.readouterr().out
