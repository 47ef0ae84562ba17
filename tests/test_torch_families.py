"""The six configs of module step 9a against the JAX package: the dense
chatglm3-6b, starcoder2-7b, minicpm-2b and chameleon-34b, the SSM
mamba2-130m and the hybrid zamba2-7b, each at its SMOKE size.

For every config: the registry entry field for field, ``init_cache``, the
forward in train mode, the prefill step (last-position logits and the
cache) on each attention route, decode steps from a prefill cache carried
across, and a round trip of the parameters and caches through
``repro_torch.convert``; for mamba2 and zamba2 also the serve driver and
its command line.  Parameters come from the JAX package's own init at each
dtype (its bf16 init keeps ``a_log``, ``dt_bias`` and ``d_skip`` in fp32),
and zamba2's LoRA ``b`` factors are drawn away from their zero init.

Tolerances: float32 within 1e-4; bfloat16 within ``2^-6 · max|reference|``
(``test_torch_llm.assert_bf16_close``).  One exception, zamba2 in bf16 end
to end: one ulp of noise on the input of its four mamba layers moves their
output by more than ``2^-6 · max`` (``test_hybrid_bf16_amplifies_ulps``),
and the two packages round at other places (XLA fuses, torch runs op by
op).  There each block is held at ``2^-6`` on the JAX block's own input
(``test_hybrid_bf16_layer_by_layer``), and the whole model's logits within
a relative L2 error of ``2^-4``, the bound that ``chip_smoke.py`` puts on
two bf16 routes of one model.
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
from repro.launch import steps as JS
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import (PORTED, get_config, get_smoke, shapes_for,
                                 sub_quadratic_decode)
from repro_torch.launch import serve as TSV
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, warm_jax  # noqa: F401
from _torch_helpers import jax_init_f32

DENSE = ["chatglm3-6b", "starcoder2-7b", "minicpm-2b", "chameleon-34b"]
SSM_FAMILIES = ["mamba2-130m", "zamba2-7b"]
ARCHS = DENSE + SSM_FAMILIES
DTYPES = ["f32", "bf16"]
F32_TOL = 1e-4
LOGITS_REL_TOL = 2 ** -4
J_ROUTE = {"ref": "reference", "auto": "pallas"}


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


def rel_l2(got, want) -> float:
    g, w = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def assert_logits_close(arch, got, want, dtype):
    """The end-to-end bound: zamba2 in bf16 by relative L2 (module
    docstring), everything else elementwise."""
    if arch == "zamba2-7b" and dtype == "bf16":
        assert f32(got).shape == f32(want).shape
        assert rel_l2(got, want) <= LOGITS_REL_TOL, rel_l2(got, want)
    else:
        assert_close(got, want, dtype)


def configs(arch, dtype):
    jc = j_get_smoke(arch).replace(remat="none")
    tc = get_smoke(arch)
    if dtype == "f32":
        jc = jc.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32)
        tc = tc.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    return jc, tc


def _lora_b(jparams, jc):
    """zamba2's LoRA ``b`` factors drawn from N(0, 1): the init's zeros
    would leave the delta ``a @ b`` at zero."""
    b = jparams["shared_lora"]["b"]
    draw = np.random.default_rng(7).normal(size=b.shape).astype(np.float32)
    return {**jparams, "shared_lora": {**jparams["shared_lora"],
                                       "b": jnp.asarray(draw).astype(
                                           jc.param_dtype)}}


@pytest.fixture(scope="module")
def models():
    """``get(arch, dtype)`` → (JAX config, port config, JAX params, port
    params), made once per module: the JAX init at that dtype, carried
    across by ``convert.from_jax_params``.  The JAX init draws in f32 and
    casts each leaf but those it keeps in fp32 (``layers.FP32_LEAVES``),
    so the bf16 parameters are the f32 ones cast (the same arrays, one
    compiled init fewer per config)."""
    made = {}

    def get(arch, dtype):
        if (arch, dtype) not in made:
            jc, tc = configs(arch, dtype)
            if dtype == "bf16":
                jp = jax.tree_util.tree_map_with_path(
                    lambda path, a: a if path[-1].key in TL.FP32_LEAVES
                    else a.astype(jnp.bfloat16), get(arch, "f32")[2])
            else:
                jp = jax_init_f32(jc)
                if "shared_lora" in jp:
                    jp = _lora_b(jp, jc)
            pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
            made[arch, dtype] = (jc, tc, jp, convert.from_jax_params(
                pnp, tc, device="cpu"))
        return made[arch, dtype]
    return get


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _cache_np(cache):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), cache)


def _assert_cache_close(got_np, want, dtype):
    """Port cache (``convert.to_numpy_cache``) against a JAX cache."""
    assert set(got_np) == set(want)
    for name, st in want.items():
        assert set(got_np[name]) == set(st), name
        for key, w in st.items():
            if key == "len":
                np.testing.assert_array_equal(got_np[name][key], w)
            else:
                assert_close(got_np[name][key], w, dtype)



@functools.lru_cache(maxsize=None)
def _jax_step(kind, arch, dtype, route=None):
    """The JAX package's compiled ``kind`` ("train", "prefill" on ``route``
    or the config's own, "serve") for one config, made once, so that the
    warm-up below and the tests call the same function."""
    jc, _ = configs(arch, dtype)
    if kind == "train":
        return jax.jit(lambda p, t: JM.forward(p, jc, t, mode="train"))
    if kind == "prefill":
        return jax.jit(JS.make_prefill_step(
            jc if route is None else jc.replace(attn_impl=J_ROUTE[route])))
    return jax.jit(JS.make_serve_step(jc))


def _pad_jax_cache(jcache, extra):
    """Each attention stack of a JAX cache padded by ``extra`` slots."""
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return {name: ({"k": jnp.pad(st["k"], pad), "v": jnp.pad(st["v"], pad),
                    "len": st["len"]} if "k" in st else st)
            for name, st in jcache.items()}


@pytest.fixture(scope="module", autouse=True)
def _jax_programs_compiled(_quick_jax_compiles, models):
    """The parameters, then the JAX side of the parametrised forward,
    prefill and decode comparisons, made first on threads so that their
    programs compile side by side; each test then makes the same calls
    (cache hits) and compares as before."""
    def params(arch):
        for dtype in DTYPES:
            models(arch, dtype)

    warm_jax([functools.partial(params, a) for a in ARCHS])

    def decode(arch, dtype, jp, toks):
        _, jcache = _jax_step("prefill", arch, dtype)(jp, toks[:, :12])
        _jax_step("serve", arch, dtype)(jp, _pad_jax_cache(jcache, 4),
                                        toks[:, 12:13], jnp.int32(12))

    calls = []
    for arch in ARCHS:
        for dtype in DTYPES:
            jc, _, jp, _ = models(arch, dtype)
            calls.append(functools.partial(
                _jax_step("train", arch, dtype), jp,
                jnp.asarray(_tokens(0, 2, 64, jc.vocab))))
            calls += [functools.partial(
                _jax_step("prefill", arch, dtype, route), jp,
                jnp.asarray(_tokens(1, 2, 64, jc.vocab)))
                for route in J_ROUTE]
            calls.append(functools.partial(
                decode, arch, dtype, jp,
                jnp.asarray(_tokens(2, 2, 16, jc.vocab))))
    warm_jax(calls)

# -- configs ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_field_for_field(arch):
    assert arch.replace("-", "_").replace(".", "_") in PORTED
    for getter_t, getter_j in ((get_config, j_get_config),
                               (get_smoke, j_get_smoke)):
        t, j = getter_t(arch), getter_j(arch)
        for f in t.__dataclass_fields__:
            if f in ("param_dtype", "compute_dtype", "attn_impl"):
                continue
            assert getattr(t, f) == getattr(j, f), f
        assert t.param_dtype == t.compute_dtype == torch.bfloat16
        assert t.attn_impl == "auto"
        assert t.dh == j.dh
    assert [s.name for s in shapes_for(arch)] == [
        s.name for s in j_shapes_for(arch)]
    assert sub_quadratic_decode(get_config(arch)) == (arch in SSM_FAMILIES)


# -- caches -------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    for dtype in ("f32", "bf16"):
        jc, tc = configs(arch, dtype)
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


# -- the forward, the steps ---------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(models, arch, dtype):
    """Logits at every position, on the plain attention route."""
    jc, tc, jp, tp = models(arch, dtype)
    toks = _tokens(0, 2, 64, jc.vocab)
    want, _, _ = _jax_step("train", arch, dtype)(jp, jnp.asarray(toks))
    got, aux, cache = TM.forward(tp, tc.replace(attn_impl="ref"),
                                 torch.from_numpy(toks), mode="train")
    assert cache is None and float(aux) == 0.0
    assert got.dtype == torch.float32 and got.shape == (2, 64, jc.vocab)
    assert_logits_close(arch, got, want, dtype)


@pytest.mark.parametrize("route", ["ref", "auto"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(models, arch, dtype, route):
    """Last-position logits and the whole cache, each attention route
    against its JAX counterpart ("auto" runs the kernel's plain version on
    the CPU in both packages)."""
    jc, tc, jp, tp = models(arch, dtype)
    toks = _tokens(1, 2, 64, jc.vocab)
    jl, jcache = _jax_step("prefill", arch, dtype, route)(
        jp, jnp.asarray(toks))
    tl, tcache = TS.make_prefill_step(tc.replace(attn_impl=route))(
        tp, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (2, jc.vocab)
    assert_logits_close(arch, tl, jl, dtype)
    if arch == "zamba2-7b" and dtype == "bf16":
        return              # the cache: test_hybrid_bf16_layer_by_layer
    _assert_cache_close(convert.to_numpy_cache(tcache), jcache, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(models, arch, dtype):
    """A JAX prefill of 12 tokens carried across (repacked to capacity 16
    on each side), then four decode steps in each package: logits and the
    final cache."""
    jc, tc, jp, tp = models(arch, dtype)
    toks = _tokens(2, 2, 16, jc.vocab)
    _, jcache = _jax_step("prefill", arch, dtype)(jp,
                                                  jnp.asarray(toks[:, :12]))
    jcache = _pad_jax_cache(jcache, 4)
    tcache = convert.from_jax_cache(_cache_np(jcache), tc, device="cpu")
    jstep = _jax_step("serve", arch, dtype)
    tstep = TS.make_serve_step(tc)
    for t in range(12, 16):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        assert_logits_close(arch, tl, jl, dtype)
    if arch == "zamba2-7b" and dtype == "bf16":
        return
    _assert_cache_close(convert.to_numpy_cache(tcache), jcache, dtype)


def test_decode_writes_the_cache_in_place(models):
    jc, tc, jp, tp = models("zamba2-7b", "f32")
    cache = TM.init_cache(tc, 2, 8, device="cpu")
    ptrs = {(n, k): t.data_ptr() for n, st in cache.items()
            for k, t in st.items() if k != "len"}
    _, new = TS.make_serve_step(tc)(tp, cache, torch.zeros(
        (2, 1), dtype=torch.int32), 0)
    assert {(n, k): t.data_ptr() for n, st in new.items()
            for k, t in st.items() if k != "len"} == ptrs
    assert new["shared_attn"]["len"].tolist() == [1, 1]
    assert bool(new["mamba_stack"]["h"].abs().sum() > 0)


# -- the hybrid in bf16 -------------------------------------------------------------

def _jax_layers(jc):
    """The hybrid's order of blocks: ("shared", invocation) before every
    ``attn_every``-th layer, and ("mamba", layer)."""
    every = jc.hybrid["attn_every"]
    for i in range(jc.n_layers):
        if i % every == 0:
            yield "shared", i // every
        yield "mamba", i


@pytest.fixture(scope="module")
def hybrid_walk(models):
    """zamba2 in bf16 through the JAX package's layer functions, one
    compiled call per block: each block's input, output and cache for a
    prefill of 32 tokens and a decode step of the 33rd."""
    jc, _, jp, _ = models("zamba2-7b", "bf16")
    toks = jnp.asarray(_tokens(3, 2, 33, jc.vocab))
    pos, dpos = jnp.arange(32, dtype=jnp.int32), jnp.asarray([32], jnp.int32)

    @jax.jit
    def shared(pa, x, xd):
        y, c, _, _ = JM.apply_decoder_layer(pa, jc, x, mode="prefill",
                                            cache=None, positions=pos,
                                            use_moe=False)
        pad = ((0, 0), (0, 1), (0, 0), (0, 0))
        c = {"k": jnp.pad(c["k"], pad), "v": jnp.pad(c["v"], pad),
             "len": c["len"]}
        yd, cd, _, _ = JM.apply_decoder_layer(pa, jc, xd, mode="decode",
                                              cache=c, positions=dpos,
                                              use_moe=False)
        return y, c, yd, cd

    @jax.jit
    def mamba(lp, x, xd):
        y, c = JM.apply_mamba_layer(lp, jc, x, mode="prefill", cache=None)
        yd, cd = JM.apply_mamba_layer(lp, jc, xd, mode="decode", cache=c)
        return y, c, yd, cd

    x = JM.embed(jp["embed"], toks[:, :32]).astype(jnp.bfloat16)
    xd = JM.embed(jp["embed"], toks[:, 32:]).astype(jnp.bfloat16)
    steps = []
    for kind, i in _jax_layers(jc):
        if kind == "shared":
            out = shared(JM._apply_lora_to_attn(jp["shared"],
                                                jp["shared_lora"], i), x, xd)
        else:
            out = mamba(jax.tree.map(lambda a: a[i], jp["mamba_stack"]), x,
                        xd)
        steps.append((kind, i, x, xd, out))
        x, xd = out[0], out[2]
    return toks, steps, x


def test_hybrid_bf16_layer_by_layer(models, hybrid_walk):
    """zamba2 in bf16: each shared-block invocation (its LoRA delta merged)
    and each mamba layer of the JAX package, in prefill and then one decode
    step, on the JAX layer's own input, against the port's within
    ``2^-6 · max``; the caches too."""
    jc, tc, jp, tp = models("zamba2-7b", "bf16")
    tc = tc.replace(attn_impl="ref")
    tpos = torch.arange(32, dtype=torch.int32)
    dpos = torch.tensor([32], dtype=torch.int32)
    _, steps, _ = hybrid_walk
    for kind, i, x, xd, (want, wcache, wd, wdcache) in steps:
        tx, txd = (torch.from_numpy(f32(t)).bfloat16() for t in (x, xd))
        if kind == "shared":
            pa = JM._apply_lora_to_attn(jp["shared"], jp["shared_lora"], i)
            tpa = TM._apply_lora_to_attn(tp["shared"], tp["shared_lora"], i)
            assert_close(tpa["attn"]["wq"]["w"], pa["attn"]["wq"]["w"], "bf16")
            got, c, _, _ = TM.apply_decoder_layer(tpa, tc, tx, mode="prefill",
                                                  cache=None, positions=tpos)
            c = {"k": torch.nn.functional.pad(c["k"], (0, 0, 0, 0, 0, 1)),
                 "v": torch.nn.functional.pad(c["v"], (0, 0, 0, 0, 0, 1)),
                 "len": c["len"]}
            for key in ("k", "v"):       # before decode writes slot 32
                assert_close(c[key], wcache[key], "bf16")
            gd, gdcache, _, _ = TM.apply_decoder_layer(
                tpa, tc, txd, mode="decode", cache=c, positions=dpos)
        else:
            lp = tp["mamba_stack"][i]
            got, c = TM.apply_mamba_layer(lp, tc, tx, mode="prefill",
                                          cache=None)
            gd, gdcache = TM.apply_mamba_layer(lp, tc, txd, mode="decode",
                                               cache=c)
        assert_close(got, want, "bf16")
        assert_close(gd, wd, "bf16")
        for key in ("k", "v", "conv_x", "conv_bc", "h"):
            if key in wdcache:
                if key not in ("k", "v"):
                    assert_close(c[key], wcache[key], "bf16")
                assert_close(gdcache[key], wdcache[key], "bf16")


def test_hybrid_bf16_amplifies_ulps(models, hybrid_walk):
    """Why zamba2's bf16 end-to-end bound is a relative L2 one: one ulp of
    noise on every input element of the JAX package's four mamba layers
    (what two correct bf16 implementations leave between them, as
    ``test_hybrid_bf16_layer_by_layer`` finds) moves their output by more
    than ``2^-6 · max``, while its relative L2 error stays below half of
    ``2^-4``."""
    jc, _, jp, _ = models("zamba2-7b", "bf16")
    _, steps, _ = hybrid_walk
    mamba = jax.jit(lambda lp, x: JM.apply_mamba_layer(
        lp, jc, x, mode="prefill", cache=None)[0])
    a = steps[1][2]                           # mamba layer 0's input
    flip = np.random.default_rng(0).choice([-1.0, 1.0], size=a.shape)
    b = jnp.nextafter(a, jnp.asarray(flip * 1e4, a.dtype))
    assert float((b != a).mean()) > 0.99
    for i in range(jc.n_layers):
        lp = jax.tree.map(lambda t: t[i], jp["mamba_stack"])
        a, b = mamba(lp, a), mamba(lp, b)
    assert np.abs(f32(a) - f32(b)).max() > 2 ** -6 * np.abs(f32(a)).max()
    assert rel_l2(b, a) < LOGITS_REL_TOL / 2


def test_lora_delta_moves_the_logits(models):
    jc, tc, jp, tp = models("zamba2-7b", "f32")
    toks = torch.from_numpy(_tokens(5, 2, 16, jc.vocab))
    with_lora, _, _ = TM.forward(tp, tc, toks)
    zero = {**tp, "shared_lora": {**tp["shared_lora"],
                                  "b": torch.zeros_like(tp["shared_lora"]["b"])}}
    without, _, _ = TM.forward(zero, tc, toks)
    assert rel_l2(with_lora, without) > 1e-2


# -- the serve driver ---------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_FAMILIES)
def test_serve_driver_tokens_match_jax_steps(models, arch):
    """fp32: the driver's prefill → repack → greedy decode gives the tokens
    of the same composition of the JAX package's steps."""
    jc, tc, jp, tp = models(arch, "f32")
    prompts, gen = _tokens(6, 3, 24, jc.vocab), 6
    res = TSV.serve(tp, tc, torch.from_numpy(prompts), gen)

    logits, cache = jax.jit(JS.make_prefill_step(jc))(jp, jnp.asarray(prompts))
    pad = ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0))
    cache = {name: ({"k": jnp.pad(st["k"], pad), "v": jnp.pad(st["v"], pad),
                     "len": st["len"]} if "k" in st else st)
             for name, st in cache.items()}
    step = jax.jit(JS.make_serve_step(jc))
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    want = []
    for t in range(prompts.shape[1], prompts.shape[1] + gen):
        want.append(np.asarray(tok))
        logits, cache = step(jp, cache, tok, jnp.int32(t))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.concatenate(want, axis=1))
    assert_close(res["logits"], logits, "f32")
    _assert_cache_close(convert.to_numpy_cache(res["cache"]), cache, "f32")


@pytest.mark.parametrize("arch", SSM_FAMILIES)
def test_serve_driver_main_runs_on_cpu(capsys, arch):
    assert TSV.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] batch=2 prefill(8 tok)=" in out
    assert "[serve] sample generated ids:" in out


def test_repack_cache_pads_attention_and_keeps_the_state():
    cfg = get_smoke("zamba2-7b")
    cache = TM.init_cache(cfg, 2, 5, device="cpu")
    cache["mamba_stack"]["h"].normal_()
    cache["shared_attn"]["k"].normal_()
    cache["shared_attn"]["len"].fill_(5)
    out = TSV.repack_cache(cache, 9)
    assert out["mamba_stack"] is cache["mamba_stack"]
    k = out["shared_attn"]["k"]
    assert k.shape == (2, 2, 9, cfg.n_kv_heads, cfg.dh)
    assert torch.equal(k[:, :, :5], cache["shared_attn"]["k"])
    assert not k[:, :, 5:].any()
    assert out["shared_attn"]["len"].tolist() == [5, 5]


# -- convert ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_FAMILIES + ["starcoder2-7b"])
def test_convert_round_trip(models, arch):
    """bf16 parameters and a prefill cache there and back, exact; the JAX
    init's fp32 leaves and the SSM state stay fp32."""
    jc, tc, jp, tp = models(arch, "bf16")
    back = convert.to_numpy_params(tp)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, ref)
    assert TM.param_count(tp) == sum(a.size for a in jax.tree.leaves(want))
    jdtypes = jax.tree.map(lambda a: str(a.dtype), jp)
    if "mamba_stack" in tp:
        assert len(tp["mamba_stack"]) == jc.n_layers
        for key in ("a_log", "dt_bias", "d_skip"):
            assert jdtypes["mamba_stack"]["mixer"][key] == "float32"
            for layer in tp["mamba_stack"]:
                assert layer["mixer"][key].dtype == torch.float32
        assert tp["mamba_stack"][0]["mixer"]["in_x"]["w"].dtype == \
            torch.bfloat16
    if "shared_lora" in tp:
        assert tp["shared_lora"]["a"].shape == jp["shared_lora"]["a"].shape
        assert tp["shared"]["attn"]["wq"]["w"].dtype == torch.bfloat16

    _, jcache = jax.jit(JS.make_prefill_step(jc))(
        jp, jnp.asarray(_tokens(8, 2, 16, jc.vocab)))
    cache_np = _cache_np(jcache)
    tcache = convert.from_jax_cache(cache_np, tc, device="cpu")
    for name, st in tcache.items():
        for key, t in st.items():
            want_dtype = {"len": torch.int32, "h": torch.float32}.get(
                key, torch.bfloat16)
            assert t.dtype == want_dtype, (name, key)
    again = convert.to_numpy_cache(tcache)
    assert jax.tree.structure(again) == jax.tree.structure(cache_np)
    for got, ref in zip(jax.tree.leaves(again), jax.tree.leaves(cache_np)):
        np.testing.assert_array_equal(got, ref)
