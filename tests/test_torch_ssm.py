"""The port's Mamba2 (SSD) block, ``repro_torch.models.ssm``, against the
JAX package's ``repro.models.ssm`` on the same inputs.

Inputs come from numpy seeds; parameters are the JAX init's, carried across
by ``convert.from_jax_params`` (the SMOKE mamba2-130m: d_model 64, d_inner
128, 4 heads of 32, state 16, chunk 32).  Tolerances: float32 within 1e-4
(the two packages contract the chunk sums in other orders); bfloat16
within ``2^-6 · max|reference|``, as ``test_torch_llm.assert_bf16_close``;
the chunked scan against the per-token recurrence within 5e-2, as the JAX
package's ``test_ssd_chunked_equals_stepwise``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats  # noqa: F401

ARCH = "mamba2-130m"
# the SSM mixer's share of the leaves kept in fp32 (layers.FP32_LEAVES)
MIXER_FP32_LEAVES = ("dt_bias", "a_log", "d_skip")
F32_TOL = 1e-4


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


def configs(dtype):
    jc, tc = j_get_smoke(ARCH), get_smoke(ARCH)
    if dtype == "f32":
        jc = jc.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32)
        tc = tc.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    return jc, tc


@pytest.fixture(scope="module")
def mixers():
    """Layer 0's mixer of the JAX init at each dtype (its own init, so
    ``a_log``, ``dt_bias`` and ``d_skip`` stay fp32 in bf16 too), and the
    port's copy."""
    out = {}
    for dtype in ("f32", "bf16"):
        jc, tc = configs(dtype)
        jp = jax.jit(lambda k: JSSM.init_mamba2(k, jc)[0])(
            jax.random.PRNGKey(3))
        pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        tp = convert.from_jax_params({"mamba_stack": jax.tree.map(
            lambda a: a[None], pnp)}, tc.replace(n_layers=1),
            device="cpu")["mamba_stack"][0]
        out[dtype] = (jc, tc, jp, tp)
    return out


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def test_fp32_leaves_stay_fp32(mixers):
    jc, tc, jp, tp = mixers["bf16"]
    assert set(MIXER_FP32_LEAVES) <= set(TL.FP32_LEAVES)
    for key in MIXER_FP32_LEAVES:
        assert jp[key].dtype == jnp.float32
        assert tp[key].dtype == torch.float32
    assert tp["in_x"]["w"].dtype == torch.bfloat16
    assert tp["conv_x"].dtype == torch.bfloat16
    got = TSSM.init_mamba2(torch.Generator().manual_seed(0), tc)
    assert convert._map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), got) \
        == jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    for key in MIXER_FP32_LEAVES:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(jp[key]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_silu_rounds_as_jax(dtype):
    jx, tx = _x(0, (4096,), dtype)
    jx, tx = jx * 4, tx * 4
    want = jax.nn.silu(jx)
    got = TSSM.silu(tx)
    assert got.dtype == tx.dtype
    if dtype == "bf16":     # each op rounded as XLA rounds it: bit for bit
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(dtype, with_tail):
    jx, tx = _x(1, (2, 9, 24), dtype)
    jk, tk = _x(2, (4, 24), dtype)
    jt, tt = _x(3, (2, 3, 24), dtype) if with_tail else (None, None)
    want, want_tail = JSSM._causal_conv(jx, jk, jt)
    got, got_tail = TSSM._causal_conv(tx, tk, tt)
    assert got.dtype == tx.dtype and got_tail.shape == (2, 3, 24)
    assert_close(got, want, dtype)
    np.testing.assert_array_equal(got_tail.float().numpy(),
                                  np.asarray(want_tail, np.float32))


SSD_CASES = [
    # b, s, h, g, n, p, chunk, with h0
    (2, 64, 4, 1, 16, 32, 32, False),    # even: two chunks of 32
    (1, 45, 4, 1, 16, 32, 32, False),    # odd: the chunk halves to 1
    (2, 48, 6, 2, 8, 16, 32, False),     # 48: the chunk halves to 16; G 2
    (2, 64, 4, 1, 16, 32, 16, True),     # a given entering state
]


@pytest.mark.parametrize("case", range(len(SSD_CASES)))
def test_ssd_chunked_matches_jax(case):
    b, s, h, g, n, p, chunk, with_h0 = SSD_CASES[case]
    rng = np.random.default_rng(10 + case)
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    bt = rng.normal(size=(b, s, g, n)).astype(np.float32)
    ct = rng.normal(size=(b, s, g, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.exp(np.log(np.arange(1, h + 1, dtype=np.float32)))
    h0 = (rng.normal(size=(b, h, n, p)).astype(np.float32) if with_h0
          else None)
    want_y, want_h = jax.jit(JSSM._ssd_chunked, static_argnums=5)(
        *(jnp.asarray(t) for t in (xh, bt, ct, dt, a)), chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = TSSM._ssd_chunked(
        *(torch.from_numpy(t) for t in (xh, bt, ct, dt, a)), chunk,
        h0=None if h0 is None else torch.from_numpy(h0))
    assert got_y.shape == (b, s, h, p) and got_h.shape == (b, h, n, p)
    assert_close(got_y, want_y, "f32")
    assert_close(got_h, want_h, "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mamba2_block_matches_jax(mixers, dtype, mode):
    jc, tc, jp, tp = mixers[dtype]
    jx, tx = _x(4, (2, 64, jc.d_model), dtype)
    want, want_cache = jax.jit(lambda p, x: JSSM.mamba2_block(
        p, jc, x, mode=mode))(jp, jx)
    got, got_cache = TSSM.mamba2_block(tp, tc, tx, mode=mode)
    assert got.dtype == tx.dtype
    assert_close(got, want, dtype)
    if mode == "train":
        assert got_cache is None and want_cache is None
        return
    assert got_cache["h"].dtype == torch.float32
    assert got_cache["conv_x"].dtype == tx.dtype
    for key in ("conv_x", "conv_bc", "h"):
        assert_close(got_cache[key], want_cache[key], dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_block_decode_matches_jax(mixers, dtype):
    """Four decode steps after a prefill, each from the other package's
    cache carried across."""
    jc, tc, jp, tp = mixers[dtype]
    jx, tx = _x(5, (2, 20, jc.d_model), dtype)
    _, jcache = jax.jit(lambda p, x: JSSM.mamba2_block(
        p, jc, x, mode="prefill"))(jp, jx[:, :16])
    tcache = convert.from_jax_cache(
        {"mamba_stack": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     jcache)}, tc, device="cpu")["mamba_stack"]
    decode = jax.jit(lambda p, x, c: JSSM.mamba2_block(
        p, jc, x, mode="decode", cache=c))
    for t in range(16, 20):
        want, jcache = decode(jp, jx[:, t:t + 1], jcache)
        got, tcache = TSSM.mamba2_block(tp, tc, tx[:, t:t + 1],
                                        mode="decode", cache=tcache)
        assert_close(got, want, dtype)
    for key in ("conv_x", "conv_bc", "h"):
        assert_close(tcache[key], jcache[key], dtype)
    assert tcache["h"].dtype == torch.float32


def test_init_ssm_cache_matches_jax():
    for dtype in ("f32", "bf16"):
        jc, tc = configs(dtype)
        want = JSSM.init_ssm_cache(jc, 3)
        got = TSSM.init_ssm_cache(tc, 3, device="cpu")
        assert set(got) == set(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
            assert not got[key].any()


def test_chunked_equals_stepwise():
    """The port's chunk-parallel SSD against its own per-token recurrence,
    as the JAX package's ``test_ssd_chunked_equals_stepwise`` holds the
    JAX block (SMOKE mamba2 in bf16)."""
    cfg = get_smoke(ARCH)
    p = TSSM.init_mamba2(torch.Generator().manual_seed(2), cfg)
    x = (torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 32, cfg.d_model)).astype(np.float32)) * 0.3).to(
            cfg.compute_dtype)
    y_chunk, _ = TSSM.mamba2_block(p, cfg, x, mode="train")
    cache = TSSM.init_ssm_cache(cfg, 1, device="cpu")
    outs = []
    for t in range(32):
        o, cache = TSSM.mamba2_block(p, cfg, x[:, t:t + 1], mode="decode",
                                     cache=cache)
        outs.append(o[:, 0])
    y_step = torch.stack(outs, dim=1)
    np.testing.assert_allclose(y_chunk.float().numpy(),
                               y_step.float().numpy(), rtol=5e-2, atol=5e-2)


def test_chunked_prefill_is_not_ported(mixers):
    """Chunked prefill is ported since module step 9c
    (``test_torch_chunked.py``): two windows from a zeroed cache give the
    one-shot prefill's output and state, and it needs a cache."""
    jc, tc, jp, tp = mixers["f32"]
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 16, tc.d_model)).astype(np.float32))
    one, one_cache = TSSM.mamba2_block(tp, tc, x, mode="prefill")
    cache = TSSM.init_ssm_cache(tc, 1, device="cpu")
    outs = []
    for lo in (0, 8):
        out, cache = TSSM.mamba2_block(tp, tc, x[:, lo:lo + 8],
                                       mode="chunked_prefill", cache=cache)
        outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), one.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache["h"].numpy(), one_cache["h"].numpy(),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="needs a cache"):
        TSSM.mamba2_block(tp, tc, x, mode="chunked_prefill")
    with pytest.raises(ValueError, match="needs a cache"):
        TM.forward({}, tc, torch.zeros(1, 4, dtype=torch.int32),
                   mode="chunked_prefill")


def test_mamba_layer_matches_jax(mixers):
    """The residual layer (norm, block, residual add) in bf16."""
    jc, tc, _, _ = mixers["bf16"]
    jl = jax.jit(lambda k: JM.init_mamba_layer(k, jc)[0])(
        jax.random.PRNGKey(4))
    pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), jl)
    tl = convert.from_jax_params({"mamba_stack": jax.tree.map(
        lambda a: a[None], pnp)}, tc.replace(n_layers=1),
        device="cpu")["mamba_stack"][0]
    jx, tx = _x(6, (2, 32, jc.d_model), "bf16")
    want, _ = jax.jit(lambda p, x: JM.apply_mamba_layer(
        p, jc, x, mode="prefill", cache=None))(jl, jx)
    got, _ = TM.apply_mamba_layer(tl, tc, tx, mode="prefill", cache=None)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, "bf16")
