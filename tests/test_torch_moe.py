"""The port's MoE module (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) at mixtral-8x22b's SMOKE size (d_model 64,
4 experts, top-2, expert d_ff 64), on the same numpy-seeded inputs.

Routing is compared exactly: the expert indices equal JAX's, also where two
experts tie for the k-th place (``torch.topk`` breaks such ties otherwise;
``jax.lax.top_k`` takes the lower index).  Dispatch and combine, fed the
JAX router's own indices and gates, equal JAX's buffer and output bit for
bit, at the SMOKE capacity and at one that drops entries.  The whole
layer's ``y``, ``aux`` and ``load``: float32 within 1e-4, bfloat16 within
``2^-6 · max|reference|`` (the tolerances of ``test_torch_llm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import moe as JMOE
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats  # noqa: F401

ARCH = "mixtral-8x22b"
F32_TOL = 1e-4
# a DeepSeek-style layer on mixtral's SMOKE widths: the sigmoid router with
# its balancing bias and routed_scale, and a shared expert
DEEPSEEK_MOE = {"n_experts": 4, "top_k": 2, "d_ff": 64, "first_dense": 0,
                "router_type": "sigmoid_topk", "capacity_factor": 2.0,
                "aux_weight": 0.0, "router_bias": True, "routed_scale": 2.5,
                "shared_expert": 1}
# the four tie patterns of router logits: the 2nd and 3rd largest equal
TIES = np.array([[0.1, 0.5, 0.3, 0.3], [0.3, 0.5, 0.3, 0.1],
                 [0.1, 0.3, 0.3, 0.5], [0.2, 0.3, 0.5, 0.3]], np.float32)


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


def configs(dtype, moe=None):
    jc, tc = j_get_smoke(ARCH), get_smoke(ARCH)
    if moe is not None:
        jc, tc = jc.replace(moe=moe), tc.replace(moe=moe)
    if dtype == "f32":
        jc = jc.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32)
        tc = tc.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    return jc, tc


_INIT = {}


def layer(dtype, moe=None, bias_seed=None):
    """(JAX config, port config, JAX params, port params) of one MoE layer
    from the JAX init (one per config, kept for the module);
    ``bias_seed`` draws ``e_bias`` away from zero."""
    jc, tc = configs(dtype, moe)
    key = (dtype, repr(sorted(jc.moe.items())))
    if key not in _INIT:
        _INIT[key] = JMOE.init_moe(jax.random.PRNGKey(1), jc)[0]
    jp = _INIT[key]
    if bias_seed is not None:
        draw = np.random.default_rng(bias_seed).normal(
            scale=0.3, size=jp["e_bias"].shape).astype(np.float32)
        jp = {**jp, "e_bias": jnp.asarray(draw)}
    pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = convert.from_jax_params({"moe": pnp}, tc, device="cpu")["moe"]
    return jc, tc, jp, tp


def inputs(seed, dtype, shape=(2, 32, 64)):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def test_init_moe_matches_jax_layout():
    """Shapes and dtypes leaf for leaf (``router`` and ``e_bias`` fp32 at
    bf16), and the router's leaves among ``layers.FP32_LEAVES``."""
    for moe in (None, DEEPSEEK_MOE):
        jc, tc = configs("bf16", moe)
        jp = jax.eval_shape(lambda k: JMOE.init_moe(k, jc)[0],
                            jax.random.PRNGKey(0))
        tp = TMOE.init_moe(torch.Generator().manual_seed(0), tc)
        assert convert._map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                            tp) == \
            jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    assert tp["router"].dtype == tp["e_bias"].dtype == torch.float32
    assert {"router", "e_bias"} <= set(TL.FP32_LEAVES)


@pytest.mark.parametrize("moe", [None, DEEPSEEK_MOE],
                         ids=["softmax_topk", "sigmoid_topk"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_route_matches_jax(moe, dtype):
    """Expert indices equal JAX's; gates, aux and load close (f32: load
    and aux exactly as JAX counts them)."""
    jc, tc, jp, tp = layer(dtype, moe, bias_seed=3 if moe else None)
    jx, tx = inputs(0, dtype)
    gates, idx, aux, load = jax.jit(
        lambda p, x: JMOE._route(p, jc, x))(jp, jx)
    tg, ti, taux, tload = TMOE._route(tp, tc, tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    assert tg.dtype == tx.dtype
    assert_close(tg, gates, dtype)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(load))
    np.testing.assert_allclose(float(taux), float(aux), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("moe", [None, DEEPSEEK_MOE],
                         ids=["softmax_topk", "sigmoid_topk"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_route_breaks_ties_as_jax(moe, dtype):
    """Router logits built to tie between the 2nd and 3rd expert (one-hot
    tokens picking the rows of ``TIES``): the port's experts are JAX's,
    the lower index, where ``torch.topk`` picks another."""
    jc, tc, jp, tp = layer(dtype, moe)
    router = np.zeros((64, 4), np.float32)
    router[:4] = TIES
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    if "e_bias" in jp:
        jp["e_bias"] = jnp.zeros_like(jp["e_bias"])
        tp["e_bias"] = torch.zeros_like(tp["e_bias"])
    x = np.zeros((1, 8, 64), np.float32)
    x[0, np.arange(8), np.arange(8) % 4] = 1.0
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    _, idx, _, _ = JMOE._route(jp, jc, jnp.asarray(x).astype(jdt))
    _, ti, _, _ = TMOE._route(tp, tc, torch.from_numpy(x).to(tdt))
    want = np.asarray(idx)
    np.testing.assert_array_equal(ti.numpy(), want)
    np.testing.assert_array_equal(want[0, :4], [[1, 2], [1, 0], [3, 1],
                                                [2, 1]])
    logits = (torch.from_numpy(x).to(tdt) @ tp["router"].to(tdt)).float()
    scores = (torch.sigmoid(logits) if moe else torch.softmax(logits, -1))
    assert (torch.topk(scores, 2).indices.numpy() != want).any()


def _jax_dispatch(x, idx, gates, e, cap):
    return jax.vmap(lambda xs, is_, gs: JMOE._dispatch_seq(xs, is_, gs, e,
                                                           cap))(x, idx,
                                                                 gates)


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dispatch_and_combine_bit_for_bit(dtype, cf):
    """On the JAX router's own indices and gates: the expert buffer, the
    kept entries and the combined output equal JAX's in every bit, at the
    SMOKE capacity factor 2.0 and at 0.5, which drops entries."""
    jc, tc, jp, tp = layer(dtype)
    jx, tx = inputs(1, dtype)
    b, s, _ = tx.shape
    e, k = jc.moe["n_experts"], jc.moe["top_k"]
    cap = int(max(1, round(s * k / e * cf)))
    gates, idx, _, _ = JMOE._route(jp, jc, jx)
    buf, meta = jax.jit(_jax_dispatch, static_argnums=(3, 4))(
        jx, idx, gates, e, cap)
    tg = torch.from_numpy(f32(gates)).to(tx.dtype)
    ti = torch.from_numpy(np.asarray(idx, np.int64))
    tbuf, tmeta = TMOE._dispatch(tx, ti, tg, e, cap)
    got = tbuf.view(e, b, cap, -1).permute(1, 0, 2, 3)
    np.testing.assert_array_equal(f32(got), f32(buf))
    keep = np.asarray(meta[4])
    np.testing.assert_array_equal(tmeta[3].numpy(), keep)
    assert (not keep.all()) == (cf < 1)

    y_buf = np.random.default_rng(2).normal(size=buf.shape).astype(
        np.float32)
    jyb = jnp.asarray(y_buf).astype(jx.dtype)
    want = jax.jit(jax.vmap(lambda yb, mt: JMOE._combine_seq(yb, mt, s)))(
        jyb, meta)
    tyb = torch.from_numpy(y_buf).to(tx.dtype).permute(1, 0, 2, 3)
    got = TMOE._combine(tyb.reshape(e, b * cap, -1), tmeta, b, s)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_moe_matches_jax(dtype, cf):
    """The whole layer: ``y``, ``aux`` and ``load``, with and without
    dropped entries."""
    moe = {**j_get_smoke(ARCH).moe, "capacity_factor": cf}
    jc, tc, jp, tp = layer(dtype, moe)
    jx, tx = inputs(2, dtype)
    y, aux, load = jax.jit(lambda p, x: JMOE.apply_moe(p, jc, x))(jp, jx)
    ty, taux, tload = TMOE.apply_moe(tp, tc, tx)
    assert ty.dtype == tx.dtype
    assert_close(ty, y, dtype)
    np.testing.assert_allclose(float(taux), float(aux), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(load))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shared_expert_routed_scale_and_router_bias(dtype):
    """The sigmoid router with a non-zero ``e_bias`` (it moves the choice,
    not the gates), ``routed_scale`` and the always-on shared expert."""
    jc, tc, jp, tp = layer(dtype, DEEPSEEK_MOE, bias_seed=4)
    jx, tx = inputs(3, dtype)
    y, aux, load = jax.jit(lambda p, x: JMOE.apply_moe(p, jc, x))(jp, jx)
    ty, taux, tload = TMOE.apply_moe(tp, tc, tx)
    assert_close(ty, y, dtype)
    assert float(taux) == float(aux) == 0.0
    np.testing.assert_array_equal(tload.numpy(), np.asarray(load))
    # the bias moves the choice of experts
    no_bias = {**tp, "e_bias": torch.zeros_like(tp["e_bias"])}
    assert not torch.equal(TMOE._route(no_bias, tc, tx)[1],
                           TMOE._route(tp, tc, tx)[1])


def test_update_router_bias_matches_jax():
    rng = np.random.default_rng(5)
    bias = rng.normal(size=8).astype(np.float32)
    load = rng.integers(0, 40, 8).astype(np.float32)
    load[3] = load.mean()                 # sign 0: that expert stays
    want = JMOE.update_router_bias(jnp.asarray(bias), jnp.asarray(load), 0.01)
    got = TMOE.update_router_bias(torch.from_numpy(bias),
                                  torch.from_numpy(load), 0.01)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_routing_log_records_each_call():
    """``routing_log`` gives one record per ``apply_moe`` call in its
    block (the experts, the entries dropped at capacity and routed), and
    nothing outside it."""
    jc, tc, jp, tp = layer("f32", {**j_get_smoke(ARCH).moe,
                                   "capacity_factor": 0.5})
    _, tx = inputs(6, "f32")
    no_drop = tc.replace(moe={**tc.moe, "capacity_factor": 4.0})
    with TMOE.routing_log() as log:
        TMOE.apply_moe(tp, tc, tx)
        TMOE.apply_moe(tp, no_drop, tx)
    TMOE.apply_moe(tp, tc, tx)
    assert len(log) == 2
    b, s, _ = tx.shape
    _, idx, _, _ = TMOE._route(tp, tc, tx)
    _, meta = TMOE._dispatch(tx, idx, idx.float(), 4, 8)
    assert [(int(r["dropped"]), r["routed"]) for r in log] == [
        (int((~meta[3]).sum()), b * s * 2), (0, b * s * 2)]
    assert int(log[0]["dropped"]) > 0
    for r in log:
        assert torch.equal(r["idx"], idx)
