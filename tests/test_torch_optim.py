"""The port's optimizer (``repro_torch.optim``) against the JAX package's
(``repro.optim``): ``tests/test_optim.py``'s six tests on the port, each
also held against the JAX package on the same inputs, plus ``adamw_update``
parity per moment policy, its sliced update of a large leaf, and the
int8 quantizer bit for bit.

Tolerances: the quantizer and the schedules are exact in both (the same
fp32 operations, round half to even); an AdamW step is held within 1e-6
of the JAX step relative to each leaf's largest value, its bf16 moments
within one bf16 ulp (2^-7 relative) and its int8 moment within one quantization step
of its block (an ulp of difference in m may round q the other way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import cosine_schedule as j_cosine
from repro.optim import dequantize_q8 as j_dequantize_q8
from repro.optim import quantize_q8 as j_quantize_q8
from repro.optim import wsd_schedule as j_wsd
from repro_torch.optim import (adamw, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               dequantize_q8, make_schedule, quantize_q8,
                               wsd_schedule)

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats  # noqa: F401


def _problem(seed=0, n=64):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(n,))
    x = torch.from_numpy(rng.normal(size=(256, n)))
    y = x @ torch.from_numpy(w_true)
    params = {"w": torch.zeros((n,), dtype=torch.float32)}

    def grads_of(p):
        w = p["w"].detach().double().requires_grad_(True)
        loss = torch.mean((x @ w - y) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        return {"w": g.float()}, float(loss.detach())

    return params, grads_of


@pytest.mark.parametrize("policy", ["fp32", "bf16", "q8"])
def test_adamw_converges(policy):
    params, grads_of = _problem()
    state = adamw_init(params, state_policy=policy)
    _, l0 = grads_of(params)
    for _ in range(60):
        grads, _ = grads_of(params)
        params, state = adamw_update(grads, state, params, lr=5e-2,
                                     weight_decay=0.0, state_policy=policy)
    _, l1 = grads_of(params)
    assert l1 < 0.05 * l0, (policy, l0, l1)


def test_quantized_policies_track_fp32():
    """bf16/q8 moment storage stays close to the fp32 trajectory (the
    JAX test's bounds)."""
    trajs = {}
    for policy in ["fp32", "bf16", "q8"]:
        params, grads_of = _problem(seed=3)
        state = adamw_init(params, state_policy=policy)
        for _ in range(20):
            grads, _ = grads_of(params)
            params, state = adamw_update(grads, state, params, lr=1e-2,
                                         weight_decay=0.01,
                                         state_policy=policy)
        trajs[policy] = params["w"].numpy()
    ref = trajs["fp32"]
    assert np.linalg.norm(trajs["bf16"] - ref) / np.linalg.norm(ref) < 0.05
    assert np.linalg.norm(trajs["q8"] - ref) / np.linalg.norm(ref) < 0.25


@pytest.mark.parametrize("shape", [(7,), (13, 300), (3, 5, 257), (2, 256)])
def test_q8_roundtrip(shape):
    """Shape-preserving, within one step of each block's scale, and bit
    for bit the JAX package's ``q``, ``s`` and dequantized values (ties
    included: values on a half step round to even in both)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 10
    x.reshape(-1)[:4] = [0.5, 1.5, -2.5, 0.0]     # exact ties after scaling
    packed = quantize_q8(torch.from_numpy(x))
    assert packed["q"].shape == x.shape and packed["q"].dtype == torch.int8
    back = dequantize_q8(packed, x.shape)
    assert np.abs(back.numpy() - x).max() <= np.abs(x).max() / 127 + 1e-6
    want = j_quantize_q8(jnp.asarray(x))
    np.testing.assert_array_equal(packed["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(packed["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_dequantize_q8(want, x.shape)))


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, gn = clip_by_global_norm(grads, 1.0)
    assert np.isclose(float(gn), 10.0)
    total = np.sqrt(sum(float((x ** 2).sum()) for x in clipped.values()))
    assert np.isclose(total, 1.0, rtol=1e-5)
    rng = np.random.default_rng(2)
    raw = {"a": rng.normal(size=(5, 3)).astype(np.float32),
           "b": [{"c": rng.normal(size=(7,)).astype(np.float32)}]}
    for max_norm in (0.5, 100.0):
        got, gn = clip_by_global_norm(
            {"a": torch.from_numpy(raw["a"].copy()),
             "b": [{"c": torch.from_numpy(raw["b"][0]["c"].copy())}]},
            max_norm)
        want, jgn = j_clip({"a": jnp.asarray(raw["a"]),
                            "b": [{"c": jnp.asarray(raw["b"][0]["c"])}]},
                           max_norm)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["b"][0]["c"].numpy(),
                                   np.asarray(want["b"][0]["c"]), rtol=1e-6)


def test_wsd_schedule_shape():
    """Warmup-Stable-Decay (MiniCPM): flat stable phase, sharp tail; both
    schedules equal the JAX package's at every step."""
    kw = dict(peak_lr=1.0, warmup=10, total=100, decay_frac=0.2)
    lrs = np.asarray([float(wsd_schedule(t, **kw)) for t in range(101)])
    assert lrs[0] == 0.0 and lrs[9] < 1.0
    np.testing.assert_allclose(lrs[10:80], 1.0)
    assert lrs[85] < 1.0 and lrs[100] <= 0.02
    cos = np.asarray([float(cosine_schedule(t, peak_lr=1.0, warmup=10,
                                            total=100)) for t in range(101)])
    assert cos[55] < 1.0 and lrs[55] == 1.0
    steps = np.arange(101, dtype=np.float32)
    np.testing.assert_allclose(lrs, np.asarray(j_wsd(steps, **kw)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        cos, np.asarray(j_cosine(steps, peak_lr=1.0, warmup=10, total=100)),
        rtol=1e-6, atol=1e-7)
    sched = make_schedule("cosine", peak_lr=2.0, warmup=5, total=50)
    assert float(sched(5)) == 2.0


def test_adamw_matches_reference_manual():
    """One step vs hand-computed AdamW."""
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    st = adamw_init(p)
    p2, st2 = adamw_update(g, st, p, lr=0.1, b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=0.0)
    m = 0.1 * 0.5
    v = 0.001 * 0.25
    step = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.999)) + 1e-8)
    want = np.asarray([1.0, -2.0]) - 0.1 * step
    np.testing.assert_allclose(p2["w"].numpy(), want, rtol=1e-5)
    assert int(st2["count"]) == 1


# -- adamw_update against the JAX package ----------------------------------------

def _leaves(seed):
    """Parameters and gradients of a few shapes (a last axis that 128 does
    not divide, a 3-D stack, a bf16 leaf), as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (300,), "b": (6, 200), "c": (2, 3, 130), "d": (4, 256)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
          for k, s in shapes.items()} for _ in range(3)]
    return p, g


def _to_torch(tree, bf16=("d",)):
    return {k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if k in bf16 else torch.float32) for k, v in tree.items()}


def _to_jax(tree, bf16=("d",)):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("policy", ["fp32", "bf16", "q8"])
def test_adamw_update_matches_jax(policy):
    """Three steps from zero state on the same gradients: parameters (fp32
    and bf16 leaves) and moments as the module docstring bounds them."""
    p_np, gs = _leaves(4)
    tp, jp = _to_torch(p_np), _to_jax(p_np)
    ts = adamw_init(tp, state_policy=policy)
    js = j_adamw_init(jp, state_policy=policy)
    kw = dict(lr=1e-2, b1=0.9, b2=0.95, weight_decay=0.1,
              state_policy=policy)
    for g in gs:
        tp, ts = adamw_update(_to_torch(g), ts, tp, **kw)
        jp, js = j_adamw_update(_to_jax(g), js, jp, **kw)
    for k in p_np:
        want = np.asarray(jp[k], np.float32)
        got = tp[k].float().numpy()
        if k == "d":          # bf16: within one rounding of the JAX value
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    for which in ("m", "v"):
        mpol = adamw.policies(policy)[0 if which == "m" else 1]
        for k in p_np:
            got, want = ts[which][k], js[which][k]
            if mpol == "q8":
                gd = dequantize_q8(got, p_np[k].shape).numpy()
                wd = np.asarray(j_dequantize_q8(want, p_np[k].shape))
                step = np.repeat(np.asarray(want["s"]), 128,
                                 axis=-1)[..., :p_np[k].shape[-1]]
                assert (np.abs(gd - wd) <= 1.001 * step).all(), (which, k)
            elif mpol == "bf16":
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(want, np.float32),
                                           rtol=2 ** -7, atol=1e-30)
            else:
                w = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                           atol=1e-6 * np.abs(w).max())
    assert int(ts["count"]) == int(js["count"]) == 3


@pytest.mark.parametrize("policy", ["fp32", "q8"])
def test_adamw_sliced_update_equals_whole(monkeypatch, policy):
    """A leaf above CHUNK_ELEMS is updated in slices of its leading axis:
    the same parameters and moments, bit for bit, as one whole update."""
    p_np, gs = _leaves(5)
    out = {}
    for chunk in (adamw.CHUNK_ELEMS, 500):
        monkeypatch.setattr(adamw, "CHUNK_ELEMS", chunk)
        tp = _to_torch(p_np)
        ts = adamw_init(tp, state_policy=policy)
        for g in gs:
            tp, ts = adamw_update(_to_torch(g), ts, tp, lr=1e-2,
                                  state_policy=policy)
        out[chunk] = (tp, ts)
    assert len(adamw._slices(torch.zeros(6, 200))) == 3    # rows of 2
    (pa, sa), (pb, sb) = out.values()
    for k in p_np:
        assert torch.equal(pa[k], pb[k])
        for which in ("m", "v"):
            a, b = sa[which][k], sb[which][k]
            if isinstance(a, dict):
                assert torch.equal(a["q"], b["q"]) and torch.equal(a["s"],
                                                                   b["s"])
            else:
                assert torch.equal(a, b)
