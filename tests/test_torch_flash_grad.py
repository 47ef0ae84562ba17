"""The flash-attention backward: its plain version against the JAX package
and torch autograd on the CPU, and the kernels on the card.

CPU: ``flash_attention_bwd_ref`` (dq, dk and dv written out explicitly)
against ``jax.vjp`` of the JAX ``kernels/flash_attention/ref.py`` and
against torch autograd of the port's ``flash_attention_ref``, on the same
numpy-seeded inputs and output gradient, in float32 within 1e-5 (the
three compute the same sums in other orders), at small widths: GQA, causal,
a sliding window, ``q_off``, non-causal with Sk not a multiple of any tile,
and MLA's q/k head dim apart from v's.  On the CPU ``"auto"`` takes the
plain route, which autograd differentiates.

Card (``cuda``-marked; JAX is imported only by the CPU tests, so these run
where it is not installed):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_flash_grad.py

the forward kernels' ``lse`` output, ``flash_attention_bwd_cuda`` against
``flash_attention_bwd_ref`` (fp32 on the CUDA-core kernel within a relative
L2 of 2^-14, summation order only; bf16 on the wgmma kernel within 2^-6:
P and dS rounded to bf16 before the products, each gradient's rounding,
delta taken from the bf16-rounded O), each launch counted under its
dtype's key and none under the other's, the bf16 kernel's tile edges
(ragged Sq and Sk, key tiles no query sees, GQA 16, D 16 to 112 inside
their instances, a window edge inside a tile, MLA's (192, 128) ragged at
``q_off``), a refused bf16 launch that raises and launches nothing else,
and that gradients on the kernel route exist and come from the backward
kernel (a fault the kernel route once had: the forward's output had no
autograd history, so q/k/v got no gradient).  On the CPU, a torch model of the bf16
kernel's arithmetic holds within the same 2^-6 of the fp32 plain backward,
and the backward's route follows the dtype.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

from _torch_helpers import _reset_port_stats  # noqa: F401

F32_TOL = 1e-5

# b, h, kv, sq, sk, d, dv, causal, window, q_off
CPU_CASES = {
    "gqa_causal": (2, 4, 2, 48, 48, 16, 16, True, None, 0),
    "window": (1, 4, 1, 40, 40, 16, 16, True, 8, 0),
    "q_off": (2, 4, 2, 16, 48, 16, 16, True, None, 32),
    "noncausal_ragged": (2, 2, 2, 33, 70, 16, 16, False, None, 0),
    "mla_head_dims": (1, 4, 4, 24, 24, 24, 16, True, None, 0),
}


def _rel(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp_min(1e-30))


def _inputs(case, seed=0):
    b, h, kv, sq, sk, d, dv, *_ = case
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, dv),
                          (b, h, sq, dv))]


def _masks(case):
    return dict(causal=case[7], window=case[8], q_off=case[9])


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import flash_attention_ref as jref
    case = CPU_CASES[name]
    q, k, v, do = (jnp.asarray(x) for x in _inputs(case))
    grads = jax.jit(lambda a, b, c, g: jax.vjp(
        lambda x, y, z: jref(x, y, z, **_masks(case)), a, b, c)[1](g))
    return tuple(np.asarray(g) for g in grads(q, k, v, do))


@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_bwd_ref_matches_jax_grad(name):
    case = CPU_CASES[name]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case))
    got = flash_attention_bwd_ref(q, k, v, do, **_masks(case))
    for g, w, what in zip(got, _jax_grads(name), ("dq", "dk", "dv")):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)


@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_bwd_ref_matches_autograd_of_the_plain_forward(name):
    case = CPU_CASES[name]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_ref(*leaves, **_masks(case))
    want = torch.autograd.grad(out, leaves, do)
    got = flash_attention_bwd_ref(q, k, v, do, **_masks(case))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL)


def test_auto_route_on_cpu_is_differentiated_by_autograd():
    """``flash_attention(impl="auto")`` on CPU tensors is the plain version:
    its q/k/v gradients are autograd's, equal to the plain backward's, and
    no kernel counts a launch."""
    case = CPU_CASES["gqa_causal"]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case, seed=1))
    leaves = [t.transpose(1, 2).clone().requires_grad_(True)
              for t in (q, k, v)]
    reset_launch_counts()
    out = fa_ops.flash_attention(*leaves, causal=True, impl="auto")
    grads = torch.autograd.grad(out, leaves, do.transpose(1, 2))
    want = flash_attention_bwd_ref(q, k, v, do, causal=True)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.transpose(1, 2), w, rtol=F32_TOL,
                                   atol=F32_TOL)
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


def test_bwd_kernel_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_ops.flash_attention_bwd_cuda(q, q, q, q, q, lse)


def _wgmma_bwd_arithmetic(q, k, v, do, *, causal=True, drop_delta=False):
    """The bf16 wgmma backward's arithmetic in torch, from bf16 inputs: O
    and lse from the fp32 plain forward, O rounded to bf16 (the forward
    kernel's output); delta = rowsum(dO ∘ O) and the scores in fp32; P =
    2^(S·scale·log2 e − lse·log2 e), masked entries 0, rounded to bf16;
    dS = P ∘ (dP − delta) from the rounded P, rounded to bf16; the five
    products accumulate in fp32 and each gradient is rounded once.
    ``drop_delta`` breaks it: dS = P ∘ dP."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    kk, vv = (x.repeat_interleave(g, 1) for x in (kf, vf))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk)
    mask = torch.ones((sq, k.shape[2]), dtype=torch.bool)
    if causal:
        mask = torch.arange(k.shape[2])[None, :] <= torch.arange(sq)[:, None]
    lse = torch.logsumexp((s * scale).masked_fill(~mask, float("-inf")), -1)
    o = flash_attention_ref(qf, kf, vf, causal=causal).bfloat16().float()
    delta = (dof * o).sum(-1, keepdim=True)
    c = scale * math.log2(math.e)
    p = torch.exp2(s * c - lse[..., None] * math.log2(math.e))
    p = p.masked_fill(~mask, 0.0).bfloat16().float()
    dp = torch.einsum("bhqe,bhke->bhqk", dof, vv)
    ds = (p * (dp if drop_delta else dp - delta)).bfloat16().float()
    dv_h = torch.einsum("bhqk,bhqe->bhke", p, dof)
    dk_h = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    kv = k.shape[1]
    dk = dk_h.reshape(b, kv, g, *dk_h.shape[2:]).sum(2)
    dv = dv_h.reshape(b, kv, g, *dv_h.shape[2:]).sum(2)
    return tuple(x.bfloat16() for x in (dq, dk, dv))


def test_bf16_bound_holds_for_the_wgmma_kernels_arithmetic():
    """BWD_REL_L2's bf16 bound holds for the wgmma backward's arithmetic
    (bf16 P and dS as the products' operands, fp32 accumulation) against
    the fp32 plain backward of the same bf16 inputs, at a small GQA causal
    shape with unit-RMS q and k (as after the qk-norm); a kernel that drops
    delta from dS breaks it."""
    gen = torch.Generator().manual_seed(0)

    def unit(x):
        return (x / x.pow(2).mean(-1, keepdim=True).sqrt()).bfloat16()
    q = unit(torch.randn((2, 4, 192, 64), generator=gen))
    k = unit(torch.randn((2, 2, 192, 64), generator=gen))
    v, do = (torch.randn(shape, generator=gen).bfloat16()
             for shape in ((2, 2, 192, 64), (2, 4, 192, 64)))
    want = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, do)),
                                   causal=True)
    got = _wgmma_bwd_arithmetic(q, k, v, do)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert _rel(g, w) <= BWD_REL_L2[torch.bfloat16], what
    bad = _wgmma_bwd_arithmetic(q, k, v, do, drop_delta=True)
    assert _rel(bad[0], want[0]) > BWD_REL_L2[torch.bfloat16]


def test_bwd_group_split():
    """The bf16 backward splits a GQA group over blocks only where its
    blocks fall under two waves, into splits of at least one head: none at
    qwen3-1.7b's or mixtral's train shape, 3 at chatglm3-6b's (16 heads a
    kv head, 128 blocks), 2 at starcoder2-7b's; never for MHA."""
    split = fa_ops.bwd_group_split
    assert split(4, 8, 2, 2048, 132) == 1              # qwen3-1.7b
    assert split(2, 8, 6, 6144, 132) == 1              # mixtral-8x22b
    assert split(4, 2, 16, 2048, 132) == 3             # chatglm3-6b
    assert split(4, 4, 9, 2048, 132) == 2              # starcoder2-7b
    assert split(2, 128, 1, 4096, 132) == 1            # deepseek-v3 (MHA)
    for group in range(1, 33):
        for sk in (64, 130, 1000):
            n = split(1, 1, group, sk, 132)
            per = -(-group // n)
            assert 1 <= n <= group and (n - 1) * per < group <= n * per


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "flash_attention_bwd_wgmma"),
    (torch.float32, "flash_attention_bwd")])
def test_bwd_route_is_chosen_by_dtype(monkeypatch, dtype, route):
    """bf16 launches the wgmma backward and fp32 the CUDA-core one, by
    dtype alone; a launch that fails raises, with no second launch on the
    other kernel."""
    from repro_torch.kernels import cuda_lib
    calls = []

    def failing_launch(kernel, *args):
        calls.append(kernel)
        raise RuntimeError(f"{kernel} launch failed")
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *t: None)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda d: 132)
    monkeypatch.setattr(cuda_lib, "launch", failing_launch)
    q = torch.zeros(1, 2, 32, 16, dtype=dtype)
    lse = torch.zeros(1, 2, 32)
    assert fa_ops.bwd_kernel_route(dtype) == route
    with pytest.raises(RuntimeError, match=route):
        fa_ops.flash_attention_bwd_cuda(q, q, q, q, q, lse)
    assert calls == [route]
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fa_ops.bwd_kernel_route(torch.float16)


# -- the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


# the bound of each dtype on the relative L2 error of dq, dk and dv against
# the plain backward (fp32 from the same inputs): fp32 differs by summation
# order; bf16 by the roundings of P and of dS to bf16 before the products
# (2^-9 relative each; dS from the rounded P), one rounding of each gradient
# (2^-9) and delta taken from the bf16-rounded O (P rounded before P·V in
# the forward)
BWD_REL_L2 = {torch.float32: 2 ** -14, torch.bfloat16: 2 ** -6}

CARD_CASES = [
    # b, h, kv, sq, sk, d, dv, causal, window, q_off
    (2, 4, 2, 256, 256, 64, 64, True, None, 0),
    (1, 4, 4, 512, 512, 32, 32, True, 128, 0),       # D 32 in the 64 instance
    (2, 2, 1, 256, 512, 64, 64, False, None, 0),
    (2, 4, 2, 100, 300, 48, 48, True, None, 200),    # ragged, q_off > 0
    (1, 6, 3, 70, 70, 16, 16, True, 33, 0),          # ragged, window
    (2, 4, 2, 300, 300, 128, 128, True, None, 0),    # not multiples of 64
    (1, 4, 4, 257, 257, 80, 80, True, 100, 0),       # D 80 in the 128 instance
    (2, 8, 2, 192, 640, 128, 128, True, None, 448),  # q_off, Sq < Sk
    (1, 2, 1, 400, 100, 64, 64, False, 16, 0),       # q tiles with no key
    (1, 8, 8, 256, 256, 112, 112, True, None, 0),    # D 112 (zamba2-7b)
    (1, 32, 2, 256, 256, 128, 128, True, None, 0),   # GQA 16 (chatglm3-6b)
    (1, 12, 2, 1536, 1536, 128, 128, True, 1024, 0),  # GQA 6, window 1024
    (1, 4, 4, 1500, 1500, 64, 64, False, None, 0),   # whisper: 1500 frames
    (2, 4, 4, 512, 1500, 64, 64, False, None, 0),    # whisper: cross
    (2, 4, 4, 256, 256, 192, 128, True, None, 0),    # MLA (192, 128)
    (1, 4, 4, 200, 333, 192, 128, True, None, 133),  # MLA, ragged, q_off
]


def _card_inputs(case, dtype, card, seed):
    b, h, kv, sq, sk, d, dv, *_ = case
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(card, dtype)
            for shape in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, dv),
                          (b, h, sq, dv))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_bwd_kernel(card, case, dtype):
    c = CARD_CASES[case]
    b, h, _, sq, _, _, dv = c[:7]
    masks = dict(causal=c[7], window=c[8], q_off=c[9])
    if c[5] == 192:
        masks["sm_scale"] = 192 ** -0.5
    q, k, v, do = _card_inputs(c, dtype, card, case)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=card)
    o = fa_ops.flash_attention_cuda(q, k, v, lse=lse, **masks)
    reset_launch_counts()
    got = fa_ops.flash_attention_bwd_cuda(q, k, v, o, do, lse, **masks)
    torch.cuda.synchronize()
    route = fa_ops.bwd_kernel_route(dtype)
    assert route == {torch.bfloat16: "flash_attention_bwd_wgmma",
                     torch.float32: "flash_attention_bwd"}[dtype]
    assert LAUNCHES[route] == 1
    assert all(n == 0 for key, n in LAUNCHES.items() if key != route), LAUNCHES
    want = flash_attention_bwd_ref(q, k, v, do, **masks)
    for g, w, t, what in zip(got, want, (q, k, v), ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == t.shape, what
        assert bool(torch.isfinite(g).all()), what
        rel = _rel(g, w)
        assert rel <= BWD_REL_L2[dtype], (what, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [0, 3, 8, 14])
def test_forward_lse(card, case, dtype):
    """The forward kernels' lse: each row's log-sum-exp of its visible
    scaled scores (fp32 within 1e-4; bf16 within 2^-7 of the fp32 scores
    of the same bf16 inputs), +inf where a row sees no key; the output is
    the same with and without it."""
    c = CARD_CASES[case]
    b, h, kv, sq, sk, d = c[:6]
    masks = dict(causal=c[7], window=c[8], q_off=c[9])
    q, k, v, _ = _card_inputs(c, dtype, card, case)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=card)
    o = fa_ops.flash_attention_cuda(q, k, v, lse=lse, **masks)
    assert torch.equal(o, fa_ops.flash_attention_cuda(q, k, v, **masks))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(h // kv, dim=1)) / d ** 0.5
    qpos = c[9] + torch.arange(sq, device=card)[:, None]
    kpos = torch.arange(sk, device=card)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=card)
    if c[7]:
        mask &= kpos <= qpos
    if c[8] is not None:
        mask &= (qpos - kpos) < c[8]
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    empty = torch.isinf(want)
    assert bool(torch.isposinf(lse[empty]).all())
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    assert float((lse[~empty] - want[~empty]).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_route_gradients_exist(card, dtype):
    """The fault this slice repairs: on the kernel route the attention
    output must carry autograd history, so q, k and v get gradients, from
    one forward and one backward launch, equal (within the dtype's bound)
    to the plain route's gradients of the same loss."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(shape, generator=gen).to(card, dtype)
               for shape in ((2, 192, 8, 64), (2, 192, 2, 64),
                             (2, 192, 2, 64)))
    w = torch.randn((2, 192, 8, 64), generator=gen).to(card, dtype)
    grads = {}
    for impl in ("cuda", "ref"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        reset_launch_counts()
        out = fa_ops.flash_attention(*leaves, causal=True, impl=impl)
        (out.float() * w.float()).sum().backward()
        grads[impl] = [t.grad for t in leaves]
        want = 1 if impl == "cuda" else 0
        assert LAUNCHES[fa_ops.kernel_route(dtype)] == want
        assert LAUNCHES[fa_ops.bwd_kernel_route(dtype)] == want
    # bf16: the plain route's own backward rounds in other places too
    tol = BWD_REL_L2[dtype] if dtype == torch.float32 else 2 ** -5
    for g, r in zip(grads["cuda"], grads["ref"]):
        assert g is not None and g.shape == r.shape
        assert float(g.float().abs().max()) > 0
        assert _rel(g, r) <= tol


@pytest.mark.cuda
def test_model_loss_gradients_on_the_kernel_route(card):
    """The SMOKE qwen3 ``lm_loss`` on the card: every layer's attention
    takes the kernel forward and backward (remat "full": the forward again
    in each layer's recompute), and its gradients match the plain route's
    within bf16 rounding (relative L2 2^-4 over all leaves)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as TM
    from repro_torch.optim import tree_leaves
    cfg = get_smoke("qwen3-1.7b")
    params = TM.init(TM.make_generator(0, card), cfg)
    gen = torch.Generator(device=card).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 65), device=card, generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    reset_launch_counts()
    loss, _, grads = TS.loss_and_grads(params, cfg, batch)
    n = cfg.n_layers
    assert LAUNCHES["flash_attention_wgmma"] == 2 * n
    assert LAUNCHES["flash_attention_bwd_wgmma"] == n
    assert LAUNCHES["flash_attention_bwd"] == 0
    ref_loss, _, ref_grads = TS.loss_and_grads(
        params, cfg.replace(attn_impl="ref"), batch)
    assert abs(float(loss) - float(ref_loss)) <= 2 ** -7 * abs(float(ref_loss))
    got = torch.cat([g.float().flatten() for g in tree_leaves(grads)])
    want = torch.cat([g.float().flatten() for g in tree_leaves(ref_grads)])
    assert _rel(got, want) <= 2 ** -4
    for layer in grads["dense_stack"]:
        for name in ("wq", "wk", "wv"):
            assert float(layer["attn"][name]["w"].float().abs().max()) > 0


# the bf16 kernel's tile edges: b, h, kv, sq, sk, d, dv, causal, window,
# q_off, and the keys from which no query sees a key (dk, dv exactly 0)
EDGE_CASES = [
    ((1, 2, 1, 190, 333, 16, 16, True, None, 143), None),  # ragged, D 16
    ((2, 4, 2, 77, 200, 48, 48, False, None, 0), None),    # ragged, D 48
    ((1, 32, 2, 130, 130, 80, 80, True, None, 0), None),   # GQA 16, D 80
    ((1, 4, 4, 300, 300, 112, 112, True, 70, 0), None),    # window edge in a tile
    ((1, 2, 1, 64, 400, 64, 64, True, None, 0), 64),       # key tiles no query sees
    ((2, 4, 4, 150, 270, 192, 128, True, None, 120), None),  # MLA ragged, q_off
]


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["auto", "whole"])
@pytest.mark.parametrize("case", range(len(EDGE_CASES)))
def test_bwd_wgmma_tile_edges(card, case, split, monkeypatch):
    """The bf16 wgmma backward where its 128-key and 64-query tiles are cut:
    within BWD_REL_L2 of the plain backward, one launch counted, and dk and
    dv exactly 0 on keys that no query sees; with each GQA group split over
    blocks as ``bwd_group_split`` says for these small grids, and whole."""
    if split == "whole":
        monkeypatch.setattr(fa_ops, "bwd_group_split", lambda *a: 1)
    c, unseen = EDGE_CASES[case]
    b, h, _, sq = c[:4]
    masks = dict(causal=c[7], window=c[8], q_off=c[9])
    if c[5] == 192:
        masks["sm_scale"] = 192 ** -0.5
    q, k, v, do = _card_inputs(c, torch.bfloat16, card, 100 + case)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=card)
    o = fa_ops.flash_attention_cuda(q, k, v, lse=lse, **masks)
    reset_launch_counts()
    got = fa_ops.flash_attention_bwd_cuda(q, k, v, o, do, lse, **masks)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd_wgmma"] == 1
    assert LAUNCHES["flash_attention_bwd"] == 0
    want = flash_attention_bwd_ref(q, k, v, do, **masks)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(g).all()), what
        assert _rel(g, w) <= BWD_REL_L2[torch.bfloat16], what
    if unseen is not None:
        for g, what in zip(got[1:], ("dk", "dv")):
            assert bool((g[:, :, unseen:] == 0).all()), what
            assert float(g[:, :, :unseen].float().abs().max()) > 0, what


@pytest.mark.cuda
def test_bwd_wgmma_refused_launch_raises(card, monkeypatch):
    """A bf16 launch that the kernel's C entry refuses (here a head dim of
    8, let past the wrapper's check) raises, and nothing else launches: not
    the fp32 kernel, not the plain version."""
    monkeypatch.setattr(fa_ops, "head_dims", lambda d, dv: (64, 64))
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(shape, generator=gen).to(card, torch.bfloat16)
                   for shape in ((1, 2, 64, 8), (1, 1, 64, 8), (1, 1, 64, 8),
                                 (1, 2, 64, 8)))
    lse = torch.zeros((1, 2, 64), dtype=torch.float32, device=card)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_attention_bwd_wgmma launch "
                                           "failed"):
        fa_ops.flash_attention_bwd_cuda(q, k, v, q, do, lse)
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES
