"""Module step 9e on the CPU: the port's training against the JAX package.

Covered: for every arch's SMOKE config in float32, ``lm_loss`` (its value
and metrics) and the gradient of every parameter leaf against
``jax.value_and_grad(repro.models.model.lm_loss)`` on the same parameters
(the JAX init, carried across by ``convert.from_jax_params``) and the same
numpy-seeded batch: deepseek-v3 with its MTP loss, whisper with frame
embeddings, mixtral past its 64-token window, and one case with a
``loss_mask``; ``remat`` "full" and "none" giving the same gradients;
``cross_entropy``; ``TrainOptions``, ``default_train_options``,
``est_param_count`` and ``auto_microbatch`` against the JAX package's;
and one ``make_train_step`` step under each moment policy (fp32, bf16,
q8) and with ``microbatch=2`` against the JAX ``make_train_step`` from one
state: the JAX package takes a first step, its parameters and AdamW state
cross over through ``convert.from_jax_params``/``from_jax_opt_state``,
and both packages take the second step on the next batch.

Tolerances.  Loss and gradients: float32 sums in other orders, so each
leaf within ``1e-4 · max |leaf's JAX gradient|`` plus 1e-6 (the keys'
biases of whisper have a gradient of 0 in exact arithmetic, softmax being
blind to a shift common to a row, and both packages give rounding noise of
1e-8 there).  The train step: parameters within 1e-3 of the learning rate
(an AdamW step moves each by at most about lr); fp32 moments within 1e-5
of each leaf's largest; a bf16 moment within that plus one bf16 ulp
(2^-7 relative: the two fp32 moments may round to neighbouring bf16
values); an int8 moment within one quantization step of
its block (a last-ulp difference in m may round q the other way).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import mesh as j_mesh
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw_init as j_adamw_init
from repro_torch import convert
from repro_torch.configs import PORTED, get_config, get_smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import dequantize_q8, tree_leaves

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, warm_jax  # noqa: F401
from _torch_helpers import jax_init_f32

B = 2
SEQ = {"mixtral-8x22b": 96}    # past its SMOKE window of 64; the rest 64
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LR = TS.TrainOptions().peak_lr


def _configs(arch, remat="none"):
    jc = j_get_smoke(arch).replace(param_dtype=jnp.float32,
                                   compute_dtype=jnp.float32, remat=remat)
    tc = get_smoke(arch).replace(param_dtype=torch.float32,
                                 compute_dtype=torch.float32, remat=remat)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jc, _ = _configs(arch)
    return jax_init_f32(jc)


def _port_params(arch):
    _, tc = _configs(arch)
    pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), _jax_params(arch))
    return convert.from_jax_params(pnp, tc, device="cpu")


def _batch(arch, seed=0, b=B, masked=False):
    cfg = get_smoke(arch)
    s = SEQ.get(arch, 64)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec:
        out["enc_inputs"] = rng.normal(
            size=(b, cfg.encdec["enc_frames"], cfg.d_model)).astype(np.float32)
    if masked:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    jc, _ = _configs(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: JM.lm_loss(p, jc, b), has_aux=True))


CASES = [(arch, False) for arch in PORTED] + [("qwen3-1.7b", True)]


def _jax_loss_grads(arch, masked):
    batch = {k: jnp.asarray(v) for k, v in _batch(arch, masked=masked).items()}
    return _jax_value_and_grad(arch)(_jax_params(arch), batch)


@pytest.fixture(scope="module")
def _jax_programs_compiled():
    """Every case's JAX value-and-grad program, compiled on four threads."""
    warm_jax([functools.partial(_jax_loss_grads, arch, masked)
              for arch, masked in CASES])


def _assert_grads_close(got_np, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got_np
        for key in path:
            g = g[key.key]
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rtol * float(np.abs(w).max()) + atol,
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch,masked", CASES,
                         ids=[a + ("-loss_mask" if m else "") for a, m in CASES])
def test_lm_loss_and_grads_match_jax(arch, masked, _jax_programs_compiled):
    (j_loss, j_metrics), j_grads = _jax_loss_grads(arch, masked)
    _, tc = _configs(arch)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(arch, masked=masked).items()}
    loss, metrics, grads = TS.loss_and_grads(_port_params(arch), tc, batch)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=GRAD_RTOL)
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    if arch == "deepseek-v3-671b":
        assert "mtp" in metrics and float(metrics["mtp"]) > 0
    _assert_grads_close(convert.to_numpy_params(grads), j_grads)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-7b", "mixtral-8x22b",
                                  "whisper-medium"])
def test_remat_full_and_none_give_the_same_gradients(arch):
    """Checkpointed layers and loss chunks recompute the same forward: the
    gradients equal those of the plain backward."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch, seed=3).items()}
    got = {}
    for remat in ("full", "none"):
        _, tc = _configs(arch, remat=remat)
        loss, _, grads = TS.loss_and_grads(_port_params(arch), tc, batch)
        got[remat] = (loss, tree_leaves(grads))
    assert float(got["full"][0]) == float(got["none"][0])
    for a, b in zip(got["full"][1], got["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.5).astype(np.float32)
    for m in (None, mask):
        want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        got = TL.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_options_match_jax():
    """The same fields and defaults; the same size-adaptive policy and
    closed-form parameter estimate for every ported config at full size."""
    jf = {f.name: f.default for f in
          dataclasses.fields(JS.TrainOptions)}
    tf = {f.name: f.default for f in
          dataclasses.fields(TS.TrainOptions)}
    assert jf == tf
    from repro.configs import get_config as j_get_config
    for arch in PORTED:
        assert TS.est_param_count(get_config(arch)) == \
            JS.est_param_count(j_get_config(arch)), arch
        assert dataclasses.asdict(TS.default_train_options(
            get_config(arch))) == dataclasses.asdict(
                JS.default_train_options(j_get_config(arch))), arch
    assert TS.default_train_options(get_config("deepseek-v3-671b")) \
        .opt_state_policy == "q8"


@pytest.mark.parametrize("batch,seq,budget", [(256, 4096, 4e9),
                                              (32, 2048, 4e9), (8, 512, 1e6),
                                              (6, 1024, 1e5)])
def test_auto_microbatch_matches_jax_on_one_device(batch, seq, budget):
    mesh = j_mesh.make_host_mesh(1, 1)
    from repro.configs import get_config as j_get_config
    for arch in ("qwen3-1.7b", "zamba2-7b", "deepseek-v3-671b"):
        want = JS.auto_microbatch(j_get_config(arch),
                                  JShapeSpec("t", "train", seq, batch), mesh,
                                  residual_budget=budget)
        got = TS.auto_microbatch(get_config(arch),
                                 ShapeSpec("t", "train", seq, batch),
                                 residual_budget=budget)
        assert got == want, (arch, got, want)


# -- one train step against JAX's, from one state --------------------------------

STEP_CASES = {"fp32": ("fp32", 0), "bf16": ("bf16", 0), "q8": ("q8", 0),
              "microbatch2": ("fp32", 2)}


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    """JAX: the first step from the init, then the second; → (state after
    the first, as numpy, and after the second)."""
    policy, mb = STEP_CASES[name]
    jc, _ = _configs("qwen3-1.7b", remat="full")
    step = jax.jit(JS.make_train_step(
        jc, JS.TrainOptions(opt_state_policy=policy, microbatch=mb)))
    p0 = _jax_params("qwen3-1.7b")
    b1, b2 = ({k: jnp.asarray(v) for k, v in _batch("qwen3-1.7b", seed,
                                                    b=4).items()}
              for seed in (1, 2))
    p1, s1, _ = step(p0, j_adamw_init(p0, state_policy=policy), b1)
    p2, s2, metrics = step(p1, s1, b2)
    return (jax.tree.map(np.asarray, (p1, s1)),
            jax.tree.map(np.asarray, (p2, s2, metrics)))


@pytest.fixture(scope="module")
def _jax_steps_compiled():
    warm_jax([functools.partial(_jax_steps, name) for name in STEP_CASES])


def _assert_moments_close(got, want, policy):
    for path, w in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, dict) and set(x) == {"q", "s"})[0]:
        g = got
        for key in path:
            g = g[key.key]
        name = jax.tree_util.keystr(path)
        if policy == "q8":
            shape = w["q"].shape
            gd = dequantize_q8({k: torch.tensor(np.asarray(v))
                                for k, v in g.items()}, shape).numpy()
            wd = dequantize_q8({k: torch.tensor(np.asarray(v))
                                for k, v in w.items()}, shape).numpy()
            step = np.repeat(np.asarray(w["s"]), 128, axis=-1)[..., :shape[-1]]
            assert (np.abs(gd - wd) <= 1.001 * step + 1e-30).all(), name
            continue
        w = np.asarray(w, np.float32)
        if policy == "bf16":
            np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                       atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()) + 1e-30,
                err_msg=name)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_train_step_matches_jax(name, _jax_steps_compiled):
    policy, mb = STEP_CASES[name]
    (p1, s1), (p2, s2, j_metrics) = _jax_steps(name)
    _, tc = _configs("qwen3-1.7b", remat="full")
    params = convert.from_jax_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), p1), tc,
        device="cpu")
    state = convert.from_jax_opt_state(s1, policy, device="cpu")
    assert int(state["count"]) == 1
    batch = {k: torch.from_numpy(v)
             for k, v in _batch("qwen3-1.7b", 2, b=4).items()}
    step = TS.make_train_step(tc, TS.TrainOptions(opt_state_policy=policy,
                                                  microbatch=mb))
    params, state, metrics = step(params, state, batch)
    assert set(metrics) == set(j_metrics) == {"loss", "xent", "moe_aux",
                                              "grad_norm"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    got_p = convert.to_numpy_params(params)
    for path, w in jax.tree_util.tree_flatten_with_path(p2)[0]:
        g = got_p
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=0,
                                   atol=1e-3 * LR,
                                   err_msg=jax.tree_util.keystr(path))
    got_s = convert.to_numpy_opt_state(state)
    assert int(got_s["count"]) == int(s2["count"]) == 2
    m_policy, v_policy = ("q8", "bf16") if policy == "q8" else (policy,) * 2
    _assert_moments_close(got_s["m"], s2["m"], m_policy)
    _assert_moments_close(got_s["v"], s2["v"], v_policy)


def test_opt_state_round_trips_through_convert():
    """A q8 state (int8 ``q``, fp32 ``s``, bf16 ``v``) carried across and
    back is the same arrays; its stacks become per-layer lists."""
    (_, s1), _ = _jax_steps("q8")
    state = convert.from_jax_opt_state(s1, "q8", device="cpu")
    layer0 = state["m"]["dense_stack"][0]["attn"]["wq"]["w"]
    assert layer0["q"].dtype == torch.int8 and layer0["s"].dtype == torch.float32
    assert state["v"]["dense_stack"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert len(state["m"]["dense_stack"]) == get_smoke("qwen3-1.7b").n_layers
    back = convert.to_numpy_opt_state(state)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(s1)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (_, g), (path, w) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(g, np.asarray(w, np.asarray(g).dtype),
                                      err_msg=jax.tree_util.keystr(path))
