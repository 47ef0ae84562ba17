"""Module step 9f: the port's training launcher (``repro_torch.launch.train``).

CPU, against the JAX package: the launcher's step (``make_train_step``:
``loss_and_grads``, ``clip_by_global_norm`` and ``adamw_update`` at the
schedule's learning rate) takes three steps from a JAX init carried
across by ``convert.from_jax_params``, beside the same three steps of the
JAX package's ``lm_loss`` + ``clip_by_global_norm`` + ``adamw_update``
composed as ``repro/launch/train.py`` composes them, on the pipeline's
batches, for qwen3-1.7b (cosine) and minicpm-2b (the WSD schedule the
launcher picks for it), SMOKE configs in float32 from step 17 of 20
(past the warmup; WSD's decay tail lowers the rate at 19).  Loss,
gradient norm and learning rate within ``GRAD_RTOL`` (1e-4,
``tests/test_torch_train.py``'s: float32 sums in other orders),
parameters within ``GRAD_RTOL`` of each leaf's largest value.  Then ``main()`` in process: a run that fails at its 4th
step call, restores the step-2 checkpoint and replays, against an
uninterrupted run: ``restarts=1``, the same batches at every step, the
loss series bit for bit equal (the CPU's plain routes are deterministic);
and ``--device cuda`` without a card raises.

Card (``cuda``-marked; JAX is imported only by the CPU tests, so these run
where it is not installed):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_launch_train.py

the same failure run on the card at SMOKE size (bf16; the flash kernel
forward and its backward kernel launched), every step's loss within 2^-6
relative of the uninterrupted run's (the backward's dQ atomics add in
another order each run), and a checkpoint of card tensors (bf16, fp32,
int8, int32) saved and restored in place bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data import CorpusPipeline, synth_corpus
from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.launch import steps as TS
from repro_torch.launch import train as T
from repro_torch.optim import adamw_init, tree_leaves

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, warm_jax  # noqa: F401

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6   # tests/test_torch_train.py's
ARCHS = ("qwen3-1.7b", "minicpm-2b")
TOTAL, START, N_STEPS = 20, 17, 3
SEQ, BATCH = 32, 2
CARD_LOSS_RTOL = 2 ** -6


def _argv(arch, *extra):
    return ["--arch", arch, "--smoke", "--steps", str(TOTAL), "--seq-len",
            str(SEQ), "--batch", str(BATCH), *extra]


def _batches():
    p = CorpusPipeline(synth_corpus(n_docs=64, seed=0), seq_len=SEQ,
                       batch_per_shard=BATCH, seed=0)
    p.load_state_dict({"step": START, "seed": 0, "epoch": 0})
    return [p.next_batch() for _ in range(N_STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The JAX package's three steps from its init → (numpy params at the
    start, per-step metrics, numpy params at the end, schedule kind)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as j_get_smoke
    from repro.launch import steps as JS
    from repro.models import model as JM
    from repro.optim import (adamw_init as j_adamw_init,
                             adamw_update as j_adamw_update,
                             clip_by_global_norm as j_clip,
                             make_schedule as j_make_schedule)
    cfg = j_get_smoke(arch)
    cfg = cfg.replace(remat="none", param_dtype=jnp.float32,
                      compute_dtype=jnp.float32)
    opts = JS.TrainOptions()
    kind = ("wsd" if cfg.name.startswith("minicpm") else "cosine")
    schedule = j_make_schedule(kind, peak_lr=opts.peak_lr,
                               warmup=max(TOTAL // 20, 2), total=TOTAL)

    @jax.jit
    def train_step(state, batch):     # repro/launch/train.py:70-86
        params, opt_state, step = state
        lr = schedule(step)
        (loss, _), grads = jax.value_and_grad(
            JM.lm_loss, has_aux=True)(params, cfg, batch)
        grads, gnorm = j_clip(grads, opts.max_grad_norm)
        params, opt_state = j_adamw_update(
            grads, opt_state, params, lr=lr, b1=opts.b1, b2=opts.b2,
            weight_decay=opts.weight_decay,
            state_policy=opts.opt_state_policy)
        return ((params, opt_state, step + 1),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    params = JM.init(jax.random.PRNGKey(0), cfg)[0]
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    state = (params, j_adamw_init(params), jnp.int32(START))
    metrics = []
    for b in _batches():
        state, m = train_step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    assert int(state[2]) == START + N_STEPS
    return p0, metrics, jax.tree.map(np.asarray, state[0]), kind


@pytest.fixture(scope="module")
def _jax_runs_compiled():
    warm_jax([functools.partial(_jax_run, arch) for arch in ARCHS])


@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_jax_composition(arch, _jax_runs_compiled):
    import jax

    from repro_torch import convert
    p0, j_metrics, j_params, kind = _jax_run(arch)
    args = T.parse_args(_argv(arch, "--device", "cpu"))
    cfg = T.train_config(args).replace(param_dtype=torch.float32,
                                       compute_dtype=torch.float32)
    assert cfg.remat == "none"
    opts = TS.TrainOptions(peak_lr=args.lr)
    step_fn = T.make_train_step(cfg, opts, T.train_schedule(cfg, args))
    params = convert.from_jax_params(p0, cfg, device="cpu")
    state = (params, adamw_init(params),
             torch.tensor(START, dtype=torch.int32))
    for b, want in zip(_batches(), j_metrics):
        state, m = step_fn(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        assert set(m) == set(want) == {"loss", "grad_norm", "lr"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), want[k], rtol=GRAD_RTOL,
                                       err_msg=k)
    assert int(state[2]) == START + N_STEPS
    lrs = [w["lr"] for w in j_metrics]
    if kind == "wsd":            # the decay tail lowers step 19's
        assert lrs[0] == lrs[1] > lrs[2]
    else:
        assert lrs[0] > lrs[1] > lrs[2]
    got = convert.to_numpy_params(state[0])
    for path, w in jax.tree_util.tree_flatten_with_path(j_params)[0]:
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL,
            err_msg=jax.tree_util.keystr(path))
    # the step updated the parameters it was given, in place
    assert not np.array_equal(convert.to_numpy_params(params)["embed"]
                              ["table"], p0["embed"]["table"])


def _main(argv):
    rep = {}
    assert T.main(argv, report=rep) == 0
    return rep


def _launch_argv(device, *extra):
    return ["--arch", "qwen3-1.7b", "--smoke", "--device", device,
            "--steps", "6", "--seq-len", "64", *extra]


def test_main_restarts_and_replays_bit_for_bit(tmp_path, capsys):
    failed = _main(_launch_argv("cpu", "--ckpt-dir", str(tmp_path),
                                "--ckpt-every", "2", "--simulate-failure",
                                "4"))
    out = capsys.readouterr().out
    assert "[data] corpus nnz=1406 vocab=433" in out
    assert "[train] 6 steps in " in out and "restarts=1" in out
    assert "[train] loss " in out
    clean = _main(_launch_argv("cpu"))
    assert (failed["steps"], failed["restarts"]) == (6, 1)
    assert (clean["steps"], clean["restarts"]) == (6, 0)
    # calls 1-3 ran steps 0-2, call 4 failed, the step-2 checkpoint
    # restored: steps 2-5 ran again
    assert [c["step"] for c in failed["calls"]] == [0, 1, 2, 2, 3, 4, 5]
    by_step = {c["step"]: c for c in clean["calls"]}
    for c in failed["calls"]:
        assert c["batch"] == by_step[c["step"]]["batch"]
        assert c["loss"] == by_step[c["step"]]["loss"]
    assert failed["losses"] == clean["losses"]
    assert [s["step"] for s in failed["saves"]] == [2, 4, 6]
    assert len(failed["restores"]) == 1
    for a, b in zip(tree_leaves(failed["state"][0]),
                    tree_leaves(clean["state"][0])):
        assert torch.equal(a, b)


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="cuda"):
        T.main(_launch_argv("cuda"))


def test_minicpm_gets_wsd_by_default():
    from repro.optim import make_schedule as j_make_schedule
    for arch, kind in (("minicpm-2b", "wsd"), ("qwen3-1.7b", "cosine")):
        args = T.parse_args(_argv(arch))
        sched = T.train_schedule(T.train_config(args), args)
        want = j_make_schedule(kind, peak_lr=args.lr, warmup=2, total=TOTAL)
        got = [float(sched(torch.tensor(s, dtype=torch.int32)))
               for s in range(TOTAL)]
        np.testing.assert_allclose(got, [float(want(s)) for s in range(TOTAL)],
                                   rtol=1e-6)
    args = T.parse_args(_argv("minicpm-2b", "--schedule", "wsd"))
    assert T.train_config(args).remat == "none"
    full = T.train_config(T.parse_args(["--arch", "qwen3-1.7b"]))
    assert full.remat == "full" and full.n_layers == 28


# -- the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_launcher_restart_on_card(card, tmp_path):
    reset_launch_counts()
    failed = _main(_launch_argv("cuda", "--ckpt-dir", str(tmp_path),
                                "--ckpt-every", "2", "--simulate-failure",
                                "4"))
    assert LAUNCHES["flash_attention_wgmma"] > 0
    assert LAUNCHES["flash_attention_bwd_wgmma"] > 0
    clean = _main(_launch_argv("cuda"))
    assert (failed["steps"], failed["restarts"]) == (6, 1)
    by_step = {c["step"]: c for c in clean["calls"]}
    assert [c["step"] for c in failed["calls"]] == [0, 1, 2, 2, 3, 4, 5]
    for c in failed["calls"]:
        want = by_step[c["step"]]
        assert c["batch"] == want["batch"]
        assert abs(c["loss"] - want["loss"]) <= CARD_LOSS_RTOL * abs(
            want["loss"])
    assert all(t.is_cuda for t in tree_leaves(failed["state"][0]))


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(card, tmp_path):
    gen = torch.Generator(device=card).manual_seed(0)
    state = {"w": torch.randn((33, 130), generator=gen, device=card)
             .to(torch.bfloat16),
             "m": [torch.randn((130,), generator=gen, device=card)],
             "q": {"q": torch.randint(-127, 128, (7, 130), generator=gen,
                                      device=card).to(torch.int8),
                   "s": torch.rand((7, 2), generator=gen, device=card)},
             "count": torch.tensor(5, dtype=torch.int32, device=card)}
    save_checkpoint(str(tmp_path), 1, state)
    target = {"w": torch.zeros_like(state["w"]),
              "m": [torch.zeros_like(state["m"][0])],
              "q": {k: torch.zeros_like(v) for k, v in state["q"].items()},
              "count": torch.zeros_like(state["count"])}
    got, step, _ = restore_checkpoint(str(tmp_path), target)
    assert step == 1

    def leaves(tree):     # every tensor, the q8 moment's two included
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]
    assert len(leaves(got)) == 5
    for a, b, t in zip(leaves(got), leaves(state), leaves(target)):
        assert a is t and a.is_cuda and a.dtype == b.dtype
        assert torch.equal(a, b)
