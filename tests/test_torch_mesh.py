"""Module step 10 on the CPU: the port's sharding rules against the JAX
package's (``repro.launch.sharding`` on ``AbstractMesh`` 16×16 and
2×16×16), its DTensor placements against ``PartitionSpec`` semantics, and
qwen3 SMOKE's sharded train and decode steps on a 2×2 mesh of simulated
ranks (``LocalTensorMode``) against the unsharded port steps."""
import copy
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import shapes_for as j_shapes_for
from repro.launch import sharding as JSH
from repro.launch import steps as JS
from repro.models import model as JM
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config, get_smoke, shapes_for
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import cuda_lib
from repro_torch.launch import mesh as MS
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as S
from repro_torch.launch.sharding import P
from repro_torch.models import model as M
from repro_torch.models import pjit_utils as PU
from repro_torch.models.pjit_utils import whole
from repro_torch.models.logical import param_logical, param_shapes
from repro_torch.optim import adamw_init, tree_leaves

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats  # noqa: F401
from _torch_helpers import fake_group, local_ranks


def _amesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)
    except TypeError:                       # jax <= 0.4.x
        return AbstractMesh(tuple(zip(names, sizes)))


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jmesh(name):
    return _amesh(*MESHES[name])


def _tmesh(name):
    sizes, names = MESHES[name]
    return dict(zip(names, sizes))


def _same(port, jax_spec):
    """A port spec against a JAX ``PartitionSpec``, entry for entry."""
    assert isinstance(port, P)
    assert tuple(port) == tuple(jax_spec), (port, jax_spec)


# -- the eight tests of tests/test_sharding.py, port beside JAX ---------------

SPEC_CASES = {
    "tp_and_fsdp_mlp": ("qwen3-1.7b", (2048, 6144), ("embed", "mlp"),
                        "16x16", {}, ("data", "model")),
    "tp_and_fsdp_vocab": ("qwen3-1.7b", (151936, 2048), ("vocab", "embed"),
                          "16x16", {}, ("model", "data")),
    "vocab_indivisible": ("minicpm-2b", (122753, 2304), ("vocab", "embed"),
                          "16x16", {}, (None, "data")),
    "layers_never_sharded": ("qwen3-1.7b", (28, 2048, 6144),
                             ("layers", "embed", "mlp"), "16x16", {},
                             (None, "data", "model")),
    "moe_ep": ("deepseek-v3-671b", (256, 7168, 2048),
               ("expert", "embed", "expert_mlp"), "16x16", {},
               ("model", "data", None)),
    "moe_tp": ("mixtral-8x22b", (8, 6144, 16384),
               ("expert", "embed", "expert_mlp"), "16x16", {},
               (None, "data", "model")),
    "fsdp_over_pod": ("deepseek-v3-671b", (7168, 1536), ("embed", None),
                      "2x16x16", {"fsdp_over_pod": True},
                      (("pod", "data"), None)),
    "fsdp_over_pod_degrades": ("deepseek-v3-671b", (48, 16), ("embed", None),
                               "2x16x16", {"fsdp_over_pod": True},
                               ("data", None)),
    "no_double_axis_use": ("qwen3-1.7b", (2048, 2048), ("embed", "embed"),
                           "16x16", {}, ("data", None)),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_for_shape_matches_jax(case):
    arch, shape, logical, mesh, kw, want = SPEC_CASES[case]
    got = SH.spec_for_shape(shape, logical,
                            SH.logical_rules(get_config(arch), **kw),
                            _tmesh(mesh))
    j = JSH.spec_for_shape(shape, logical,
                           JSH.logical_rules(j_get_config(arch), **kw),
                           _jmesh(mesh))
    _same(got, j)
    assert tuple(got) == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_spec_degradation_matches_jax(mesh):
    for b in (256, 128, 32, 16, 2, 1):
        for par in ("2d", "fsdp_only"):
            for ndim in (1, 2, 3):
                _same(SH.batch_spec(b, _tmesh(mesh), ndim=ndim,
                                    parallelism=par),
                      JSH.batch_spec(b, _jmesh(mesh), ndim=ndim,
                                     parallelism=par))
    assert tuple(SH.batch_spec(1, _tmesh("16x16"))) == (None, None)


@functools.lru_cache(maxsize=None)
def _jax_init_specs(arch):
    return JS.M_init_specs(j_get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    return param_shapes(get_config(arch))


def _walk_pairs(j_tree, p_tree, path=()):
    """(path, port spec, JAX spec) of every leaf: a JAX stacked leaf
    against each layer of the port's list, its leading entry dropped."""
    if isinstance(j_tree, JP):
        if isinstance(p_tree, list):
            for i, p in enumerate(p_tree):
                yield path + (i,), p, JP(*tuple(j_tree)[1:])
        else:
            yield path, p_tree, j_tree
        return
    if isinstance(p_tree, list):
        assert isinstance(j_tree, dict)
        for k in j_tree:
            yield from _walk_pairs(j_tree[k], [q[k] for q in p_tree],
                                   path + (k,))
        return
    assert set(j_tree) == set(p_tree), (path, set(j_tree) ^ set(p_tree))
    for k in j_tree:
        yield from _walk_pairs(j_tree[k], p_tree[k], path + (k,))


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_param_specs_match_jax_at_full_size(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    jshapes, jlogical = _jax_init_specs(arch)
    shapes, logical = _port_shapes(arch), param_logical(cfg)
    for mesh in sorted(MESHES):
        for kw in (({}, {"parallelism": "fsdp_only"}) if mesh == "16x16"
                   else ({}, {"fsdp": False}, {"fsdp_over_pod": True})):
            got = SH.param_specs(shapes, logical, cfg, _tmesh(mesh), **kw)
            want = JSH.param_specs(jshapes, jlogical, jcfg, _jmesh(mesh),
                                   **kw)
            n = 0
            for path, p, j in _walk_pairs(want, got):
                assert tuple(p) == tuple(j), (arch, mesh, kw, path, p, j)
                n += 1
            assert n == len(tree_leaves(shapes))
    # a per-layer norm scale: [d] here, [L, d] in JAX, sharded over data
    # there, so over data here too; a top-level one stays replicated
    got = SH.param_specs(shapes, logical, cfg, _tmesh("16x16"))
    for stack in [k for k, v in got.items() if isinstance(v, list)]:
        norm = "norm" if stack == "mamba_stack" else "attn_norm"
        assert tuple(got[stack][0][norm]["g"]) == ("data",), stack
    assert tuple(got["final_norm"]["g"]) == ()


CACHE_ARCHS = ("qwen3-1.7b", "deepseek-v3-671b", "mamba2-130m", "zamba2-7b",
               "whisper-medium", "mixtral-8x22b")


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_jax(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for mesh in sorted(MESHES):
        for b, s in ((128, 32768), (1, 4096)):
            with FakeTensorMode():
                shapes = M.init_cache(cfg, b, s, device="cpu")
            jshapes = jax.eval_shape(lambda: JM.init_cache(jcfg, b, s))
            got = SH.cache_specs(cfg, shapes, _tmesh(mesh), b)
            want = JSH.cache_specs(jcfg, jshapes, _jmesh(mesh), b)
            flat = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, JP))[0]
            assert len(flat) == len(SH.spec_leaves(got))
            for path, j in flat:
                g = got
                for key in path:
                    g = g[key.key]
                assert tuple(g) == tuple(j), (arch, mesh, path, g, j)


@functools.lru_cache(maxsize=None)
def _jax_opt_shapes(arch):
    return jax.eval_shape(lambda p: j_adamw_init(p, state_policy="q8"),
                          _jax_init_specs(arch)[0])


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_opt_state_batch_and_microbatch_match_jax(arch):
    """``opt_state_specs`` under q8 on both meshes, then ``batch_spec``
    and ``auto_microbatch`` for every shape of the arch, both meshes,
    both parallelisms."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shapes, logical = _port_shapes(arch), param_logical(cfg)
    with FakeTensorMode():
        st = adamw_init(shapes, state_policy="q8")
    for mesh in sorted(MESHES):
        pspecs = SH.param_specs(shapes, logical, cfg, _tmesh(mesh))
        got = SH.opt_state_specs(pspecs, st)
        want = JSH.opt_state_specs(
            JSH.param_specs(*_jax_init_specs(arch), jcfg, _jmesh(mesh)),
            _jax_opt_shapes(arch))
        assert tuple(got["count"]) == tuple(want["count"]) == ()
        for mom in ("m", "v"):
            pairs = list(_walk_pairs(want[mom], got[mom]))
            assert len(pairs) == len(tree_leaves(st[mom])) \
                + sum(1 for x in tree_leaves(st[mom]) if isinstance(x, dict))
            for path, p, j in pairs:
                assert tuple(p) == tuple(j), (arch, mesh, mom, path)
        for sh, jsh in zip(shapes_for(arch), j_shapes_for(arch)):
            for par in ("2d", "fsdp_only"):
                _same(SH.batch_spec(sh.global_batch, _tmesh(mesh),
                                    parallelism=par),
                      JSH.batch_spec(jsh.global_batch, _jmesh(mesh),
                                     parallelism=par))
                for budget in (4e9, 2e8):
                    assert S.auto_microbatch(
                        cfg, sh, _tmesh(mesh), residual_budget=budget,
                        parallelism=par) == JS.auto_microbatch(
                        jcfg, jsh, _jmesh(mesh), residual_budget=budget,
                        parallelism=par), (arch, sh.name, mesh, par)


def test_auto_microbatch_qwen3_train_4k_on_the_pod():
    """The mesh phase's cell: 16 sequences of 4096 a rank, 2 chunks."""
    shape = {s.name: s for s in shapes_for("qwen3-1.7b")}["train_4k"]
    assert S.auto_microbatch(get_config("qwen3-1.7b"), shape,
                             _tmesh("16x16")) == 2


# -- DTensor placements against PartitionSpec semantics ------------------------

def _block(x, spec, sizes, coord):
    """The block of numpy ``x`` at mesh coordinate ``coord`` under
    PartitionSpec semantics: a dim over several mesh axes is split by the
    first axis, each part by the next, and so on."""
    names = list(sizes)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            x = np.split(x, sizes[a], axis=i)[coord[names.index(a)]]
    return x


PLACEMENT_CASES = [
    ((2, 2), ("data", "model"), P("data", "model")),
    ((2, 2), ("data", "model"), P(("data", "model"), None)),
    ((2, 2), ("data", "model"), P(None, "data")),
    ((2, 2), ("data", "model"), P()),
    ((2, 2, 2), ("pod", "data", "model"), P(("pod", "data"), "model")),
    ((2, 2, 2), ("pod", "data", "model"), P("model", ("pod", "data"))),
    ((2, 2, 2), ("pod", "data", "model"), P(None, ("data", "model"))),
]


@pytest.mark.parametrize("case", range(len(PLACEMENT_CASES)))
def test_local_shards_are_partition_spec_blocks(case):
    sizes, names, spec = PLACEMENT_CASES[case]
    world = int(np.prod(sizes))
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    with local_ranks(world):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", sizes, mesh_dim_names=names)
        d = SH.shard_tree({"x": torch.from_numpy(x)}, {"x": spec}, mesh)["x"]
        assert tuple(d.placements) == SH.placements(spec, mesh)
        layout = mesh.mesh
        loc = d.to_local()
        # a replicated DTensor's local tensor is one plain tensor for all
        per_rank = getattr(loc, "_local_tensors", dict.fromkeys(
            range(world), loc))
        for r, loc in per_rank.items():
            coord = tuple(int(c) for c in (layout == r).nonzero()[0])
            want = _block(x, spec, dict(zip(names, sizes)), coord)
            np.testing.assert_array_equal(loc.numpy(), want)
            np.testing.assert_array_equal(
                x[SH.block_slices(x.shape, spec, mesh, coord)], want)
            assert SH.local_shape(x.shape, spec, mesh) == want.shape


def test_placements_refuse_a_dim_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh's order"):
        SH.placements(P(("model", "data"), None), _tmesh("16x16"))


def test_mesh_needs_a_group_of_its_size():
    with pytest.raises(RuntimeError, match="needs a default process group"):
        MS.make_production_mesh(device="cpu")
    with fake_group(8):
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            MS.make_production_mesh(device="cpu")
    with fake_group(512):
        mesh = MS.make_production_mesh(multi_pod=True, device="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert MS.batch_axes(mesh) == ("pod", "data")
        assert MS.mesh_shape(mesh) == {"pod": 2, "data": 16, "model": 16}


# -- the sharding hints --------------------------------------------------------

def test_hints_are_the_identity_without_a_mesh():
    x = torch.randn(4, 8, 16)
    for fn in (PU.constrain_batch, PU.constrain_seq,
               PU.constrain_last_model, lambda t: PU.constrain(t, None)):
        assert fn(x) is x
    assert PU.constrain_decode_qkv(x, x, x, 2) == (x, x, x)
    assert PU.batch_axes_in_mesh() is None


def test_hints_give_the_jax_specs_placements():
    from torch.distributed.tensor import Replicate, distribute_tensor
    with local_ranks(4):
        mesh = MS.make_host_mesh(2, 2, device="cpu")
        x = distribute_tensor(torch.randn(4, 8, 16), mesh,
                              [Replicate(), Replicate()])
        assert PU.constrain_batch(x) is x          # no active mesh
        with PU.use_mesh(mesh):
            for fn, spec in (
                    (PU.constrain_batch, P("data", None, None)),
                    (PU.constrain_seq, P("data", "model", None)),
                    (PU.constrain_last_model, P("data", None, "model")),
                    (lambda t: PU.constrain(t, None, "data", "model"),
                     P(None, "data", "model"))):
                y = fn(x)
                assert tuple(y.placements) == SH.placements(spec, mesh)
                torch.testing.assert_close(whole(y), whole(x))
            q, k, v = PU.constrain_decode_qkv(x, x, x, n_kv_heads=1)
            assert tuple(q.placements) == SH.placements(
                P("data", None, "model"), mesh)
            assert PU.constrain_decode_qkv(x, x, x, n_kv_heads=2)[0] is x
        with PU.use_mesh(mesh, "fsdp_only"):
            assert PU.batch_axes_in_mesh() == ("data", "model")
        assert PU.batch_axes_in_mesh() is None


# -- the sharded steps against the unsharded ones ------------------------------

B, T = 4, 32
LR = S.TrainOptions().peak_lr


def _smoke(remat="full"):
    return get_smoke("qwen3-1.7b").replace(param_dtype=torch.float32,
                                           compute_dtype=torch.float32,
                                           remat=remat)


@functools.lru_cache(maxsize=None)
def _first_step():
    """One unsharded step from a seeded state → (params, state) after it
    (where AdamW's moments are no longer zero, so the next step's size
    follows its gradients), and the batch."""
    cfg = _smoke()
    params = M.init(M.make_generator(0, "cpu"), cfg)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (B, T + 1), generator=g,
                        dtype=torch.int32)
    batch = {"tokens": tok[:, :T].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    params, state, _ = S.make_train_step(cfg, S.TrainOptions(microbatch=1))(
        params, adamw_init(params), batch)
    return (params, state), batch


@functools.lru_cache(maxsize=None)
def _unsharded_steps(microbatch: int):
    """The state after :func:`_first_step`, and the next unsharded step's
    results over ``microbatch`` microbatches (remat changes no value)."""
    start, batch = _first_step()
    params, state = copy.deepcopy(start)
    p2, s2, m2 = S.make_train_step(
        _smoke(), S.TrainOptions(microbatch=microbatch))(params, state, batch)
    return start, batch, (p2, s2, m2)


# each parallelism, each fsdp setting and both GQA layouts once (a
# LocalTensorMode step at SMOKE size takes seconds on the CPU): on 2x2,
# 2d with FSDP, the per-layer recompute (remat "full", SMOKE's own) and
# two microbatches (each rank splits its own rows), and fsdp_only without
# FSDP or the recompute; on 1x4, 2d, where SMOKE's 2 kv heads do not
# divide `model` (each rank takes its kv head by coordinate, the K/V
# gradient a partial sum)
STEP_OPTS = {
    "2d-fsdp": ((2, 2), dict(parallelism="2d", fsdp=True, microbatch=2),
                "full"),
    "fsdp_only-no_fsdp": ((2, 2), dict(parallelism="fsdp_only", fsdp=False,
                                       microbatch=1), "none"),
    "1x4-2d-gqa": ((1, 4), dict(parallelism="2d", fsdp=True, microbatch=1),
                   "none")}


@pytest.mark.parametrize("name", sorted(STEP_OPTS))
def test_sharded_train_step_equals_unsharded(name):
    """The step on a mesh of simulated ranks, its parameters, moments and
    batch placed by the JAX specs under the option's rules: loss, metrics
    and every moment within rtol 1e-5 of the unsharded port step over the
    same microbatches; every updated parameter within 1e-3·lr, as
    tests/test_torch_train.py holds the port's step to JAX's.  With
    microbatches, ``xent`` is the last microbatch's, whose rows differ by
    design (each rank's own last rows), so only the loss, which is the
    mean over all of them, and the gradient norm are compared."""
    mesh_shape, kw, remat = STEP_OPTS[name]
    cfg = _smoke(remat)
    opts = S.TrainOptions(**kw)
    (params, state), batch, (p2, s2, m2) = _unsharded_steps(opts.microbatch)
    with local_ranks(4):
        mesh = MS.make_host_mesh(*mesh_shape, device="cpu")
        step, (dp, ds, db) = S.build_sharded(
            cfg, ShapeSpec("t", "train", T, B), mesh, opts, params=params,
            batch=batch)
        # the optimizer state after the first step, placed by its specs
        specs = SH.opt_state_specs(
            SH.param_specs(params, param_logical(cfg), cfg, mesh,
                           fsdp=opts.fsdp, parallelism=opts.parallelism),
            state)
        ds = SH.shard_tree(state, specs, mesh)
        p1, s1, m1 = step(dp, ds, db)
        keys = ("loss", "grad_norm") + (("xent",) if opts.microbatch == 1
                                        else ())
        for k in keys:
            np.testing.assert_allclose(float(whole(m1[k])), float(m2[k]),
                                       rtol=1e-5, err_msg=k)
        for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
            assert tuple(a.placements) != () and a.shape == b.shape
            np.testing.assert_allclose(whole(a).numpy(), b.numpy(), rtol=0,
                                       atol=1e-3 * LR)
        for mom in ("m", "v"):
            for a, b in zip(tree_leaves(s1[mom]), tree_leaves(s2[mom])):
                w = whole(a).numpy()
                np.testing.assert_allclose(
                    w, b.numpy(), rtol=1e-5,
                    atol=1e-5 * float(b.abs().max()) + 1e-30)
        assert int(whole(s1["count"])) == 2


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_sharded_decode_step_equals_unsharded(mesh_shape):
    """A decode step over a full cache: on (2, 2) the kv heads shard over
    `model`; on (1, 4) they do not divide it, so the cache and q/k/v
    shard the head dim (``cache_specs``, ``constrain_decode_qkv``)."""
    cfg = _smoke()
    params = M.init(M.make_generator(0, "cpu"), cfg)
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, cfg.vocab, (B, T), generator=g, dtype=torch.int32)
    cache = M.init_cache(cfg, B, T, device="cpu")
    _, pc = S.make_prefill_step(cfg)(params, tok[:, :T - 1].contiguous())
    for key in ("k", "v"):
        cache["dense_stack"][key][:, :, :T - 1] = pc["dense_stack"][key]
    cache["dense_stack"]["len"][:] = T - 1
    want, _ = S.make_serve_step(cfg)(params, copy.deepcopy(cache),
                                     tok[:, T - 1:], torch.tensor(T - 1))
    with local_ranks(4):
        mesh = MS.make_host_mesh(*mesh_shape, device="cpu")
        step, args = S.build_sharded(
            cfg, ShapeSpec("d", "decode", T, B), mesh, S.TrainOptions(),
            params=params, batch={"tokens": tok[:, T - 1:].contiguous()},
            cache=cache)
        got, new_cache = step(*args)
        np.testing.assert_allclose(whole(got).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5 * float(
                                       want.abs().max()))
        assert int(whole(new_cache["dense_stack"]["len"])[0]) == T


def test_flash_on_local_shards_takes_only_its_kv_heads(monkeypatch):
    """With 4 q heads and 2 kv heads over a `model` dim of 4, rank c's q
    head reads kv head c // 2: the flash wrapper receives that one kv head
    on each rank's local tensors, never a DTensor, and the result equals
    the unsharded attention."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as A
    assert [list(A.kv_heads_of_shard(c, 4, 2, 4)) for c in range(4)] == \
        [[0], [0], [1], [1]]
    assert [list(A.kv_heads_of_shard(c, 16, 8, 16)) for c in (0, 1, 15)] \
        == [[0], [0], [7]]
    assert list(A.kv_heads_of_shard(1, 32, 8, 4)) == [2, 3]
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 8, h, 16, generator=g) for h in (4, 2, 2))
    want = fa_ops.flash_attention(q, k, v, causal=True)
    seen = []
    real = fa_ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((isinstance(q, DTensor) or isinstance(k, DTensor),
                     tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", spy)
    with local_ranks(4):
        mesh = MS.make_host_mesh(1, 4, device="cpu")
        pl = SH.placements(P(None, None, "model", None), mesh)
        rep = SH.placements(P(), mesh)
        dq = distribute_tensor(q, mesh, pl)
        dk, dv = (distribute_tensor(t, mesh, rep) for t in (k, v))
        out = A.chunked_attention(dq, dk, dv, q_positions=None,
                                  k_positions=None, causal=True,
                                  impl="auto")
        torch.testing.assert_close(whole(out), want)
    assert seen == [(False, (2, 8, 1, 16), (2, 8, 1, 16))]


def test_kernels_refuse_tensor_subclasses():
    """A DTensor (or a LocalTensor) never reaches an extension: it has no
    device pointer of its own; ``nn.Parameter`` stays allowed."""
    from torch.distributed.tensor import distribute_tensor
    with fake_group(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        d = distribute_tensor(torch.zeros(8, 4), mesh,
                              SH.placements(P("model", None), mesh))
        with pytest.raises(TypeError, match="local_map"):
            cuda_lib.check_cuda(d)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lib.check_cuda(torch.nn.Parameter(torch.zeros(2)))
