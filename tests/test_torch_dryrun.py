"""Module step 10 on the CPU: the dry run (``repro_torch.launch.dryrun``)
and its counts (``launch.hlo_analysis``) against the JAX package's pure
functions, one cell on a fake 16×16 group, and the elastic restore
(``restore_checkpoint(..., shardings=)``) against the JAX package's."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import shapes_for as j_shapes_for
from repro.launch import hlo_analysis as JHA
from repro.launch import steps as JS
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke, shapes_for
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as S
from repro_torch.launch.sharding import P
from repro_torch.models.pjit_utils import whole

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats  # noqa: F401
from _torch_helpers import fake_group, local_ranks


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_model_flops_and_active_params_match_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    n, jn = S.est_param_count(cfg), JS.est_param_count(jcfg)
    assert n == jn
    active = HA.active_param_count(cfg, n)
    assert active == JHA.active_param_count(jcfg, jn)
    assert [s.name for s in shapes_for(arch)] == \
        [s.name for s in j_shapes_for(arch)]
    for sh, jsh in zip(shapes_for(arch), j_shapes_for(arch)):
        assert HA.model_flops(cfg, sh, active) == \
            JHA.model_flops(jcfg, jsh, active)
    assert HA.dominant_term({"compute_s": 1, "memory_s": 3,
                             "collective_s": 2}) == "memory_s"


def test_collective_bytes_of_known_collectives():
    """One all-gather of a [64, 32] fp32 tensor sharded 4 ways (its result,
    8192 B, factor 1) and one all-reduce of a partial [16, 8] (512 B,
    factor 2), and the roofline terms of those counts."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          distribute_tensor)
    with fake_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        x = distribute_tensor(torch.zeros(64, 32), mesh,
                              SH.placements(P("data", None), mesh))
        y = DTensor.from_local(torch.zeros(16, 8), mesh, [Partial()])
        from torch.distributed.tensor.debug import CommDebugMode
        with CommDebugMode() as cdm, HA.StepCounter() as c:
            x.redistribute(mesh, [Replicate()])
            y.redistribute(mesh, [Replicate()])
            torch.ones(4, 8) @ torch.ones(8, 2)       # 2·4·8·2 FLOPs
        coll = HA.collective_bytes(c)
    # CommDebugMode's counts as a cross-check of the counter's
    assert cdm.get_total_counts() == sum(coll["counts"].values()) == 2
    assert coll["counts"]["all-gather"] == 1
    assert coll["counts"]["all-reduce"] == 1
    assert coll["per_kind"]["all-gather"] == 64 * 32 * 4
    assert coll["per_kind"]["all-reduce"] == 16 * 8 * 4 * 2
    assert coll["total"] == 8192 + 1024
    res = c.result()
    assert res["flops"] == 128
    terms = HA.roofline_terms(res, coll, 4)
    assert terms["collective_s"] == pytest.approx(9216 / HA.NET_BW)
    assert terms["compute_s"] == pytest.approx(128 / HA.PEAK_FLOPS)


RECORD_KEYS = {"status", "n_chips", "memory", "cost", "collectives",
               "roofline", "model_flops_total", "hlo_flops_total",
               "useful_flops_ratio", "params_total", "params_active",
               "dominant", "rank_step_s", "flash_launches"}


def test_run_cell_on_a_fake_pod(tmp_path):
    """qwen3 SMOKE's train_4k and decode_32k cells (cut to 32 × 64) as
    rank 0 of a fake 256-rank group on the CPU: the JAX record's keys that
    mean something here, none of those that do not, collectives of the
    expected kinds, and the CLI's JSON line; long_500k skipped with the
    JAX package's reason."""
    over = "seq_len=64,global_batch=32"
    with fake_group(256):
        rec = DR.run_cell("qwen3-1.7b", "train_4k", False, device="cpu",
                          smoke=True, overrides=over + ",microbatch=2")
    assert RECORD_KEYS <= set(rec), RECORD_KEYS - set(rec)
    assert not {"lower_s", "compile_s"} & set(rec)
    assert "tpu_adjusted_bytes" not in rec["memory"]
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["microbatch"] == 2
    counts = rec["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0 \
        and counts["reduce-scatter"] > 0
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["hlo_flops_total"] == rec["cost"]["flops"] * 256
    assert rec["params_total"] == S.est_param_count(get_smoke("qwen3-1.7b"))
    assert 0 < rec["useful_flops_ratio"] <= 1
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    # the shards: 2 sequences a rank of 32 over data 16
    assert rec["memory"]["argument_bytes"] > 0
    out = tmp_path / "cells.jsonl"
    assert DR.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                    "--device", "cpu", "--smoke", "--overrides", over,
                    "--out", str(out)]) == 0
    dec = json.loads(out.read_text().splitlines()[-1])
    assert dec["status"] == "ok" and dec["flash_launches"] == {
        k: 0 for k in DR.FLASH_KEYS}
    assert dec["collectives"]["counts"]["all-gather"] > 0
    skip = DR.run_cell("qwen3-1.7b", "long_500k", False, device="cpu")
    assert skip["status"] == "skipped"
    assert skip["reason"] == ("long_500k needs sub-quadratic attention; "
                              "this is a pure full-attention arch (see "
                              "DESIGN.md)")


# -- the elastic restore -------------------------------------------------------

def test_elastic_restore_resharding(tmp_path):
    """The port's counterpart of tests/test_checkpoint.py's: a checkpoint
    written unsharded restores onto a mesh of 4 simulated ranks, each
    reading only its block; saving the DTensors writes the global array
    again."""
    s = {"w": torch.arange(8, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 3, s)
    with local_ranks(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        restored, step, _ = restore_checkpoint(
            str(tmp_path), s, shardings=({"w": P("data")}, mesh))
        assert step == 3
        w = restored["w"]
        assert tuple(w.placements) == SH.placements(P("data"), mesh)
        for r, loc in w.to_local()._local_tensors.items():
            np.testing.assert_array_equal(loc.numpy(), [2 * r, 2 * r + 1])
        np.testing.assert_array_equal(whole(w).numpy(), np.arange(8))
        save_checkpoint(str(tmp_path), 4, restored)
    back, _, _ = restore_checkpoint(str(tmp_path), s, step=4, device="cpu")
    np.testing.assert_array_equal(back["w"].numpy(), np.arange(8))


def test_jax_checkpoint_restores_sharded_on_the_port(tmp_path):
    """A checkpoint the JAX package wrote (bf16 and fp32 leaves, a q8
    moment) restored on a 2×2 mesh: every rank's block is the slice that
    its spec assigns it."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 12)).astype(np.float32)
    b = rng.standard_normal((4, 8)).astype(np.float32)
    q = rng.integers(-127, 127, (8, 4)).astype(np.int8)
    j_save_checkpoint(str(tmp_path), 7, {
        "w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16),
        "m": {"q": jnp.asarray(q), "s": jnp.ones((8, 1), jnp.float32)}})
    target = {"w": torch.zeros(8, 12), "b": torch.zeros(4, 8,
                                                        dtype=torch.bfloat16),
              "m": {"q": torch.zeros(8, 4, dtype=torch.int8),
                    "s": torch.zeros(8, 1)}}
    specs = {"w": P("data", "model"), "b": P(None, ("data", "model")),
             "m": {"q": P("model", None), "s": P()}}
    want = {"w": torch.from_numpy(w),
            "b": torch.from_numpy(b).to(torch.bfloat16),
            "m": {"q": torch.from_numpy(q), "s": torch.ones(8, 1)}}
    with local_ranks(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        st, step, _ = restore_checkpoint(str(tmp_path), target,
                                         shardings=(specs, mesh))
        assert step == 7
        layout = mesh.mesh
        for key, spec, t, full in (("w", specs["w"], st["w"], want["w"]),
                                   ("b", specs["b"], st["b"], want["b"]),
                                   ("q", specs["m"]["q"], st["m"]["q"],
                                    want["m"]["q"])):
            assert t.dtype == full.dtype, key
            for r, loc in t.to_local()._local_tensors.items():
                coord = tuple(int(c) for c in (layout == r).nonzero()[0])
                assert torch.equal(loc, full[SH.block_slices(
                    full.shape, spec, mesh, coord)]), (key, r)
        assert torch.equal(whole(st["m"]["s"]), want["m"]["s"])
