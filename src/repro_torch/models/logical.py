"""Logical axis names of every parameter, and the parameter tree's shapes
with nothing allocated.

:func:`param_logical` mirrors the ``specs`` half of each JAX ``init_*``
(``repro/models``): the same leaves with the same logical names, in the
port's tree (each layer stack a list of per-layer dicts, where the JAX
package stacks the leaves on a leading ``"layers"`` axis; the sharding
rules add that axis back, :func:`repro_torch.launch.sharding.param_specs`).
:func:`param_shapes` runs :func:`repro_torch.models.model.init` under
``FakeTensorMode``, so deepseek-v3-671b's tree costs no memory.  Together
they are the counterpart of the JAX package's ``launch.steps.M_init_specs``.
"""
from __future__ import annotations

from .model import _n_dense


def _linear(axes, bias: bool = False):
    out = {"w": axes}
    if bias:
        out["b"] = (axes[1],)
    return out


def _norm(kind: str):
    out = {"g": ("embed",)}
    if kind == "layernorm":
        out["b"] = ("embed",)
    return out


def _gqa(cfg):
    b = cfg.attn_bias
    out = {"wq": _linear(("embed", "heads"), b),
           "wk": _linear(("embed", "heads"), b),
           "wv": _linear(("embed", "heads"), b),
           "wo": _linear(("heads", "embed"), b)}
    if cfg.qk_norm:
        out["q_g"] = (None,)
        out["k_g"] = (None,)
    return out


def _mla():
    return {"wdq": _linear(("embed", None)), "q_norm_g": (None,),
            "wuq": _linear((None, "heads")),
            "wdkv": _linear(("embed", None)), "kv_norm_g": (None,),
            "wkr": _linear(("embed", None)),
            "wuk": _linear((None, "heads")), "wuv": _linear((None, "heads")),
            "wo": _linear(("heads", "embed"))}


def _mlp(cfg):
    if cfg.act == "swiglu":
        return {"gate": _linear(("embed", "mlp")),
                "up": _linear(("embed", "mlp")),
                "down": _linear(("mlp", "embed"))}
    return {"up": _linear(("embed", "mlp"), cfg.attn_bias),
            "down": _linear(("mlp", "embed"), cfg.attn_bias)}


def _moe(cfg):
    m = cfg.moe
    out = {"router": ("embed", None),
           "gate": ("expert", "embed", "expert_mlp"),
           "up": ("expert", "embed", "expert_mlp"),
           "down": ("expert", "expert_mlp", "embed")}
    if m.get("router_bias", False):
        out["e_bias"] = (None,)
    if m.get("shared_expert", 0):
        out["shared_gate"] = _linear(("embed", "mlp"))
        out["shared_up"] = _linear(("embed", "mlp"))
        out["shared_down"] = _linear(("mlp", "embed"))
    return out


def _decoder_layer(cfg, *, use_moe: bool = False, cross: bool = False):
    out = {"attn_norm": _norm(cfg.norm),
           "attn": _mla() if cfg.mla else _gqa(cfg)}
    if cross:
        out["cross_norm"] = _norm(cfg.norm)
        out["cross"] = _gqa(cfg)
    out["mlp_norm"] = _norm(cfg.norm)
    if use_moe:
        out["moe"] = _moe(cfg)
    else:
        out["mlp"] = _mlp(cfg)
    return out


def _mamba2():
    return {"in_z": _linear(("embed", "heads")),
            "in_x": _linear(("embed", "heads")),
            "in_b": _linear(("embed", None)), "in_c": _linear(("embed", None)),
            "in_dt": _linear(("embed", "heads")),
            "dt_bias": ("heads",), "a_log": ("heads",), "d_skip": ("heads",),
            "conv_x": (None, "heads"), "conv_bc": (None, None),
            "norm_g": ("heads",), "out": _linear(("heads", "embed"))}


def param_logical(cfg):
    """The logical-axis tree of :func:`repro_torch.models.model.init`'s
    parameters: a tuple of axis names (or None) per leaf, one per dim."""
    out = {"embed": {"table": ("vocab", "embed")}}
    if cfg.pos_emb == "learned":
        out["pos"] = (None, "embed")
    out["final_norm"] = _norm(cfg.norm)
    if not cfg.tie_embeddings:
        out["lm_head"] = {"table": ("vocab", "embed")}
    if cfg.family in ("dense", "moe"):
        n_dense = _n_dense(cfg)
        if n_dense:
            out["dense_stack"] = [_decoder_layer(cfg)
                                  for _ in range(n_dense)]
        if cfg.n_layers > n_dense:
            out["moe_stack"] = [_decoder_layer(cfg, use_moe=True)
                                for _ in range(cfg.n_layers - n_dense)]
        if cfg.mtp:
            out["mtp"] = {"norm_h": _norm(cfg.norm),
                          "norm_e": _norm(cfg.norm),
                          "proj": ("embed", None),
                          "layer": _decoder_layer(cfg)}
        return out
    if cfg.family == "encdec":
        out["enc_stack"] = [_decoder_layer(cfg)
                            for _ in range(cfg.encdec["enc_layers"])]
        out["dec_stack"] = [_decoder_layer(cfg, cross=True)
                            for _ in range(cfg.n_layers)]
        out["enc_norm"] = _norm(cfg.norm)
        out["enc_pos"] = (None, "embed")
        return out
    out["mamba_stack"] = [{"norm": _norm(cfg.norm), "mixer": _mamba2()}
                          for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        out["shared"] = _decoder_layer(cfg)
        if cfg.hybrid.get("lora_rank", 0):
            out["shared_lora"] = {"a": (None, "embed", None),
                                  "b": (None, None, "heads")}
    return out


def param_shapes(cfg):
    """:func:`repro_torch.models.model.init`'s tree with fake tensors in
    place of the parameters: shapes and dtypes, no storage."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from .model import init
    with FakeTensorMode():
        return init(torch.Generator(device="cpu").manual_seed(0), cfg)
