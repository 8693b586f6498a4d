"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_port_*).

Inputs are drawn with numpy and handed to both frameworks; JAX models are
built with use_pallas=False on the CPU, and their weights reach the port
through `state_dict_from_jax`.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

# the tiny widths of tests/test_torch_ckpt_pipeline.py
TINY = dict(edgeconv_widths=((8, 8), (8, 8), (8, 8)), mlp_widths=(16, 16),
            base_widths=(8, 8), output_dim=8, main_dim=16, k=5)


def set_fp32():
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def randomize_bn(variables, seed: int):
    """Random BatchNorm scales/shifts and running statistics, so that the
    port's BatchNorm folding is exercised (JAX init leaves them at 1/0)."""
    r = np.random.default_rng(seed)

    def draw(shape, loc, scale):
        return jnp.asarray(loc + scale * r.standard_normal(shape),
                           jnp.float32)

    def walk(node, stats):
        if stats and set(node) == {"mean", "var"}:
            return {"mean": draw(node["mean"].shape, 0.0, 0.1),
                    "var": jnp.asarray(0.5 + r.random(node["var"].shape),
                                       jnp.float32)}
        if not stats and set(node) == {"scale", "bias"}:       # a BatchNorm
            return {"scale": draw(node["scale"].shape, 1.0, 0.1),
                    "bias": draw(node["bias"].shape, 0.0, 0.1)}
        return {key: walk(val, stats) if isinstance(val, dict) else val
                for key, val in node.items()}

    return {"params": walk(dict(variables["params"]), False),
            "batch_stats": walk(dict(variables["batch_stats"]), True)}


def jax_capl(num_gw: int = 10, npts: int = 64, seed: int = 0, classes=13,
             base_num=7, eval_weight=1.2, **cfg):
    """A JAX GWCAPL (XLA path) at the given widths with random BN."""
    from gfs3dseg_gws_tpu.models.capl import GWCAPL

    cfg = {**TINY, **cfg}
    model = GWCAPL(classes=classes, base_num=base_num, num_gw=num_gw,
                   eval_weight=eval_weight, use_pallas=False, **cfg)
    rng = jax.random.PRNGKey(seed)
    gp = jnp.zeros((num_gw, sum(w[-1] for w in cfg["edgeconv_widths"])))
    variables = model.init({"params": rng, "dropout": rng, "fake": rng},
                           jnp.zeros((2, npts, 9)),
                           jnp.zeros((2, npts), jnp.int32), gp, train=True)
    return model, randomize_bn(variables, seed + 100)


def torch_capl(variables, num_gw: int = 10, classes=13, base_num=7,
               eval_weight=1.2, **cfg):
    """The port's GWCAPL carrying the JAX variables (strict load)."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import state_dict_from_jax

    model = GWCAPL(classes=classes, base_num=base_num, num_gw=num_gw,
                   eval_weight=eval_weight, **{**TINY, **cfg})
    model.load_state_dict(state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])), strict=True)
    return model


def t(a):
    return torch.from_numpy(np.array(a))
