"""PyTorch port, few-shot baselines slice, MPTI against the JAX package on
the CPU: farthest point sampling bit for bit, the k-NN affinity on rows
with exact duplicates, label propagation, multi-prototypes, MPTI's forward
and train step (the no-background support too), and `mpti_test_gfs` end to
end.

Inputs are drawn with numpy; JAX models use use_pallas=False (the XLA
path). Tolerances are max |got - ref| / max |ref| unless stated.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfs3dseg_gws_tpu.models.mpti import MPTI as JaxMPTI
from gfs3dseg_gws_tpu.models.mpti import (
    multi_prototypes as jax_multi_prototypes)
from gfs3dseg_gws_tpu.ops.fps import (
    farthest_point_sampling as jax_farthest_point_sampling)
from gfs3dseg_gws_tpu.ops.linalg import (
    label_propagate as jax_label_propagate,
    local_constrained_affinity as jax_affinity)
from gfs3dseg_gws_tpu_torch.models.mpti import MPTI, multi_prototypes
from gfs3dseg_gws_tpu_torch.ops.fps import farthest_point_sampling
from gfs3dseg_gws_tpu_torch.ops.linalg import (label_propagate,
                                               local_constrained_affinity)
from test_torch_port_baselines import (NET, _blocks, _configs, _episode,
                                       _rel, check_train_step, port_load)
from torch_port_util import one_thread, randomize_bn, set_fp32, t

pytestmark = pytest.mark.usefixtures("one_thread")

KP, K_CONNECT = 6, 16       # sub-prototypes a class, graph neighbours


def _feat(seed, m=120, d=12, dup=0):
    """(m, d) float32 features; with `dup`, rows dup.. copy rows 0.."""
    x = np.random.default_rng(seed).standard_normal((m, d)).astype(
        np.float32)
    if dup:
        x[dup:2 * dup] = x[:dup]
    return x


@pytest.mark.parametrize("case", ["all", "mask", "few_valid"])
def test_fps_bit_for_bit(case):
    """The same indices as the JAX fori_loop: over all rows, under a mask
    that leaves the first rows out, and with fewer valid rows than
    samples (the walk then repeats the first valid row)."""
    x = _feat(0, 300, 9)
    mask = None
    if case == "mask":
        mask = np.random.default_rng(1).random(300) > 0.4
        mask[:3] = False
    elif case == "few_valid":
        mask = np.zeros(300, bool)
        mask[[7, 50, 51, 299]] = True
    n = 10 if case == "few_valid" else 40
    ref = jax_farthest_point_sampling(
        jnp.asarray(x), n, None if mask is None else jnp.asarray(mask))
    got = farthest_point_sampling(t(x), n, None if mask is None else t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("method", ["gaussian", "cosine"])
def test_affinity_with_exact_duplicates(method):
    """On rows with exact copies (the ties that duplicate seeds and the
    sentinel rows make) the port keeps the JAX neighbours, lower index
    first: the same non-zero pattern, values within 1e-5; then label
    propagation on it within 1e-4."""
    set_fp32()
    x = _feat(2, 120, 12, dup=20) * 0.5
    ref = np.asarray(jax_affinity(jnp.asarray(x), K_CONNECT, 1.0, method))
    got = local_constrained_affinity(t(x), K_CONNECT, 1.0, method).numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    y = np.zeros((120, 3), np.float32)
    y[np.arange(30), np.arange(30) % 3] = 1.0
    ref_z = jax_label_propagate(jnp.asarray(ref), jnp.asarray(y))
    got_z = label_propagate(t(ref), t(y))
    assert _rel(got_z.numpy(), ref_z) < 1e-4


@pytest.mark.parametrize("valid_rows", [120, 70, 4], ids=["all", "masked",
                                                          "few"])
def test_multi_prototypes_match_jax(valid_rows):
    """Sub-prototypes within 1e-5 of JAX's: every row valid, a mask, and
    fewer valid rows than prototypes (duplicate seeds, empty clusters)."""
    x = _feat(3)
    valid = np.zeros(120, np.float32)
    valid[np.random.default_rng(4).permutation(120)[:valid_rows]] = 1.0
    ref = jax_multi_prototypes(jnp.asarray(x), jnp.asarray(valid), 8)
    got = multi_prototypes(t(x), t(valid), 8)
    assert _rel(got.numpy(), ref) < 1e-5


def jax_mpti(seed, attention=False):
    model = JaxMPTI(n_way=2, k_shot=2, n_subprototypes=KP,
                    k_connect=K_CONNECT, use_attention=attention,
                    use_pallas=False, **NET)
    rng = jax.random.PRNGKey(seed)
    variables = model.init({"params": rng, "dropout": rng},
                           *map(jnp.asarray, _episode(0)))
    return model, randomize_bn(variables, seed + 100)


def _port_mpti(variables, attention=False):
    return port_load(MPTI(n_way=2, k_shot=2, n_subprototypes=KP,
                          k_connect=K_CONNECT, use_attention=attention,
                          attn_dropout=0.0, **NET), variables)


@pytest.mark.parametrize("support", ["masked", "no_background"])
def test_mpti_forward_matches_jax(support):
    """Eval mode: query scores within 1e-4 and loss within 1e-5 relative
    of the JAX MPTI. With an all-foreground support the background
    column stays 0 on both sides (the neutralised sentinel rows)."""
    set_fp32()
    model, variables = jax_mpti(1)
    port = _port_mpti(variables)
    episode = list(_episode(5))
    if support == "no_background":
        episode[1] = np.ones_like(episode[1])
    ref_logits, ref_loss = model.apply(variables,
                                       *map(jnp.asarray, episode), False)
    port.eval()
    with torch.no_grad():
        logits, loss = port(*map(t, episode))
    assert _rel(logits.numpy(), ref_logits) < 1e-4
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    if support == "no_background":
        np.testing.assert_allclose(logits[..., 0].numpy(), 0.0, atol=1e-5)


def test_mpti_train_step_matches_jax():
    """One train step (support and query through the encoder in two calls,
    the loss's gradient through the solve): see check_train_step,
    gradients within 1e-3, running statistics within 1e-5."""
    set_fp32()
    model, variables = jax_mpti(2)
    check_train_step(_port_mpti(variables), model, variables, _episode(6),
                     1e-3, 1e-5)


@pytest.mark.parametrize("support", ["few_foreground", "no_background"])
def test_mpti_train_step_with_coinciding_prototypes_is_finite(support):
    """Two cases where prototypes coincide: a way whose support has 2
    foreground points, fewer than its sub-prototypes (its seeds repeat),
    and an all-foreground support (the background rows all copy one
    sentinel). JAX's gradient is then NaN in every parameter (it takes
    the gaussian through sqrt(d^2), whose gradient at d^2 = 0 is 0/0; on
    this draw the sentinels' d^2 rounds to 0). The port's loss equals
    JAX's within 1e-5 and its gradients are finite (ROADMAP queue 3,
    notes)."""
    set_fp32()
    model, variables = jax_mpti(2)
    episode = list(_episode(6))
    if support == "few_foreground":
        episode[1][0] = 0
        episode[1][0, 0, :2] = 1
    else:
        episode[1] = np.ones_like(episode[1])

    def loss_fn(params):
        (_, loss), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *map(jnp.asarray, episode), True, mutable=["batch_stats"])
        return loss

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(variables["params"])
    assert not any(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree_util.tree_leaves(ref_grads))
    port = _port_mpti(variables)
    port.train()
    _, loss = port(*map(t, episode))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for name, p in port.named_parameters():
        assert torch.isfinite(p.grad).all(), name


def test_mpti_test_gfs_matches_jax(tmp_path):
    """mpti_test_gfs from one MPTI checkpoint (the JAX learner's initial
    npz) with 16 base and 16 query blocks: the same base-block draws and
    supports, base, novel, mean and harmonic-mean mIoU within 1e-3 of the
    JAX package's (counts: a flipped argmax moves them)."""
    from gfs3dseg_gws_tpu.pipelines import baselines as jb
    from gfs3dseg_gws_tpu_torch.pipelines import baselines as pb

    set_fp32()
    train_dir, test_dir = _blocks(str(tmp_path / "data"), seed=6)
    fs = dict(n_way=2, k_shot=1, n_subprototypes=KP, k_connect=K_CONNECT,
              use_attention=False)
    jcfg = _configs(train_dir, "jax", log_dir=str(tmp_path / "jax"), **fs)
    pcfg = _configs(train_dir, "port", log_dir=str(tmp_path / "port"), **fs)
    ckpt = str(tmp_path / "mpti.npz")
    jb.FewShotLearner("mpti", *jcfg).save(ckpt)
    caps = dict(max_base_blocks=16, max_query_blocks=16)
    ref = jb.mpti_test_gfs(*jcfg, ckpt, test_dir, **caps)
    got = pb.mpti_test_gfs(*pcfg, ckpt, test_dir, **caps)
    assert got["base_blocks"] == got["query_blocks"] == 16
    for key in ("mean_iou", "base_iou", "novel_iou", "hm_iou"):
        assert abs(got[key] - ref[key]) <= 1e-3, key
