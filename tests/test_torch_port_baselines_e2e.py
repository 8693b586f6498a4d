"""PyTorch port, few-shot baselines slice, the pipelines end to end
against the JAX package on the CPU: `episodic_train` -> `episodic_eval`
with the checkpoints read both ways, FineTune, and the CLI's six baseline
phases.

Inputs are drawn with numpy; JAX models use use_pallas=False (the XLA
path). Tolerances are max |got - ref| / max |ref| unless stated.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfs3dseg_gws_tpu_torch.models.protonet import ProtoNet
from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
    fewshot_state_dict_from_jax)
from test_torch_port_baselines import (NET, NPTS, TINY_ARGS, _blocks,
                                       _configs, _rel)
from torch_port_util import one_thread, randomize_bn, set_fp32

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return _blocks(str(tmp_path_factory.mktemp("fs")))


# --------------------------------------------------------------------------- #
# (c) episodic training and evaluation end to end, checkpoints both ways
# --------------------------------------------------------------------------- #

def _assert_same_weights(sd, ref, atol):
    assert set(sd) == set(ref)
    for name, value in ref.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[name].numpy(), value.numpy(),
                                       rtol=0, atol=atol, err_msg=name)


def _assert_trained_alike(sd, ref, lr, steps):
    """Weights after `steps` Adam steps from one initialisation: each
    tensor within 5e-3 of its largest entry, except the base learner's
    conv biases and the running means of the BatchNorms after them.
    Train-mode BatchNorm takes each bias out again, so its gradient is
    zero up to rounding, and Adam turns each package's own rounding into
    steps of about lr either way: those only stay within 2 lr a step."""
    for name, value in ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        got = sd[name].numpy()
        if name.startswith("base_learner.") and name.endswith(
                (".0.bias", "running_mean")):
            assert np.abs(got - value.numpy()).max() <= 2 * lr * steps, name
        else:
            assert _rel(got, value.numpy(), 1e-6) < 5e-3, name


def test_episodic_train_and_eval_match_jax(synth, tmp_path):
    """ProtoNet (linear mapper, cosine, no dropout anywhere) from one
    shared initialisation (the JAX learner's checkpoint.npz, loaded
    strictly by the port): three episodes of episodic_train with a
    validation after each give the JAX package's mIoU history within
    5e-3 and its weights as _assert_trained_alike holds them (the mIoU is
    a count: the base learner's biases, which Adam moves by each
    package's rounding, flip the argmax of a few of the 2,880 query
    points; 1.2e-3 was seen); the best checkpoint.npz the port writes is
    restored strictly by the JAX learner, bit for bit; the port's learner
    loads the JAX run's checkpoint.npz and a reference-format
    checkpoint.tar strictly, bit for bit; episodic_eval from one
    checkpoint gives the JAX mIoU within 1e-3."""
    from gfs3dseg_gws_tpu.pipelines import baselines as jb
    from gfs3dseg_gws_tpu.utils.checkpoint import (
        save_torch_fewshot_checkpoint as jax_save_tar)
    from gfs3dseg_gws_tpu_torch.pipelines import baselines as pb
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
        load_torch_fewshot_checkpoint)

    set_fp32()
    train_dir = synth[0]
    fs = dict(n_way=2, k_shot=1, n_iters=3, eval_interval=1,
              n_episode_test=1, dist_method="cosine", use_attention=False,
              lr=0.01)
    jcfg = _configs(train_dir, "jax", log_dir=str(tmp_path / "jax"), **fs)
    pcfg = _configs(train_dir, "port", log_dir=str(tmp_path / "port"), **fs)
    init = str(tmp_path / "init.npz")
    jb.FewShotLearner("proto", *jcfg).save(init)

    ref = jb.episodic_train("proto", *jcfg, model_checkpoint_path=init,
                            bank_episodes=1)
    got = pb.episodic_train("proto", *pcfg, model_checkpoint_path=init,
                            bank_episodes=1)
    assert [h["iteration"] for h in got["history"]] == [1, 2, 3]
    np.testing.assert_allclose([h["miou"] for h in got["history"]],
                               [h["miou"] for h in ref["history"]],
                               rtol=0, atol=5e-3)
    assert len(got["train_losses"]) == 3
    assert all(np.isfinite(got["train_losses"]))

    # the port's best checkpoint.npz, restored strictly by the JAX learner
    port_npz = os.path.join(pcfg[2].log_dir, "checkpoint.npz")
    back = jb.FewShotLearner("proto", *jcfg, model_checkpoint_path=port_npz)
    port_best = load_torch_fewshot_checkpoint(pcfg[2].log_dir)
    _assert_same_weights(fewshot_state_dict_from_jax(
        jax.device_get(back.params), jax.device_get(back.batch_stats)),
        port_best, 0)
    # the JAX run's final weights, written by JAX as npz and as a
    # reference-format tar, loaded strictly by the port
    learner = ref["learner"]
    jax_sd = fewshot_state_dict_from_jax(jax.device_get(learner.params),
                                         jax.device_get(learner.batch_stats))
    _assert_trained_alike(got["learner"].model.state_dict(), jax_sd,
                          fs["lr"], fs["n_iters"])
    learner.save(str(tmp_path / "jax_final.npz"))
    jax_save_tar(learner.params, learner.batch_stats,
                 str(tmp_path / "jax_tar"))
    for path in (str(tmp_path / "jax_final.npz"), str(tmp_path / "jax_tar")):
        loaded = pb.FewShotLearner("proto", *pcfg,
                                   model_checkpoint_path=path)
        _assert_same_weights(loaded.model.state_dict(), jax_sd, 0)

    ref_eval = jb.episodic_eval("proto", *jcfg, port_npz, bank_episodes=1)
    for path in (port_npz, pcfg[2].log_dir):
        got_eval = pb.episodic_eval("proto", *pcfg, path, bank_episodes=1)
        assert abs(got_eval["mean_iou"] - ref_eval) <= 1e-3
        assert got_eval["episodes"] == 15


def test_fewshot_tar_refuses_a_pretrain_checkpoint(tmp_path):
    """A pre-training checkpoint.tar given as the model checkpoint raises,
    as in JAX; the same tar as the pretrain checkpoint loads the encoder."""
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
        load_torch_fewshot_checkpoint)

    port = ProtoNet(n_way=2, k_shot=1,
                    generator=torch.Generator().manual_seed(0), **NET)
    os.makedirs(tmp_path / "pre")
    torch.save({"params": {k[len("encoder."):]: v for k, v in
                           port.state_dict().items()
                           if k.startswith("encoder.")}},
               tmp_path / "pre" / "checkpoint.tar")
    with pytest.raises(ValueError, match="pre-training"):
        load_torch_fewshot_checkpoint(str(tmp_path / "pre"))


# --------------------------------------------------------------------------- #
# (d) FineTune
# --------------------------------------------------------------------------- #

def test_finetune_matches_jax(synth, tmp_path, monkeypatch):
    """FineTune at dropout 0 for two episodes of three inner steps from one
    initialisation (the JAX initial DGCNNSeg, then the same pre-trained
    encoder): every inner-step loss within 1e-4 relative of JAX's (the
    second episode's restart Adam from zero, as JAX's do, while the
    parameters carry over); after each episode the encoder's parameters
    unchanged and its running statistics within 1e-5, the segmenter's
    tensors within 2e-3 in relative L2 norm (Adam turns near-zero
    gradients into steps of about lr either way: up to 0.019 was seen in
    a few of segmenter.3's 32,768 weights, 2.6e-4 of the largest in the
    last conv's)
    and the conv bias before its second BatchNorm, whose gradient is zero
    up to rounding, within 2 lr a step; the final mIoU within 1e-3."""
    from gfs3dseg_gws_tpu.models.dgcnnseg import DGCNNSeg as JaxDGCNNSeg
    from gfs3dseg_gws_tpu.parallel.steps import jit_init
    from gfs3dseg_gws_tpu.pipelines import baselines as jb
    from gfs3dseg_gws_tpu.utils.checkpoint import save_checkpoint
    from gfs3dseg_gws_tpu_torch.pipelines import baselines as pb
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
        pretrain_state_dict_from_jax)

    set_fp32()
    train_dir = synth[0]
    fs = dict(n_way=2, k_shot=1, n_episode_test=1, lr=0.01, seed=5)
    jcfg = _configs(train_dir, "jax", log_dir=str(tmp_path / "jax"), **fs)
    pcfg = _configs(train_dir, "port", log_dir=str(tmp_path / "port"), **fs)

    # the pre-trained encoder: a random DGCNNSeg with random BN statistics
    pre = JaxDGCNNSeg(num_classes=8, edgeconv_widths=NET["edgeconv_widths"],
                      mlp_widths=NET["mlp_widths"], k=5, use_pallas=False)
    rng = jax.random.PRNGKey(9)
    pre_vars = randomize_bn(pre.init({"params": rng, "dropout": rng},
                                     jnp.zeros((1, NPTS, 9)), True), 19)
    pre_path = str(tmp_path / "pre.npz")
    save_checkpoint(pre_path, pre_vars)

    # JAX's own initialisation inside finetune, made the same way here
    n_cls = fs["n_way"] + 1
    init_model = JaxDGCNNSeg(num_classes=n_cls, use_pallas=False,
                             edgeconv_widths=NET["edgeconv_widths"],
                             mlp_widths=NET["mlp_widths"], k=5, dropout=0.0)
    rng = jax.random.PRNGKey(fs["seed"])
    init = jit_init(init_model, {"params": rng, "dropout": rng},
                    jnp.zeros((2, NPTS, 9)), True)

    seen = {"loss": [], "params": []}
    make_loop = jb.make_finetune_loop

    def spy_loop(model_cfg, fs_cfg, n_cls_):
        model, tx, inner_step, test_step = make_loop(model_cfg, fs_cfg,
                                                     n_cls_, dropout=0.0)

        def inner(*args):
            out = inner_step(*args)
            seen["loss"].append(float(out[-1]))
            return out

        def test(params, batch_stats, qx, qy):
            seen["params"].append(jax.device_get((params, batch_stats)))
            return test_step(params, batch_stats, qx, qy)

        return model, tx, inner, test

    monkeypatch.setattr(jb, "make_finetune_loop", spy_loop)
    ref_miou = jb.finetune(*jcfg, pretrain_checkpoint_path=pre_path,
                           inner_iters=3, max_episodes=2, bank_episodes=1)

    got_sd = []
    loop = pb.make_finetune_loop
    init_sd = pretrain_state_dict_from_jax(jax.device_get(init["params"]),
                                           jax.device_get(
                                               init["batch_stats"]))

    def port_loop(model_cfg, fs_cfg, n_cls_, device):
        model, new_opt, inner_step, test_step = loop(
            model_cfg, fs_cfg, n_cls_, dropout=0.0, device=device)
        model.load_state_dict(init_sd, strict=True)

        def test(qx, qy):
            got_sd.append({k: v.clone() for k, v in
                           model.state_dict().items()})
            return test_step(qx, qy)

        return model, new_opt, inner_step, test

    monkeypatch.setattr(pb, "make_finetune_loop", port_loop)
    got = pb.finetune(*pcfg, pretrain_checkpoint_path=pre_path,
                      inner_iters=3, max_episodes=2, bank_episodes=1)
    np.testing.assert_allclose(got["losses"], seen["loss"], rtol=1e-4)
    assert len(got_sd) == len(seen["params"]) == 2
    pre_sd = pretrain_state_dict_from_jax(jax.device_get(pre_vars["params"]),
                                          jax.device_get(
                                              pre_vars["batch_stats"]))
    for sd, (params, stats) in zip(got_sd, seen["params"]):
        ref = pretrain_state_dict_from_jax(params, stats)
        for name, value in ref.items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.startswith("encoder.") and not name.endswith(
                    ("running_mean", "running_var")):
                torch.testing.assert_close(sd[name], pre_sd[name], rtol=0,
                                           atol=0, msg=name)
            got_v, ref_v = sd[name].numpy(), value.numpy()
            if name.startswith("encoder."):
                assert _rel(got_v, ref_v) < 1e-5, name
            elif name in ("segmenter.3.bias", "segmenter.4.running_mean"):
                # the bias before a train-mode BatchNorm: see
                # _assert_trained_alike
                assert np.abs(got_v - ref_v).max() <= 2 * fs["lr"] * 3, name
            else:
                assert (np.linalg.norm(got_v - ref_v)
                        / np.linalg.norm(ref_v)) < 2e-3, name
    assert abs(got["mean_iou"] - ref_miou) <= 1e-3


# --------------------------------------------------------------------------- #
# (e) the CLI runs the baseline phases
# --------------------------------------------------------------------------- #

def test_pretrain_cli_runs_every_baseline_phase(tmp_path):
    """prototrain -> protoeval, mptitrain -> mptieval, mptigfs and finetune
    through the port's pretrain_cli on the CPU at the tiny widths: finite
    mIoUs and losses, the JAX CLI's log-dir names, each train phase's
    checkpoint.npz and checkpoint.tar."""
    from gfs3dseg_gws_tpu_torch.cli import pretrain_cli

    train_dir, test_dir = _blocks(str(tmp_path / "data"), seed=4)
    save = str(tmp_path / "runs") + "/"
    common = TINY_ARGS + ["--data_path", train_dir, "--n_way", "2",
                          "--k_shot", "1", "--n_episode_test", "1"]
    mpti = ["--n_subprototypes", "8", "--k_connect", "16"]
    res = pretrain_cli.main(["--phase", "prototrain", "--save_path", save,
                             "--n_iters", "2", "--eval_interval", "1",
                             "--use_attention"] + common)
    proto_dir = save + "log_proto_s3dis_S0_N2_K1_TL0_Att1"
    assert [h["iteration"] for h in res["history"]] == [1, 2]
    for name in ("checkpoint.npz", "checkpoint.tar", "log_prototrain.txt"):
        assert os.path.exists(os.path.join(proto_dir, name)), name
    res = pretrain_cli.main(["--phase", "protoeval", "--model_checkpoint_path",
                             proto_dir, "--use_attention"] + common)
    assert np.isfinite(res["mean_iou"]) and np.isfinite(res["loss"])
    res = pretrain_cli.main(["--phase", "mptitrain", "--save_path", save,
                             "--n_iters", "1", "--eval_interval", "1",
                             "--log_dir", "x"] + common + mpti)
    mpti_dir = os.path.join(save, "log_mpti_S0_N2_K1_Att0_x")
    assert np.isfinite(res["train_losses"]).all()
    res = pretrain_cli.main(["--phase", "mptieval", "--model_checkpoint_path",
                             mpti_dir] + common + mpti)
    assert np.isfinite(res["mean_iou"]) and np.isfinite(res["loss"])
    res = pretrain_cli.main(["--phase", "mptigfs", "--model_checkpoint_path",
                             os.path.join(mpti_dir, "checkpoint.npz"),
                             "--testing_data_path", test_dir, "--save_path",
                             save + "gfs"] + common + mpti,
                            max_base_blocks=16, max_query_blocks=16)
    assert all(np.isfinite(res[k]) for k in ("mean_iou", "hm_iou"))
    res = pretrain_cli.main(["--phase", "finetune", "--save_path", save,
                             "--n_iters", "2"] + common, max_episodes=1)
    assert np.isfinite(res["mean_iou"]) and len(res["losses"]) == 2
    assert os.path.exists(save + "log_finetune_s3dis_S0_N2_K1/"
                                 "log_finetune.txt")
