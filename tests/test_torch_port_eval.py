"""PyTorch port, the slice as a whole: `evaluate_gfs` of the port (CPU,
plain kernels) against the JAX package's `evaluate_gfs` on one tiny
synthetic dataset, one basis and one reference-layout `.pth`, at the S3DIS
setup and at the ScanNet setup (21 classes, class 0 left out of every
aggregate)."""
import os
import pickle

import numpy as np
import pytest

import jax

from gfs3dseg_gws_tpu.data import make_synthetic_blocks
from gfs3dseg_gws_tpu.data.registry import SCANNET_CLASSNAMES
from gfs3dseg_gws_tpu.pipelines import gfs as jax_gfs
from gfs3dseg_gws_tpu.utils.checkpoint import save_torch_gfs_checkpoint
from gfs3dseg_gws_tpu.utils.config import (DataConfig as JaxDataConfig,
                                           ModelConfig as JaxModelConfig,
                                           TrainConfig as JaxTrainConfig)
from gfs3dseg_gws_tpu_torch.pipelines import gfs as port_gfs
from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                 TrainConfig)
from torch_port_util import TINY, jax_capl, one_thread, set_fp32

pytestmark = pytest.mark.usefixtures("one_thread")

NPTS, NUM_GW, K_SHOT = 96, 10, 2
WIDTHS = dict(edgeconv_widths=TINY["edgeconv_widths"],
              dgcnn_mlp_widths=TINY["mlp_widths"],
              base_widths=TINY["base_widths"], output_dim=TINY["output_dim"],
              main_dim=TINY["main_dim"], dgcnn_k=TINY["k"], pc_npts=NPTS)
MIOU_TOL = 2e-3


def evaluate_both(root, dataset, n_train, n_test, points, classnames=None):
    """`evaluate_gfs` of both packages on one synthetic dataset of
    `dataset`'s layout, one basis and one reference-layout `.pth`; the
    JAX package's per-seed metrics from its own registration and sweep."""
    set_fp32()
    n_classes = len(classnames) if classnames else 13
    train_dir, test_dir = make_synthetic_blocks(
        root, dataset=dataset, n_train_blocks=n_train, n_test_blocks=n_test,
        points_per_block=points, n_classes=n_classes, seed=21,
        classnames=classnames)
    basis = np.random.default_rng(22).standard_normal((NUM_GW, 24)).astype(
        np.float32)
    basis_path = os.path.join(root, "basis.pkl")
    with open(basis_path, "wb") as f:
        pickle.dump(basis, f)
    base_num = {"s3dis": 7, "scannet": 15}[dataset]
    _, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=3,
                            classes=n_classes, base_num=base_num)
    pth = os.path.join(root, "ckpt", "model.pth")
    save_torch_gfs_checkpoint(jax.device_get(variables["params"]),
                              jax.device_get(variables["batch_stats"]), pth)

    common = dict(basis_path=basis_path, model_checkpoint_path=pth,
                  only_evaluate=True, eval_weight=1.2, batch_size=8)
    data = dict(dataset=dataset, cvfold=0, data_path=train_dir,
                testing_data_path=test_dir, pc_npts=NPTS, k_shot=K_SHOT,
                total_classes=n_classes)

    jax_cfgs = (JaxModelConfig(use_pallas=False, **WIDTHS),
                JaxDataConfig(**data),
                JaxTrainConfig(save_path=os.path.join(root, "jax"), **common))
    jax_avg = jax_gfs.evaluate_gfs(*jax_cfgs, mesh=None)
    with np.load(os.path.join(root, "jax",
                              "base_class_gp_coding_energy=0.9.npz")) as z:
        jax_base = z["coding"]
    # the registered prototypes and per-seed metrics behind jax_avg
    setup = jax_gfs.build_setup(*jax_cfgs, basis)
    main_proto = np.asarray(variables["params"]["main_proto"])
    reg = [jax_gfs.register_novel_protos(
        setup.model, variables, setup.gp, supp, main_proto,
        len(setup.train_class_names), setup.test_learning_order_idx, 0.9)
        for supp in setup.supp_datasets]
    jax_geneds = np.stack([g for g, _ in reg])
    jax_novel = np.stack([c for _, c in reg])
    jax_seeds = jax_gfs.validate_multi(
        setup.model, variables, setup.gp, setup.val_dataset, jax_geneds,
        jax_base, jax_novel, setup.all_learning_order,
        setup.test_class_names, n_classes, batch_size=8,
        scannet=dataset == "scannet")

    port = port_gfs.evaluate_gfs(
        ModelConfig(**WIDTHS), DataConfig(**data),
        TrainConfig(save_path=os.path.join(root, "port"), device="cpu",
                    **common))
    return dict(jax_avg=jax_avg, jax_base=jax_base, jax_geneds=jax_geneds,
                jax_novel=jax_novel,
                jax_seeds=np.asarray([m[:4] for m in jax_seeds]), port=port,
                train_classes=list(setup.train_class_names))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return evaluate_both(str(tmp_path_factory.mktemp("gfs_eval")), "s3dis",
                         20, 13, 600)


@pytest.fixture(scope="module")
def scannet_runs(tmp_path_factory):
    """The ScanNet setup: 21 classes with class 0 ("unannotated") a base
    class that every aggregate leaves out (reference runs/eval.py:79-106),
    15 base and 6 novel classes (fold 0)."""
    return evaluate_both(str(tmp_path_factory.mktemp("gfs_eval_scannet")),
                         "scannet", 30, 19, 1200, SCANNET_CLASSNAMES)


def test_base_codings_identical(runs):
    np.testing.assert_array_equal(runs["port"]["base_coding"],
                                  runs["jax_base"])


def test_novel_codings_identical(runs):
    np.testing.assert_array_equal(runs["port"]["novel_codings"],
                                  runs["jax_novel"])


def test_registered_prototypes_agree(runs):
    np.testing.assert_allclose(runs["port"]["gened_protos"],
                               runs["jax_geneds"], rtol=1e-5, atol=1e-5)


def test_every_seed_miou_agrees(runs):
    port = runs["port"]["per_seed"]
    assert port.shape == (5, 4) and np.isfinite(port).all()
    np.testing.assert_allclose(port, runs["jax_seeds"], rtol=0,
                               atol=MIOU_TOL)


def test_seed_averaged_miou_agrees(runs):
    port, ref = runs["port"], runs["jax_avg"]
    for key in ("mean_iou", "base_iou", "novel_iou", "hm_iou"):
        assert abs(port[key] - ref[key]) <= MIOU_TOL, key
    np.testing.assert_allclose(port["per_class"], ref["per_class"], rtol=0,
                               atol=MIOU_TOL)
    assert port["n_blocks"] == 13


def test_scannet_every_seed_miou_agrees(scannet_runs):
    port = scannet_runs["port"]["per_seed"]
    assert port.shape == (5, 4) and np.isfinite(port).all()
    np.testing.assert_allclose(port, scannet_runs["jax_seeds"], rtol=0,
                               atol=MIOU_TOL)
    ref = scannet_runs["jax_avg"]
    for key in ("mean_iou", "base_iou", "novel_iou", "hm_iou"):
        assert abs(scannet_runs["port"][key] - ref[key]) <= MIOU_TOL, key
    np.testing.assert_array_equal(scannet_runs["port"]["base_coding"],
                                  scannet_runs["jax_base"])


def test_scannet_leaves_class_0_out(scannet_runs):
    """per_class holds classes 1-20 only, and the mean, base and novel
    mIoUs are their means (base: the 14 base classes other than 0)."""
    port = scannet_runs["port"]
    per_class = port["per_class"]
    assert per_class.shape == (20,) and np.isfinite(per_class).all()
    np.testing.assert_allclose(per_class, scannet_runs["jax_avg"]
                               ["per_class"], rtol=0, atol=MIOU_TOL)
    base = [c for c in scannet_runs["train_classes"] if c != 0]
    novel = [c for c in range(1, 21) if c not in base]
    assert 0 in scannet_runs["train_classes"] and len(base) == 14
    assert len(novel) == 6
    assert abs(port["mean_iou"] - per_class.mean()) <= 1e-12
    assert abs(port["base_iou"] - per_class[[c - 1 for c in base]].mean()
               ) <= 1e-12
    assert abs(port["novel_iou"] - per_class[[c - 1 for c in novel]].mean()
               ) <= 1e-12
    assert port["n_blocks"] == 19
