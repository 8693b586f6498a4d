"""PyTorch port, the slice as a whole: `evaluate_gfs` of the port (CPU,
plain kernels) against the JAX package's `evaluate_gfs` on one tiny
synthetic dataset, one basis and one reference-layout `.pth`."""
import os
import pickle

import numpy as np
import pytest

import jax

from gfs3dseg_gws_tpu.data import make_synthetic_blocks
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    set_fp32()
    root = str(tmp_path_factory.mktemp("gfs_eval"))
    train_dir, test_dir = make_synthetic_blocks(
        root, n_train_blocks=20, n_test_blocks=13, points_per_block=600,
        seed=21)
    basis = np.random.default_rng(22).standard_normal((NUM_GW, 24)).astype(
        np.float32)
    basis_path = os.path.join(root, "basis.pkl")
    with open(basis_path, "wb") as f:
        pickle.dump(basis, f)
    _, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=3)
    pth = os.path.join(root, "ckpt", "model.pth")
    save_torch_gfs_checkpoint(jax.device_get(variables["params"]),
                              jax.device_get(variables["batch_stats"]), pth)

    common = dict(basis_path=basis_path, model_checkpoint_path=pth,
                  only_evaluate=True, eval_weight=1.2, batch_size=8)
    data = dict(dataset="s3dis", cvfold=0, data_path=train_dir,
                testing_data_path=test_dir, pc_npts=NPTS, k_shot=K_SHOT)

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
        setup.test_class_names, 13, batch_size=8)

    port = port_gfs.evaluate_gfs(
        ModelConfig(**WIDTHS), DataConfig(**data),
        TrainConfig(save_path=os.path.join(root, "port"), device="cpu",
                    **common))
    return dict(jax_avg=jax_avg, jax_base=jax_base, jax_geneds=jax_geneds,
                jax_novel=jax_novel,
                jax_seeds=np.asarray([m[:4] for m in jax_seeds]), port=port)


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
