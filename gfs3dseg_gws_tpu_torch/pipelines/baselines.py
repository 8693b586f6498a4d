"""The legacy few-shot baselines: ProtoNet and MPTI training and
evaluation, MPTI's GFS-style evaluation, and FineTune (counterpart of the
JAX package's pipelines/baselines.py; reference pretrain/runs/
{proto_train,mpti_train,eval,fine_tune}.py and mpti_learner.py).

`episodic_train` (`pretrain_cli --phase prototrain | mptitrain`) trains a
`ProtoNet` or `MPTI` one episode an iteration (Adam, the encoder at 1e-4
and the heads at `lr`, StepLR on the iteration count), validates on a
static episode bank every `eval_interval` iterations and at the last, and
keeps the best checkpoint by the classic few-shot mIoU. `episodic_eval`
(`protoeval | mptieval`) scores a checkpoint on the test bank.
`mpti_test_gfs` (`mptigfs`) scores MPTI in the GFS setting: multi-
prototypes of every base class from the training blocks and of every novel
class from the static supports, label propagation over them and each query
block's points. `finetune` (`finetune`) trains a fresh segmenter head over
a frozen pre-trained encoder on each test episode's support and scores the
query.

Every model runs on `fs_cfg.device` through the port's kernels: K3, K4a,
K4b (and K5a/K5b with attention) in each train episode, K1 (and K2) in
each eval forward; FineTune's frozen encoder runs K3 and K4a without K4b.
The episode draws are the JAX package's (`np.random.default_rng((seed,
it))` for training, `LegacyRNG(seed)` for the banks); the dropout streams
are torch's, seeded by the iteration.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from gfs3dseg_gws_tpu_torch.data import (PretrainBlockDataset, TestingDataset,
                                         ValSuppDataset, make_registry)
from gfs3dseg_gws_tpu_torch.data.episodes import (EpisodeDataset,
                                                  StaticEpisodeBank)
from gfs3dseg_gws_tpu_torch.data.sampler import LegacyRNG
from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy
from gfs3dseg_gws_tpu_torch.models.mpti import MPTI, multi_prototypes
from gfs3dseg_gws_tpu_torch.models.protonet import ProtoNet
from gfs3dseg_gws_tpu_torch.ops.linalg import (label_propagate,
                                               local_constrained_affinity)
from gfs3dseg_gws_tpu_torch.ops.metrics import (confusion_matrix,
                                                fewshot_accumulate,
                                                fewshot_miou, gfs_miou)
from gfs3dseg_gws_tpu_torch.parallel.optim import make_fewshot_optimizer
from gfs3dseg_gws_tpu_torch.parallel.steps import (fewshot_test_step,
                                                   fewshot_train_step)
from gfs3dseg_gws_tpu_torch.pipelines.gfs import (LOSS_LAG, _to,
                                                  resolve_device)
from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
    fewshot_state_dict_from_jax, load_checkpoint, load_pretrained_encoder,
    load_torch_fewshot_checkpoint, save_fewshot_npz,
    save_torch_fewshot_checkpoint)
from gfs3dseg_gws_tpu_torch.utils.logging import IOStream, init_logger


@dataclass(frozen=True)
class FewShotConfig:
    """The JAX package's fields and defaults (reference
    pretrain/main.py:36-91), plus the torch `device`. `h2d` is accepted
    for the JAX CLI's sake and has no effect."""

    n_way: int = 2
    k_shot: int = 1
    n_queries: int = 1
    n_iters: int = 30_000
    lr: float = 0.001
    step_size: int = 5000
    gamma: float = 0.5
    eval_interval: int = 1500
    n_episode_test: int = 100
    dist_method: str = "euclidean"
    n_subprototypes: int = 100
    k_connect: int = 200
    sigma: float = 1.0
    use_attention: bool = True
    log_dir: str = "log_fewshot"
    seed: int = 321
    h2d: str = "auto"
    device: str = "cuda"


def _build_model(kind: str, model_cfg, fs_cfg: FewShotConfig,
                 generator: Optional[torch.Generator] = None):
    kw = dict(n_way=fs_cfg.n_way, k_shot=fs_cfg.k_shot,
              in_features=model_cfg.pc_in_dim,
              edgeconv_widths=model_cfg.edgeconv_widths,
              mlp_widths=model_cfg.dgcnn_mlp_widths,
              base_widths=model_cfg.base_widths,
              output_dim=model_cfg.output_dim, k=model_cfg.dgcnn_k,
              use_attention=fs_cfg.use_attention,
              attn_dropout=model_cfg.attn_dropout, generator=generator)
    if kind == "proto":
        return ProtoNet(dist_method=fs_cfg.dist_method, **kw)
    if kind == "mpti":
        return MPTI(n_subprototypes=fs_cfg.n_subprototypes,
                    k_connect=fs_cfg.k_connect, sigma=fs_cfg.sigma, **kw)
    raise ValueError(kind)


def _bank(data_cfg, fs_cfg: FewShotConfig, mode: str,
          bank_episodes: Optional[int]) -> StaticEpisodeBank:
    return StaticEpisodeBank(
        data_cfg.data_path, data_cfg.dataset, cvfold=data_cfg.cvfold,
        num_episode_per_comb=bank_episodes or fs_cfg.n_episode_test,
        n_way=fs_cfg.n_way, k_shot=fs_cfg.k_shot, n_queries=fs_cfg.n_queries,
        num_point=data_cfg.pc_npts, pc_attribs=data_cfg.pc_attribs,
        mode=mode)


def _log_bank(logger: IOStream, bank: StaticEpisodeBank) -> None:
    logger.cprint(f"episode bank {bank.bank_path}: {len(bank)} episodes, "
                  f"format {bank.format}")


class FewShotLearner:
    """A ProtoNet or MPTI with its optimizer, on `fs_cfg.device`.

    Weights: the JAX package's initialisers from a CPU generator seeded
    `fs_cfg.seed`; then `model_checkpoint_path` (the reference's episodic
    `checkpoint.tar` or its directory, else a few-shot `checkpoint.npz` of
    the JAX package or the port), or else `pretrain_checkpoint_path` into
    the encoder only (JAX: FewShotLearner.__init__). Every load is strict.
    """

    def __init__(self, kind: str, model_cfg, data_cfg, fs_cfg: FewShotConfig,
                 pretrain_checkpoint_path: str = "",
                 model_checkpoint_path: str = ""):
        self.device = resolve_device(fs_cfg.device)
        self.model = _build_model(kind, model_cfg, fs_cfg,
                                  torch.Generator().manual_seed(fs_cfg.seed))
        if model_checkpoint_path:
            if model_checkpoint_path.endswith(".tar") or os.path.exists(
                    os.path.join(model_checkpoint_path, "checkpoint.tar")):
                sd = load_torch_fewshot_checkpoint(model_checkpoint_path)
            else:
                sd = fewshot_state_dict_from_jax(
                    load_checkpoint(model_checkpoint_path)[0])
            self.model.load_state_dict(sd, strict=True)
        elif pretrain_checkpoint_path:
            self.model.encoder.load_state_dict(
                load_pretrained_encoder(pretrain_checkpoint_path),
                strict=True)
        self.model.to(self.device)
        self.opt, self.sched = make_fewshot_optimizer(
            self.model, fs_cfg.lr, fs_cfg.step_size, fs_cfg.gamma)

    def _episode_args(self, episode):
        sx, sy, qx, qy = episode[:4]
        return (_to(self.device, sx, np.float32),
                _to(self.device, sy, np.int64),
                _to(self.device, qx, np.float32),
                _to(self.device, qy, np.int64))

    def train_async(self, episode, generator: Optional[torch.Generator]
                    = None):
        """One episodic update; returns (loss, accuracy) as device tensors,
        so the caller reads them when it likes."""
        return fewshot_train_step(self.model, self.opt,
                                  *self._episode_args(episode), generator,
                                  self.sched)

    def test(self, episode):
        """(pred, confusion counts, loss, accuracy) of one eval episode, as
        device tensors."""
        return fewshot_test_step(self.model, *self._episode_args(episode))

    def save(self, log_dir: str, meta: Dict) -> None:
        """`checkpoint.npz` (the JAX package's layout) and `checkpoint.tar`
        (the reference's) into `log_dir`; meta holds iteration, IoU and
        loss."""
        save_fewshot_npz(self.model, os.path.join(log_dir, "checkpoint.npz"),
                         meta)
        save_torch_fewshot_checkpoint(self.model.state_dict(), log_dir,
                                      meta.get("iteration", 0),
                                      meta.get("IoU", 0.0),
                                      meta.get("loss", 0.0))


def test_few_shot(bank: StaticEpisodeBank, learner: FewShotLearner, logger,
                  test_classes) -> tuple:
    """Every episode of `bank` through `learner.test`, the counts added on
    the device and read once (reference pretrain/runs/eval.py:175-202).
    Returns (mean loss, few-shot mean IoU)."""
    num_global = len(test_classes) + 1
    cm_global = torch.zeros((num_global, num_global), dtype=torch.float64,
                            device=learner.device)
    total_loss = torch.zeros((), dtype=torch.float64, device=learner.device)
    for i in range(len(bank)):
        episode = bank[i]
        _, cm, loss, _ = learner.test(episode)
        total_loss += loss
        fewshot_accumulate(cm_global, cm, episode[4], test_classes)
        if (i + 1) % 50 == 0:
            logger.cprint(f"[Eval] Iter: {i + 1} | Loss: {float(loss):.4f}")
    mean_iou, iou = fewshot_miou(cm_global.cpu().numpy())
    for c, v in enumerate(iou):
        logger.cprint(f"----- [class {c}]  IoU: {v:f} -----")
    return float(total_loss) / max(len(bank), 1), mean_iou


def episodic_train(kind: str, model_cfg, data_cfg, fs_cfg: FewShotConfig,
                   pretrain_checkpoint_path: str = "",
                   model_checkpoint_path: str = "",
                   logger: Optional[IOStream] = None,
                   max_iters: Optional[int] = None,
                   bank_episodes: Optional[int] = None) -> Dict:
    """prototrain / mptitrain (reference proto_train.py:17-80).

    Returns {"best_iou", "history" (one {"iteration", "miou", "loss"} a
    validation), "learner", "train_losses" (one an iteration),
    "train_seconds" (host wall of the training episodes, validation
    excluded), "episodes"}.
    """
    logger = logger or init_logger(fs_cfg.log_dir, phase=f"{kind}train")
    learner = FewShotLearner(kind, model_cfg, data_cfg, fs_cfg,
                             pretrain_checkpoint_path, model_checkpoint_path)
    train_ds = EpisodeDataset(
        data_cfg.data_path, data_cfg.dataset, cvfold=data_cfg.cvfold,
        num_episode=fs_cfg.n_iters, n_way=fs_cfg.n_way, k_shot=fs_cfg.k_shot,
        n_queries=fs_cfg.n_queries, mode="train",
        num_point=data_cfg.pc_npts, pc_attribs=data_cfg.pc_attribs,
        pc_augm=data_cfg.pc_augm, pc_augm_config=data_cfg.augment_config)
    bank = _bank(data_cfg, fs_cfg, "valid", bank_episodes)
    _log_bank(logger, bank)
    valid_classes = sorted(bank.classes.tolist())

    best_iou = -1.0
    history = []
    losses: List[float] = []
    pending = []
    train_seconds = 0.0
    n_iters = min(fs_cfg.n_iters, max_iters or fs_cfg.n_iters)
    t0 = time.perf_counter()
    for it in range(n_iters):
        episode = train_ds.__getitem__(it, rng=np.random.default_rng(
            (fs_cfg.seed, it)))
        gen = torch.Generator(device=learner.device).manual_seed(it)
        pending.append(learner.train_async(episode, gen))
        if (it + 1) % 50 == 0 or it == 0:
            loss, acc = (float(v) for v in pending[-1])
            logger.cprint(f"=====[Train] Iter: {it} | Loss: {loss:.4f} | "
                          f"Accuracy: {acc:f} =====")
        while len(pending) > LOSS_LAG:
            losses.append(float(pending.pop(0)[0]))
        if (it + 1) % fs_cfg.eval_interval == 0 or it + 1 == n_iters:
            while pending:
                losses.append(float(pending.pop(0)[0]))
            train_seconds += time.perf_counter() - t0
            valid_loss, mean_iou = test_few_shot(bank, learner, logger,
                                                 valid_classes)
            logger.cprint(f"\n=====[VALID] Loss: {valid_loss:.4f} | "
                          f"Mean IoU: {mean_iou:f} =====\n")
            history.append({"iteration": it + 1, "miou": float(mean_iou),
                            "loss": valid_loss})
            if mean_iou > best_iou:
                best_iou = mean_iou
                logger.cprint("*******************Model Saved****************")
                learner.save(fs_cfg.log_dir, {"iteration": it + 1,
                                              "IoU": best_iou,
                                              "loss": valid_loss})
            t0 = time.perf_counter()
    return {"best_iou": best_iou, "history": history, "learner": learner,
            "train_losses": losses, "train_seconds": train_seconds,
            "episodes": n_iters}


def episodic_eval(kind: str, model_cfg, data_cfg, fs_cfg: FewShotConfig,
                  model_checkpoint_path: str,
                  logger: Optional[IOStream] = None, mode: str = "test",
                  bank_episodes: Optional[int] = None) -> Dict:
    """protoeval / mptieval (reference pretrain/runs/eval.py:205-223).
    Returns {"mean_iou", "loss", "episodes", "seconds"} (the host wall of
    the bank's sweep)."""
    logger = logger or init_logger(fs_cfg.log_dir, phase=f"{kind}eval")
    learner = FewShotLearner(kind, model_cfg, data_cfg, fs_cfg,
                             model_checkpoint_path=model_checkpoint_path)
    bank = _bank(data_cfg, fs_cfg, mode, bank_episodes)
    _log_bank(logger, bank)
    t0 = time.perf_counter()
    test_loss, mean_iou = test_few_shot(bank, learner, logger,
                                        sorted(bank.classes.tolist()))
    seconds = time.perf_counter() - t0
    logger.cprint(f"\n=====[TEST] Loss: {test_loss:.4f} | "
                  f"Mean IoU: {mean_iou:f} =====\n")
    return {"mean_iou": mean_iou, "loss": test_loss, "episodes": len(bank),
            "seconds": seconds}


def make_finetune_loop(model_cfg, fs_cfg: FewShotConfig, n_cls: int,
                       dropout: float = 0.3,
                       device: Optional[torch.device] = None):
    """The FineTune inner loop (reference fine_tune.py:21-75): a DGCNNSeg
    whose encoder is frozen (its parameters take no gradient, so K4b never
    runs) but runs in train mode, so its BatchNorm running statistics move
    as the reference's do; Adam steps the segmenter only.

    Returns (model, new_optimizer, inner_step, test_step):
    inner_step(opt, sx, sy, generator) -> loss (a device tensor);
    test_step(qx, qy) -> (pred, confusion counts). `dropout` 0 makes the
    trajectory deterministic.
    """
    model = DGCNNSeg(n_cls, in_features=model_cfg.pc_in_dim,
                     edgeconv_widths=model_cfg.edgeconv_widths,
                     mlp_widths=model_cfg.dgcnn_mlp_widths,
                     k=model_cfg.dgcnn_k, dropout=dropout,
                     generator=torch.Generator().manual_seed(fs_cfg.seed))
    model.to(device)
    model.encoder.requires_grad_(False)

    def new_optimizer() -> torch.optim.Adam:
        return torch.optim.Adam(model.segmenter.parameters(), lr=fs_cfg.lr)

    def inner_step(opt, sx, sy, generator=None) -> torch.Tensor:
        model.train()
        loss = cross_entropy(model(sx, generator), sy)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.inference_mode()
    def test_step(qx, qy):
        model.eval()
        pred = torch.argmax(torch.softmax(model(qx), dim=-1), dim=-1)
        return pred, confusion_matrix(pred, qy, n_cls)

    return model, new_optimizer, inner_step, test_step


def finetune(model_cfg, data_cfg, fs_cfg: FewShotConfig,
             pretrain_checkpoint_path: str = "", inner_iters: int = 100,
             logger: Optional[IOStream] = None,
             max_episodes: Optional[int] = None,
             bank_episodes: Optional[int] = None) -> Dict:
    """The FineTune baseline (reference pretrain/runs/fine_tune.py:97-152):
    on each test episode, `inner_iters` steps of the segmenter on the
    support (masks as labels 1..n_way), then the query scored. As in the
    reference the parameters carry over from episode to episode, while
    Adam's state starts afresh on each.

    Returns {"mean_iou", "losses" (one an inner step), "episodes",
    "seconds" (host wall of the episodes), "model"}.
    """
    device = resolve_device(fs_cfg.device)
    logger = logger or init_logger(fs_cfg.log_dir, phase="finetune")
    n_cls = fs_cfg.n_way + 1
    n, cin = data_cfg.pc_npts, len(data_cfg.pc_attribs)
    model, new_optimizer, inner_step, test_step = make_finetune_loop(
        model_cfg, fs_cfg, n_cls, device=device)
    if pretrain_checkpoint_path:
        model.encoder.load_state_dict(
            load_pretrained_encoder(pretrain_checkpoint_path), strict=True)

    bank = _bank(data_cfg, fs_cfg, "test", bank_episodes)
    _log_bank(logger, bank)
    test_classes = sorted(bank.classes.tolist())
    num_global = len(test_classes) + 1
    cm_global = torch.zeros((num_global, num_global), dtype=torch.float64,
                            device=device)
    losses = []
    n_episodes = min(len(bank), max_episodes or len(bank))
    t0 = time.perf_counter()
    for ep in range(n_episodes):
        s_pc, s_mask, q_pc, q_lbl, sampled = bank[ep]
        # support masks -> labels 1..n_way (fine_tune.py:77-94)
        sy = s_mask * (np.arange(fs_cfg.n_way)[:, None, None] + 1)
        sx = _to(device, s_pc.reshape(-1, n, cin), np.float32)
        sy = _to(device, sy.reshape(-1, n), np.int64)
        opt = new_optimizer()
        for i in range(inner_iters):
            gen = torch.Generator(device=device).manual_seed(
                ep * inner_iters + i)
            losses.append(inner_step(opt, sx, sy, gen))
        _, cm = test_step(_to(device, q_pc, np.float32),
                          _to(device, q_lbl, np.int64))
        fewshot_accumulate(cm_global, cm, sampled, test_classes)
        logger.cprint(f"=====[FineTune] Episode {ep} done =====")
    mean_iou, iou = fewshot_miou(cm_global.cpu().numpy())
    seconds = time.perf_counter() - t0
    for c, v in enumerate(iou):
        logger.cprint(f"----- [class {c}]  IoU: {v:f} -----")
    logger.cprint(f"\n=====[Test] Mean IoU: {mean_iou:f} =====\n")
    return {"mean_iou": mean_iou, "losses": [float(v) for v in losses],
            "episodes": n_episodes, "seconds": seconds, "model": model}


def mpti_gfs_core(feat_fn: Callable[[np.ndarray], torch.Tensor],
                  base_blocks: Iterable, supp_items: Iterable,
                  query_blocks: Iterable, base_classes, novel_classes,
                  kp: int, k_connect: int, sigma: float,
                  rng: np.random.RandomState, n_all: int,
                  max_pts: int = 200_000):
    """The GFS-MPTI chain (reference mpti_learner.py:107-245), on the
    device of `feat_fn`'s output.

    feat_fn maps one (N, C) block to its (N, D) features (a tensor);
    base_blocks yields (pc (N, C), lbl (N,) with labels 1 + base index);
    supp_items yields (pcd (N, C), mask (N,), class-name id); query_blocks
    yields (pcd (N, C), label in class-name ids). `rng` draws the
    subsample of a base class past `max_pts` points, as the reference's
    global np.random does (pass LegacyRNG(seed).np_rs). Returns
    (pred_list, gt_list, base_proto_dict) as numpy arrays, the
    reference's test_gfs outputs.
    """
    per_class: Dict[int, list] = {i: [] for i in range(len(base_classes))}
    for pc, lbl in base_blocks:
        feat = feat_fn(pc)
        lbl = _to(feat.device, lbl)
        for i in range(len(base_classes)):
            rows = feat[lbl == i + 1]
            if rows.shape[0] > 0:
                per_class[i].append(rows)

    protos_list, labels_list = [], []
    base_proto_dict = {}

    def add(protos: torch.Tensor, cls: int) -> None:
        protos_list.append(protos)
        lab = torch.zeros((kp, n_all), device=protos.device)
        lab[:, cls] = 1.0
        labels_list.append(lab)

    for i, cls in enumerate(base_classes):
        feat = torch.cat(per_class[i], dim=0)
        if feat.shape[0] > max_pts:
            keep = rng.choice(np.arange(feat.shape[0]), max_pts,
                              replace=False)
            feat = feat[_to(feat.device, keep)]
        protos = multi_prototypes(feat, torch.ones_like(feat[:, 0]), kp)
        base_proto_dict[cls] = protos.cpu().numpy()
        add(protos, cls)
        per_class[i] = []

    novel_feats: Dict[int, list] = {c: [] for c in novel_classes}
    for pcd, mask, cls in supp_items:
        feat = feat_fn(pcd)
        novel_feats[int(cls)].append(
            feat[_to(feat.device, np.asarray(mask) == 1)])
    for cls in novel_classes:
        feat = torch.cat(novel_feats[cls], dim=0)
        add(multi_prototypes(feat, torch.ones_like(feat[:, 0]), kp), cls)

    prototypes = torch.cat(protos_list)
    proto_labels = torch.cat(labels_list)
    num_p = prototypes.shape[0]

    def propagate(q_feat: torch.Tensor) -> torch.Tensor:
        node_feat = torch.cat([prototypes, q_feat], dim=0)
        y0 = torch.cat([proto_labels,
                        proto_labels.new_zeros((q_feat.shape[0], n_all))])
        z = label_propagate(local_constrained_affinity(node_feat, k_connect,
                                                       sigma), y0)
        return torch.argmax(torch.softmax(z[num_p:], dim=-1), dim=-1)

    pred_list, gt_list = [], []
    for pcd, label in query_blocks:
        pred_list.append(propagate(feat_fn(pcd)).cpu().numpy())
        gt_list.append(np.asarray(label))
    return pred_list, gt_list, base_proto_dict


def mpti_test_gfs(model_cfg, data_cfg, fs_cfg: FewShotConfig,
                  model_checkpoint_path: str, testing_data_path: str,
                  logger: Optional[IOStream] = None,
                  max_base_blocks: Optional[int] = None,
                  max_query_blocks: Optional[int] = None) -> Dict:
    """GFS-style MPTI evaluation (reference mpti_learner.py:107-245):
    `n_subprototypes` prototypes a base class from the base training
    blocks (at most 200,000 points a class) and a novel class from the
    static supports (seed 10), then label propagation over the prototypes
    and each query block's points, scored in class-name space by
    `gfs_miou` (ScanNet when there are more than 13 classes).
    `max_base_blocks` / `max_query_blocks` cut the two sweeps short.
    Returns {"mean_iou", "base_iou", "novel_iou", "hm_iou",
    "base_blocks", "query_blocks", "seconds"}."""
    logger = logger or init_logger(fs_cfg.log_dir, phase="mptigfs")
    learner = FewShotLearner("mpti", model_cfg, data_cfg, fs_cfg,
                             model_checkpoint_path=model_checkpoint_path)
    model = learner.model

    reg_train = make_registry(data_cfg.dataset, data_cfg.cvfold,
                              data_cfg.data_path)
    reg_test = make_registry(data_cfg.dataset, data_cfg.cvfold,
                             testing_data_path)
    base_classes = sorted(reg_train.train_classes)
    novel_classes = sorted(reg_train.test_classes)
    all_order = base_classes + novel_classes
    all_names = sorted(all_order)
    n_all = len(all_names)

    # one legacy stream drives both the base blocks' sampling and the
    # subsample caps, as the reference's global np.random does
    # (mpti_learner.py:125-160)
    rng = LegacyRNG(fs_cfg.seed)

    c2s = {c: reg_train.class2scans[c] for c in base_classes}
    base_ds = PretrainBlockDataset(
        data_cfg.data_path, base_classes, c2s, mode="train",
        num_point=data_cfg.pc_npts, pc_attribs=data_cfg.pc_attribs)
    n_blocks = min(len(base_ds), max_base_blocks or len(base_ds))

    def base_blocks():
        for bi in range(n_blocks):
            pc, lbl, _ = base_ds.__getitem__(bi, rng=rng)
            yield pc, lbl

    supp = ValSuppDataset(data_cfg.data_path, data_cfg.dataset,
                          cvfold=data_cfg.cvfold, k_shot=data_cfg.k_shot,
                          mode="test", num_point=data_cfg.pc_npts,
                          pc_attribs=data_cfg.pc_attribs, seed=10,
                          registry=reg_train)

    test_c2s = {c: reg_test.class2scans[c] for c in all_names}
    query_ds = TestingDataset(testing_data_path, all_names, all_order,
                              test_c2s, mode="test",
                              num_point=data_cfg.pc_npts,
                              pc_attribs=data_cfg.pc_attribs)
    n_query = min(len(query_ds), max_query_blocks or len(query_ds))

    def query_blocks():
        for qi in range(n_query):
            pcd, label, _ = query_ds[qi]
            # TestingDataset gives learning-order labels; the chain (and
            # the reference) scores in class-name space
            yield pcd, np.asarray(all_order)[label]

    model.eval()

    def feat_fn(pc: np.ndarray) -> torch.Tensor:
        return model.get_features(_to(learner.device, pc[None],
                                      np.float32))[0]

    t0 = time.perf_counter()
    with torch.inference_mode():
        pred_list, gt_list, _ = mpti_gfs_core(
            feat_fn, base_blocks(), (supp[i] for i in range(len(supp))),
            query_blocks(), base_classes, novel_classes,
            fs_cfg.n_subprototypes, fs_cfg.k_connect, fs_cfg.sigma,
            rng.np_rs, n_all)
    seconds = time.perf_counter() - t0

    cm = np.zeros((n_all, n_all), np.float64)
    for pred, gt in zip(pred_list, gt_list):
        np.add.at(cm, (gt, pred), 1)
    # cm is already in class-name space: the identity learning order
    mean_iou, base_iou, novel_iou, hm, _ = gfs_miou(
        cm, list(range(n_all)), novel_classes, scannet=n_all > 13)
    logger.cprint(f"MPTI GFS: mean {mean_iou}, base {base_iou}, "
                  f"novel {novel_iou}, hm {hm}")
    return {"mean_iou": mean_iou, "base_iou": base_iou,
            "novel_iou": novel_iou, "hm_iou": hm, "base_blocks": n_blocks,
            "query_blocks": n_query, "seconds": seconds}
