"""The count functions against hand counts."""
import json
import os

import pytest

from tracer import HERE, load_module


def counts(name):
    return load_module(os.path.join(HERE, "counts", f"{name}.py"),
                       f"counts_{name}")


def config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_eval_block_is_4_94_gflop_at_the_papers_widths():
    n, k = 2048, 20
    mac = (n * n * (9 + 64 + 64)            # three kNN Gram matrices
           + 2 * n * 64 * (9 + 64 + 64)     # neighbour and centre tables
           + 3 * n * k * 64 * 64            # three second edge convs
           + n * 192 * 512 + n * 512 * 256  # point MLP
           + n * 256 * 128 + n * 128 * 64   # base learner
           + 3 * n * 256 * 64 + 2 * n * n * 64   # attention
           + n * 192 * 150                  # word cosine
           + n * (150 + 192) * 128          # fusion
           + 3 * n * 128 * 13 + n * 150 * 13)    # heads
    got = counts("eval_block").flops(config("gwcapl_s3dis"), n)
    assert got == 2.0 * mac
    assert round(got / 1e9, 2) == 4.94


def test_eval_block_one_layer_block_has_no_second_conv():
    full = counts("eval_block").flops(config("gwcapl_s3dis"), 2048)
    semseg = counts("eval_block").flops(config("gwcapl_s3dis_semseg"), 2048)
    assert full - semseg == 2.0 * 2048 * 20 * 64 * 64


def test_train_block_is_forward_plus_twice_its_differentiable_part():
    cfg, n = config("gwcapl_s3dis"), 2048
    eb = counts("eval_block")
    heads_eval = 2.0 * (3 * n * 128 * 13 + n * 150 * 13)
    heads_train = 2.0 * (0.5 * n * 128 * 14 + 4 * n * 128 * 14)
    fwd = eb.flops(cfg, n) - heads_eval + heads_train
    knn = 2.0 * n * n * (9 + 64 + 64)
    assert counts("train_block").flops(cfg, n) == pytest.approx(
        fwd + 2 * (fwd - knn), rel=1e-12)


def test_k1_symmetric_gram_once_and_bytes_once():
    fmas, nbytes = counts("k1").count(batch=2, keys=10, queries=10, c=3,
                                      w0=4, w1=5, k=2)
    assert fmas == 2 * 10 * 11 // 2 * 3 + 2 * 10 * 2 * 4 * 5
    assert nbytes == 4 * (2 * 10 * (3 + 4) + 2 * 10 * 4 + 4 * 5 + 5
                          + 2 * 10 * 5)
    local, _ = counts("k1").count(batch=2, keys=10, queries=4, c=3, w0=4,
                                  w1=5, k=2)
    assert local == 2 * 4 * 10 * 3 + 2 * 4 * 2 * 4 * 5


def test_k2_k3_k4b_hand_counts():
    assert counts("k2").count(batch=2, queries=8, keys=8, d=4) == (
        2 * 2 * 8 * 8 * 4, 4 * (2 * 2 * 8 * 4 + 2 * 2 * 8 * 4))
    assert counts("k3").count(batch=1, n=6, c=3, cb=2, k=2) == (
        6 * 7 // 2 * 3, 4 * (6 * 5 + 6 * (2 + 1 + 2)))
    fmas, nbytes = counts("k4b").count(batch=1, n=6, w0=3, w1=2, k=2)
    assert fmas == 2 * 12 * 3 * 2
    assert nbytes == 4 * (2 * 6 * 3 + 12 + 6 + 2 * 6 * 2 + 2 * 6 * 3 + 6)


def test_shapes_read_the_call():
    import torch

    x = torch.zeros(2, 10, 3)
    a = torch.zeros(2, 10, 4)
    w2 = torch.zeros(4, 5)
    shape = counts("k1").shapes((x, a, a, w2, torch.zeros(5), 7), {})
    assert shape == {"batch": 2, "keys": 10, "queries": 10, "c": 3,
                     "w0": 4, "w1": 5, "k": 7}
    assert counts("k4b").CALLS_OF == "k4a"
