"""PyTorch port on the GPU: the hand-written CUDA kernels against their plain
PyTorch versions on the card, and the model on the card against the CPU.

Marked `cuda`: without a CUDA device every test skips. On the GPU host
(which has no JAX, so the repo's JAX conftest is left out):

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_port_cuda.py
"""
import statistics

import numpy as np
import pytest
import torch

from chip_smoke import copied_block, k4a_offset_affine
from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy
from gfs3dseg_gws_tpu_torch.ops import _ext
from gfs3dseg_gws_tpu_torch.ops import attention_train as atr
from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import (attention_plain,
                                                         fused_attention)
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (fused_edgeconv_infer,
                                                       fused_edgeconv_plain)
from gfs3dseg_gws_tpu_torch.ops.edgeconv import (gather_neighbors,
                                                 gather_neighbors_plain,
                                                 scatter_bwd,
                                                 scatter_bwd_plain)
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (
    fused_edgeconv_infer_split, gather_conv, gather_conv_plain)
from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices, knn_indices_fold,
                                            knn_indices_fold_plain,
                                            knn_indices_plain,
                                            knn_with_stats,
                                            knn_with_stats_plain,
                                            neighbor_stats_plain,
                                            pairwise_sq_dists)
from gfs3dseg_gws_tpu_torch.utils.observability import calls

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(r, *shape, scale=1.0):
    return torch.from_numpy((r.standard_normal(shape) * scale).astype(
        np.float32))


def _fast_path(c, k, *widths):
    """The shapes PRs 1-4 ran (C, W <= 64, k <= 32): held exactly as then."""
    return c <= 64 and k <= 32 and all(w <= 64 for w in widths)


def _assert_same_graph(x, idx, ref):
    """Two kNN graphs of x that may differ only where rounding decides a
    near-tie: on at most 1% of the rows up to k = 80 and k / 80 percent
    past it (a longer list meets more near-ties), and there slot by slot at
    squared distances (in float64) within 1e-5 of the row's largest."""
    differ = (idx != ref).any(-1)
    cap = 0.01 * max(1.0, idx.shape[-1] / 80)
    assert differ.float().mean() <= cap, differ.float().mean()
    xd = x.double()
    for b, i in differ.nonzero().tolist():
        d2 = ((xd[b] - xd[b, i]) ** 2).sum(-1)
        got, want = d2[idx[b, i].long()], d2[ref[b, i].long()]
        assert (got - want).abs().max() <= 1e-5 * want.max(), (b, i)


@pytest.mark.parametrize("b,n,c,w0,w1,k", [
    (2, 100, 9, 8, 8, 5),         # ragged N, narrow tables
    (2, 300, 64, 64, 64, 20),     # model widths, ragged N
    (1, 64, 3, 48, 24, 32),       # k at the fast chain's limit, W0 != W1
    (3, 2048, 9, 64, 64, 20),     # first block at full N
    (2, 300, 128, 128, 128, 40),  # wide C/W (chunked), k in the 64 chain
    (1, 200, 9, 72, 130, 70),     # k > 64 (K8's streaming kNN), ragged W tiles
    (2, 150, 9, 30, 40, 20),      # W0 % 4 != 0: the edge rows' 4-byte copies
    (2, 77, 9, 8, 8, 1),          # k = 1, narrow tables
    (2, 200, 64, 64, 64, 32),     # model widths at k = 32
    (1, 120, 16, 64, 64, 33),     # k past one staged chunk of idx (32)
    (1, 2047, 9, 64, 64, 20),     # N not a multiple of a block's 64 queries
])
def test_fused_edgeconv_kernel_matches_plain(dev, b, n, c, w0, w1, k):
    r = np.random.default_rng(n + c)
    args = [_randn(r, b, n, c), _randn(r, b, n, w0), _randn(r, b, n, w0),
            _randn(r, w0, w1, scale=0.3), _randn(r, w1, scale=0.1)]
    if _fast_path(c, k, w0, w1):
        ref = fused_edgeconv_plain(*[a.to(dev) for a in args], k)
    else:
        # past the fast path the graph may flip a near-tie against the
        # twin's (held by the K6 test): the edge layer on K6's graph (K1's
        # own, bit for bit)
        dargs = [a.to(dev) for a in args]
        ref = gather_conv_plain(knn_indices(dargs[0], k), *dargs[1:])
    before = calls("op.k1")
    got = fused_edgeconv_infer(*[a.to(dev) for a in args], k)
    torch.cuda.synchronize()
    assert calls("op.k1") == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,n,d", [(2, 100, 16), (2, 2048, 64), (1, 33, 64),
                                   (3, 130, 44), (2, 100, 30), (2, 300, 128),
                                   (1, 70, 72), (16, 2048, 128),
                                   (2, 300, 192)])
def test_fused_attention_kernel_matches_plain(dev, b, n, d):
    r = np.random.default_rng(n + d)
    q, k, v = (_randn(r, b, n, d).to(dev) for _ in range(3))
    before = calls("op.k2")
    got = fused_attention(q, k, v, d ** 0.5)
    torch.cuda.synchronize()
    assert calls("op.k2") == before + 1
    torch.testing.assert_close(got, attention_plain(q, k, v, d ** 0.5),
                               rtol=1e-4, atol=1e-5)


def _parts(n, sp):
    """(q_offset, nq) of sp consecutive query ranges covering [0, n)."""
    return [(p * n // sp, (p + 1) * n // sp - p * n // sp)
            for p in range(sp)]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("b,n,c,w0,w1,k", [
    (2, 2048, 9, 64, 64, 20),     # the first block at full N
    (2, 2048, 64, 64, 64, 20),    # the model's widths at full N
    (2, 300, 128, 128, 128, 40),  # knn_kernel (wide C), edge_mlp_wide_kernel
    (1, 200, 9, 72, 130, 70),     # k > 64: knn_stream_kernel
    (1, 600, 9, 8, 8, 300),       # k > 256: knn_fold_kernel
    (1, 2047, 9, 64, 64, 20),     # ragged N and ragged query ranges
])
def test_local_queries_equal_rows_of_the_full_call(dev, b, n, c, w0, w1, k,
                                                   sp):
    """K1 and K6 on query rows [q0, q0 + nq) against every row (a rank of
    the data x points mesh): the rows of the call over every query, bit
    for bit, at every variant the kNN and edge stages take."""
    r = np.random.default_rng(n + c + k)
    x, a, bt = (_randn(r, b, n, cc).to(dev) for cc in (c, w0, w0))
    w2, bias2 = (_randn(r, w0, w1, scale=0.3).to(dev),
                 _randn(r, w1, scale=0.1).to(dev))
    full1 = fused_edgeconv_infer(x, a, bt, w2, bias2, k)
    full6 = knn_indices(x, k)
    for q0, nq in _parts(n, sp):
        before = (calls("op.k1"), calls("op.k6"))
        got1 = fused_edgeconv_infer(x, a, bt[:, q0:q0 + nq].contiguous(), w2,
                                    bias2, k, q_offset=q0)
        got6 = knn_indices(x, k, q0, nq)
        torch.cuda.synchronize()
        assert (calls("op.k1"), calls("op.k6")) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(got1, full1[:, q0:q0 + nq]), (q0, nq)
        assert torch.equal(got6, full6[:, q0:q0 + nq]), (q0, nq)


def test_local_queries_past_one_shared_key_row(dev):
    """K6 at (1, 30000, 9), k = 257: K8's tournament merges chunks of the
    row through a scratch sized by the local queries."""
    r = np.random.default_rng(30001)
    x = _randn(r, 1, 30000, 9).to(dev)
    k = _ext.knn_stream_cap() + 1
    full = knn_indices(x, k)
    got = knn_indices(x, k, 20000, 10000)
    torch.cuda.synchronize()
    assert torch.equal(got, full[:, 20000:])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("b,n,d", [(2, 2048, 64), (1, 33, 64), (2, 300, 30),
                                   (2, 300, 128), (2, 300, 192)])
def test_attention_local_queries_equal_rows_of_the_full_call(dev, b, n, d,
                                                             sp):
    """K2 with q of nq rows against all n keys and values: the rows of the
    call over every query, bit for bit (attention_mma_kernel up to D = 128,
    attention_wide_kernel past it)."""
    r = np.random.default_rng(n + d + 1)
    q, k, v = (_randn(r, b, n, d).to(dev) for _ in range(3))
    full = fused_attention(q, k, v, d ** 0.5)
    for q0, nq in _parts(n, sp):
        got = fused_attention(q[:, q0:q0 + nq].contiguous(), k, v, d ** 0.5)
        torch.cuda.synchronize()
        assert got.shape == (b, nq, d)
        assert torch.equal(got, full[:, q0:q0 + nq]), (q0, nq)


def test_kernel_wrappers_refuse_what_they_cannot_take(dev):
    """Only what JAX also rejects (k > N) and malformed tensors: any width
    runs (see the wide cases above)."""
    x = torch.zeros((1, 16, 65), device=dev)
    a = torch.zeros((1, 16, 8), device=dev)
    w2, bias2 = torch.zeros((8, 8), device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="k must lie in"):
        fused_edgeconv_infer(x[..., :3].contiguous(), a, a, w2, bias2, 17)
    with pytest.raises(TypeError, match="float32"):
        fused_attention(a.double(), a.double(), a.double(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(a.transpose(1, 2), a.transpose(1, 2),
                        a.transpose(1, 2), 1.0)


@pytest.mark.parametrize("b,n,c,k", [
    (2, 33, 3, 32),        # k at the fast chain's limit, N past one tile
    (2, 100, 9, 5),        # ragged N, the first block's width
    (3, 300, 64, 20),      # model widths, ragged N
    (2, 300, 128, 40),     # wide C, k in the 64 chain
    (2, 150, 9, 70),       # k > 64: K8's streaming kNN with the statistics
])
def test_knn_with_stats_kernel_matches_plain(dev, b, n, c, k):
    """K3: idx equal to the twin's; cnt exactly the plain count of the
    kernel's idx; scb within 1e-5 of the largest entry (float atomics)."""
    r = np.random.default_rng(n + c)
    x, btab = _randn(r, b, n, c).to(dev), _randn(r, b, n, 64).to(dev)
    before = calls("op.k3")
    idx, cnt, scb = knn_with_stats(x, btab, k)
    torch.cuda.synchronize()
    assert calls("op.k3") == before + 1
    ref_idx = knn_with_stats_plain(x, btab, k)[0]
    if _fast_path(c, k):
        assert torch.equal(idx, ref_idx)
    else:
        _assert_same_graph(x, idx, ref_idx)
    ref_cnt, ref_scb = neighbor_stats_plain(idx, btab)
    assert torch.equal(cnt, ref_cnt)
    assert (scb - ref_scb).abs().max() <= 1e-5 * ref_scb.abs().max()


def _fet_args(r, b, n, c, w1, dev):
    g2 = 1.0 + 0.2 * r.standard_normal(w1)
    g2[::3] *= -1.0                       # the min branch
    return [t.to(dev) for t in (
        _randn(r, b, n, c), _randn(r, b, n, c),
        torch.from_numpy((1.0 + 0.2 * r.standard_normal(c)).astype(
            np.float32)), _randn(r, c, scale=0.2),
        _randn(r, c, w1, scale=0.3), torch.from_numpy(g2.astype(np.float32)),
        _randn(r, w1, scale=0.2))]


@pytest.mark.parametrize("b,n,c,w1,k", [
    (2, 33, 8, 8, 32),     # k at the fast path's former limit
    (2, 100, 9, 24, 5),    # ragged N, W0 != W1
    (3, 300, 64, 64, 20),  # model widths, ragged N
    (1, 130, 64, 40, 20),  # W1 < W0
    (2, 300, 128, 128, 40),  # wide: 2 column tiles x 2 channel chunks
    (1, 130, 72, 40, 70),  # wide C only, k > 64
    (1, 100, 40, 130, 20),  # wide W1 only, 3 ragged column tiles
])
def test_fused_edgeconv_train_kernels_match_plain(dev, b, n, c, w1, k):
    """K4a and K4b against their twins on the same inputs (K4a also on the
    offset input against the fp64 twin, K4b also with its bn2 coefficient
    c2 100 times larger), then the whole
    Function against the unfused composition: forward, statistics and all
    seven gradients within 1e-4 (forward) / 1e-3 (gradients) of the
    reference's largest magnitude."""
    r = np.random.default_rng(n + c + w1)
    params = _fet_args(r, b, n, c, w1, dev)
    x = _randn(r, b, n, 3).to(dev)
    idx, cnt, scb = knn_with_stats(x, params[1], k)
    s1, t1 = params[2] * 0.8, params[3] - 0.1
    got = fet._gsf(params[0], params[1], idx, s1, t1, params[4], 0.2)
    ref = fet._gsf_plain(params[0], params[1], idx, s1, t1, params[4], 0.2)
    for g, w in zip(got, ref):
        assert (g.float() - w.float()).abs().max() <= 1e-4 * max(
            w.float().abs().max(), 1.0)
    # K4a on chip_smoke.py's offset input (h1 one value a channel), against
    # the twin in fp64: snbr, zmax, zmin and the bn2 sums within 1e-4 of
    # its largest entry, which a Gram matrix in single TF32 misses
    off = (params[0], params[1], idx, *(torch.from_numpy(v).to(dev) for v in
                                        k4a_offset_affine(
                                            np.random.default_rng(c), c)),
           params[4])
    got_o = fet._gsf(*off, 0.2)
    ref_o = fet._gsf_plain(*(x.double() if x.is_floating_point() else x
                             for x in off), 0.2)
    for i in (0, 1, 2, 5):
        assert ((got_o[i].double() - ref_o[i]).abs().max()
                <= 1e-4 * ref_o[i].abs().max())
    gsel = _randn(r, b, n, w1).to(dev)
    p1 = torch.stack([s1, t1, 0.1 * params[3], 1.0 + 0.1 * params[2],
                      params[2]])
    pk = torch.stack([params[5], 0.01 * params[6], 0.01 * params[6],
                      0.1 * params[6], 1.0 + 0.1 * params[5].abs()])
    bwd = (params[0], params[1], idx, p1, params[4], gsel, got[3], pk, 0.2)
    for g, w in zip(fet._bwd(*bwd), fet._bwd_plain(*bwd)):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    # c2 100 times larger, so that the rounding of the recomputed z1 shows
    # in dz1 (as chip_smoke.py::check_fused_train holds it too)
    pk[2] *= 100.0
    for g, w in zip(fet._bwd(*bwd), fet._bwd_plain(*bwd)):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()

    cot = _randn(r, b, n, w1).to(dev)

    def run(fn, **kw):
        ins = [p.clone().requires_grad_() for p in params]
        outs = fn(*ins, idx, **kw)
        return outs, torch.autograd.grad((outs[0] * cot).sum(), ins)

    before = (calls("op.k4a"), calls("op.k4b"))
    f_outs, f_grads = run(fet.fused_edgeconv_train, cnt=cnt, scb=scb)
    assert (calls("op.k4a"), calls("op.k4b")) == (before[0] + 1,
                                                  before[1] + 1)
    p_outs, p_grads = run(fet.fused_edgeconv_train_plain)
    for g, w in zip(f_outs, p_outs):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    for g, w in zip(f_grads, p_grads):
        assert (g - w).abs().max() <= 1e-3 * w.abs().max()


def test_training_wrappers_refuse_what_they_cannot_take(dev):
    x = torch.zeros((1, 16, 65), device=dev)
    btab = torch.zeros((1, 16, 8), device=dev)
    with pytest.raises(ValueError, match="k must lie in"):
        knn_with_stats(x[..., :3].contiguous(), btab, 17)
    with pytest.raises(TypeError, match="float32"):
        knn_with_stats(x[..., :3].double(), btab, 5)
    a = torch.zeros((1, 16, 8), device=dev)
    w2 = torch.zeros((8, 8), device=dev)
    vec = torch.zeros(8, device=dev)
    idx = torch.zeros((1, 16, 5), device=dev, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        fet._gsf(a, a, idx, vec, vec, w2, 0.2)
    with pytest.raises(ValueError, match="k must lie in"):
        fet._gsf(a, a, torch.zeros((1, 16, 33), device=dev,
                                   dtype=torch.int32), vec, vec, w2, 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        fet._gsf(a.transpose(1, 2).contiguous().transpose(1, 2), a,
                 idx.int(), vec, vec, w2, 0.2)


@pytest.mark.parametrize("widths", [((64, 64),) * 3,
                                    ((64, 64), (64, 64), (64,))],
                         ids=["default", "semseg"])
def test_dgcnnseg_train_step_on_card_agrees_with_cpu(dev, monkeypatch,
                                                     widths):
    """One full-width train step (dropout 0), at the default widths and at
    the DGCNN semantic-segmentation widths (a third block one layer deep:
    K6, and K7 in the backward): the loss within 1e-4, every gradient's
    cosine with the CPU's >= 0.999, the running statistics within 1e-4.
    The CPU takes the card's kNN graphs (K3's and K6's indices), so that a
    near-tie that rounding resolves differently on the two devices cannot
    move a block's global max feature; at most 0.1% of each graph's rows
    may differ from the CPU's own graph. Gradients that are zero in exact
    arithmetic (biases whose shift a train-mode BatchNorm downstream
    removes) are rounding noise on both devices: such a pair must stay
    under 1e-5 of the largest gradient norm and is not held to the
    cosine."""
    from gfs3dseg_gws_tpu_torch.models import dgcnn

    graphs = []

    def own_rows_differ(idx, x, k):
        own = knn_indices_plain(x, k)
        differ = (idx.sort(-1).values != own.sort(-1).values).any(-1)
        assert differ.float().mean() <= 1e-3

    def record(x, btab, k):
        out = knn_with_stats(x, btab, k)
        graphs.append(out[0].cpu())
        return out

    def replay(x, btab, k):
        idx = graphs.pop(0)
        own_rows_differ(idx, x, k)
        return (idx,) + neighbor_stats_plain(idx, btab)

    def record_idx(x, k, **local):
        idx = knn_indices(x, k, **local)
        graphs.append(idx.cpu())
        return idx

    def replay_idx(x, k, **local):
        idx = graphs.pop(0)
        own_rows_differ(idx, x, k)
        return idx

    cpu = DGCNNSeg(8, edgeconv_widths=widths, dropout=0.0,
                   generator=torch.Generator().manual_seed(0))
    gpu = DGCNNSeg(8, edgeconv_widths=widths, dropout=0.0, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(3)
    x = _randn(r, 2, 512, 9)
    y = torch.from_numpy(r.integers(0, 8, (2, 512)))
    losses = []
    before = (calls("op.k6"), calls("op.k7"))
    for model, device, knn, knn_idx in ((gpu, dev, record, record_idx),
                                        (cpu, "cpu", replay, replay_idx)):
        monkeypatch.setattr(dgcnn, "knn_with_stats", knn)
        monkeypatch.setattr(dgcnn, "knn_indices", knn_idx)
        loss = cross_entropy(model(x.to(device)), y.to(device))
        loss.backward()
        losses.append(loss.item())
    assert not graphs
    one_deep = sum(len(w) != 2 for w in widths)
    assert (calls("op.k6"), calls("op.k7")) == (
        before[0] + one_deep, before[1] + one_deep)
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[1])
    grads = [(name, pc.grad.double().flatten(),
              pg.grad.cpu().double().flatten())
             for (name, pc), (_, pg) in zip(cpu.named_parameters(),
                                            gpu.named_parameters())]
    floor = 1e-5 * max(gc.norm().item() for _, gc, _ in grads)
    for name, gc, gg in grads:
        if gc.norm() < floor and gg.norm() < floor:
            continue
        cos = (gc @ gg / (gc.norm() * gg.norm()).clamp_min(1e-300)).item()
        assert cos >= 0.999, (name, cos)
    for (name, bc), (_, bg) in zip(cpu.named_buffers(), gpu.named_buffers()):
        if name.endswith(("running_mean", "running_var")):
            assert ((bc - bg.cpu()).abs() <= 1e-4 * bc.abs().clamp_min(
                1.0)).all(), name


@pytest.mark.parametrize("b,n,c,k", [
    (2, 33, 3, 32),        # k at the fast chain's limit, N past one tile
    (2, 100, 9, 5),        # ragged N, the first block's width
    (3, 300, 64, 20),      # model widths, ragged N
    (2, 300, 128, 40),     # wide C (chunked), k in the 64 chain
    (2, 200, 9, 80),       # k > 64: K8's streaming selection
    (1, 100, 100, 100),    # k = N, wide C
    (2, 2047, 9, 20),      # the first block's width (CP = 12), ragged N
    (3, 200, 12, 20),      # C = CP = 12
    (2, 130, 16, 32),      # C = CP = 16, k at the split chain's limit
])
def test_knn_indices_kernel_matches_plain(dev, b, n, c, k):
    """K6: int32 indices equal to the twin's, order included."""
    r = np.random.default_rng(n + c + 1)
    x = _randn(r, b, n, c).to(dev)
    before = calls("op.k6")
    idx = knn_indices(x, k)
    torch.cuda.synchronize()
    assert calls("op.k6") == before + 1
    assert idx.dtype == torch.int32
    if _fast_path(c, k):
        assert torch.equal(idx, knn_indices_plain(x, k))
    else:
        _assert_same_graph(x, idx, knn_indices_plain(x, k))


@pytest.mark.parametrize("c", [9, 64])
@pytest.mark.parametrize("k", [1, 20, 32])
def test_knn_stage_on_copied_points_equals_twin(dev, k, c):
    """K6, K3 and K1's kNN stage on blocks of copied points (exact ties, to
    the lower index): K3's and K8's idx equal K6's bit for bit, K1's out
    equals K9 on K6's idx bit for bit, and K6's idx equals the twin's on
    every row, order included (at C = 64 by the near-tie rule: the twin's
    cuBLAS distances round otherwise than the kernel's fmaf chains)."""
    r = np.random.default_rng(k)
    x = torch.from_numpy(np.concatenate(
        [copied_block(c=c, seed=s) for s in range(2)])).to(dev)
    btab = _randn(r, 2, 2048, 64).to(dev)
    tables = [_randn(r, 2, 2048, 64).to(dev), _randn(r, 2, 2048, 64).to(dev),
              _randn(r, 64, 64, scale=0.125).to(dev),
              _randn(r, 64, scale=0.1).to(dev)]
    twin = knn_indices_plain(x, k)
    idx6 = knn_indices(x, k)
    idx3 = knn_with_stats(x, btab, k)[0]
    torch.cuda.synchronize()
    assert torch.equal(idx3, idx6)
    assert torch.equal(knn_indices_fold(x, k, 4), idx6)
    assert torch.equal(fused_edgeconv_infer(x, *tables, k),
                       gather_conv(idx6, *tables))
    if c == 9:
        assert torch.equal(idx6, twin)
    else:
        _assert_same_graph(x, idx6, twin)


@pytest.mark.parametrize("b,n,k,c", [(2, 100, 5, 9), (3, 300, 20, 64),
                                     (1, 64, 32, 40), (2, 50, 7, 100),
                                     (2, 64, 4, 256), (1, 40, 3, 600)])
def test_scatter_kernel_and_gather_function_match_plain(dev, b, n, k, c):
    """K7 against scatter_bwd_plain on K6's graph, within 1e-5 of the
    largest entry (float atomics; any C: C = 9 adds single floats, C = 100
    rows of 25 float4s, C = 600 rows longer than a warp's pass); the gather
    Function's gradient against autograd through gather_neighbors_plain,
    likewise."""
    r = np.random.default_rng(n + k + c)
    x = _randn(r, b, n, min(c, 64)).to(dev)
    idx = knn_indices(x, k)
    g = _randn(r, b, n, k, c).to(dev)
    before = calls("op.k7")
    got = scatter_bwd(idx, g)
    torch.cuda.synchronize()
    assert calls("op.k7") == before + 1
    ref = scatter_bwd_plain(idx, g)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    table = _randn(r, b, n, c).to(dev)
    grads = []
    for fn in (gather_neighbors, gather_neighbors_plain):
        leaf = table.clone().requires_grad_()
        out = fn(leaf, idx)
        assert torch.equal(out, gather_neighbors_plain(table, idx))
        grads.append(torch.autograd.grad(out, leaf, g)[0])
    assert calls("op.k7") == before + 2
    assert (grads[0] - grads[1]).abs().max() <= 1e-5 * grads[1].abs().max()


def test_scatter_kernel_on_rows_off_16_bytes(dev):
    """K7 on a g whose rows start 4 bytes past 16 (C % 4 == 0, a
    contiguous view at an offset): the single-float path, within 1e-5 of
    the largest entry of scatter_bwd_plain."""
    r = np.random.default_rng(7)
    b, n, k, c = 2, 100, 6, 64
    idx = knn_indices(_randn(r, b, n, c).to(dev), k)
    flat = _randn(r, b * n * k * c + 1).to(dev)
    g = flat[1:].view(b, n, k, c)
    assert g.is_contiguous() and g.data_ptr() % 16 == 4
    got = scatter_bwd(idx, g)
    ref = scatter_bwd_plain(idx, g)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("b,n,c,w0,w1,k", [
    (2, 100, 9, 8, 8, 5),
    (2, 300, 64, 64, 64, 20),
    (1, 64, 3, 48, 24, 32),
    (2, 300, 128, 128, 128, 40),
    (1, 200, 9, 72, 130, 70),
    (2, 150, 9, 30, 40, 20),
    (2, 77, 9, 8, 8, 1),
    (2, 200, 64, 64, 64, 32),
    (1, 120, 16, 64, 64, 33),
    (1, 2047, 9, 64, 64, 20),
])
def test_split_edgeconv_equals_fused_bit_for_bit(dev, b, n, c, w0, w1, k):
    """K6 then K9 equals K1 bit for bit (the same two device functions);
    K9 against its twin on K6's indices within 1e-4."""
    r = np.random.default_rng(n + c + w1)
    args = [_randn(r, b, n, c).to(dev), _randn(r, b, n, w0).to(dev),
            _randn(r, b, n, w0).to(dev), _randn(r, w0, w1, scale=0.3).to(dev),
            _randn(r, w1, scale=0.1).to(dev)]
    before = (calls("op.k6"), calls("op.k9"))
    split = fused_edgeconv_infer_split(*args, k)
    torch.cuda.synchronize()
    assert (calls("op.k6"), calls("op.k9")) == (before[0] + 1,
                                                before[1] + 1)
    assert torch.equal(split, fused_edgeconv_infer(*args, k))
    idx = knn_indices(args[0], k)
    torch.testing.assert_close(gather_conv(idx, *args[1:]),
                               gather_conv_plain(idx, *args[1:]),
                               rtol=1e-4, atol=1e-4)


def test_fourth_slice_wrappers_refuse_what_they_cannot_take(dev):
    x = torch.zeros((1, 16, 65), device=dev)
    with pytest.raises(ValueError, match="k must lie in"):
        knn_indices(x[..., :3].contiguous(), 17)
    with pytest.raises(TypeError, match="float32"):
        knn_indices(x[..., :3].double(), 5)
    a = torch.zeros((1, 16, 8), device=dev)
    w2, bias2 = torch.zeros((8, 8), device=dev), torch.zeros(8, device=dev)
    idx = torch.zeros((1, 16, 5), device=dev, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        gather_conv(idx, a, a, w2, bias2)
    with pytest.raises(ValueError, match="int32"):
        scatter_bwd(idx, torch.zeros((1, 16, 5, 8), device=dev))
    with pytest.raises(ValueError, match="k must lie in"):
        gather_conv(torch.zeros((1, 16, 17), device=dev, dtype=torch.int32),
                    a, a, w2, bias2)
    with pytest.raises(ValueError, match="folds"):
        knn_indices_fold(x, 5, folds=3)


@pytest.mark.parametrize("b,n,c,k,folds", [
    (2, 300, 9, 20, 2), (2, 300, 9, 20, 4), (2, 300, 9, 20, 8),
    (1, 2048, 64, 40, 4),   # the model's N, k = 40
    (2, 333, 128, 70, 4),   # ragged N, wide C, k > 64
    (1, 37, 5, 37, 8),      # k = N, N not a multiple of the folds
    (1, 50, 3, 1, 2),       # k = 1
    (2, 300, 9, "cap", 4),    # the streaming selection's longest list
    (1, 300, 9, "cap+1", 2),  # one past it: the fold-merge tournament
    (1, 333, 64, "cap+1", 8), # ... ragged N, folds 8
])
def test_knn_fold_kernel_equals_k6_and_its_twin(dev, b, n, c, k, folds):
    """K8: its indices equal K6's bit for bit (the same distance code; K6
    runs its own selection up to k = 64, K8's past it), and its twin's (the
    JAX tournament in torch) up to near-ties. "cap" is the library's
    streaming-selection cap (kCap, csrc/knn_fold.cu)."""
    if isinstance(k, str):
        k = _ext.knn_stream_cap() + (k == "cap+1")
    r = np.random.default_rng(n + c + k + folds)
    x = _randn(r, b, n, c).to(dev)
    before = calls("op.k8")
    idx = knn_indices_fold(x, k, folds)
    torch.cuda.synchronize()
    assert calls("op.k8") == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (b, n, k)
    assert torch.equal(idx, knn_indices(x, k))
    _assert_same_graph(x, idx, knn_indices_fold_plain(x, k, folds))


def _knn_plain_by_rows(x, k, rows=2048):
    """knn_indices_plain's rule (squared distances of pairwise_sq_dists,
    nearest first, ties to the lower index) over chunks of query rows, so
    that the (N, N) scores never exist whole."""
    out = []
    for i0 in range(0, x.shape[1], rows):
        score = -pairwise_sq_dists(x[:, i0:i0 + rows], x)
        order = torch.sort(score, dim=-1, descending=True, stable=True)
        out.append(order.indices[..., :k].to(torch.int32))
    return torch.cat(out, 1)


@pytest.mark.parametrize("entry", ["k6", "k3", "k8", "k8_past_cap"])
def test_knn_past_one_shared_key_row(dev, entry):
    """K6, K3 and K8 at (1, 30000, 9), k = 80: a key row longer than shared
    memory holds (N ~ 27,000), which K8's streaming selection never keeps
    whole. Held to the plain rule over chunks of rows, and K3's cnt/scb to
    the plain statistics of its own idx. One past the streaming
    selection's cap (k8_past_cap, k = 257) K8's fold-merge tournament
    merges chunks of the row through the scratch: held to the plain rule
    too, and exactly to two other selections on the same distances: K6
    (four folds) against K8 at two, and its first k - 1 columns against
    the streaming selection at k - 1."""
    r = np.random.default_rng(30000)
    x = _randn(r, 1, 30000, 9).to(dev)
    k = 80
    if entry == "k8_past_cap":
        k = _ext.knn_stream_cap() + 1
        idx = knn_indices_fold(x, k, 2)
        assert torch.equal(idx, knn_indices(x, k))
        assert torch.equal(idx[..., :k - 1], knn_indices_fold(x, k - 1, 2))
    elif entry == "k3":
        btab = _randn(r, 1, 30000, 16).to(dev)
        idx, cnt, scb = knn_with_stats(x, btab, k)
        ref_cnt, ref_scb = neighbor_stats_plain(idx, btab)
        assert torch.equal(cnt, ref_cnt)
        assert (scb - ref_scb).abs().max() <= 1e-5 * ref_scb.abs().max()
    elif entry == "k6":
        idx = knn_indices(x, k)
    else:
        idx = knn_indices_fold(x, k, 4)
        assert torch.equal(idx, knn_indices(x, k))
    torch.cuda.synchronize()
    assert idx.shape == (1, 30000, k)
    _assert_same_graph(x, idx, _knn_plain_by_rows(x, k))


def test_model_on_card_agrees_with_cpu(dev):
    """evaluate_multi at the model's widths: kernels on the card vs plain
    versions on the CPU, same weights and inputs."""
    g = torch.Generator().manual_seed(0)
    cpu = GWCAPL(num_gw=150, generator=g)
    gpu = GWCAPL(num_gw=150, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(1)
    x = _randn(r, 2, 512, 9)
    gp = _randn(r, 150, 192)
    gened = _randn(r, 2, 13, 128)
    bc = torch.from_numpy((r.random((7, 150)) < 0.3).astype(np.float32))
    nc = torch.from_numpy((r.random((2, 6, 150)) < 0.3).astype(np.float32))
    with torch.inference_mode():
        ref, _, _ = cpu.evaluate_multi(x, gp, gened, bc, nc)
        got, _, _ = gpu.evaluate_multi(*(a.to(dev) for a in
                                         (x, gp, gened, bc, nc)))
    got = got.cpu()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    assert agree >= 0.999, agree
    close = ((got - ref).abs() <= 1e-3).all(-1).float().mean().item()
    assert close >= 0.999, close


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,d", [(2, 128, 8), (16, 2048, 64), (1, 33, 64),
                                   (2, 128, 30), (2, 300, 128), (1, 70, 72),
                                   (16, 2048, 128), (2, 300, 192)])
def test_attention_train_kernels_match_plain(dev, b, n, d, rate):
    """K5a and K5b against their twins on the same inputs (the same mask,
    bit for bit: out, m, den within 1e-5; dq, dk, dv within 1e-4 of the
    largest entry), then the Function against the plain twin under
    autograd."""
    r = np.random.default_rng(n + d)
    q, k, v, dy = (_randn(r, b, n, d).to(dev) for _ in range(4))
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    temp = d ** 0.5
    before = (calls("op.k5a"), calls("op.k5b"))
    got = atr._fwd(q, k, v, seed, temp, rate)
    ref = atr._fwd_plain(q, k, v, seed, temp, rate)
    torch.cuda.synchronize()
    for g, w in zip(got, ref):
        assert _rel(g, w) <= 1e-5
    delta = (dy * ref[0]).sum(-1)
    got_b = atr._bwd(q, k, v, seed, ref[1], ref[2], delta, dy, temp, rate)
    ref_b = atr._bwd_plain(q, k, v, seed, ref[1], ref[2], delta, dy, temp,
                           rate)
    torch.cuda.synchronize()
    assert (calls("op.k5a"), calls("op.k5b")) == (before[0] + 1,
                                                  before[1] + 1)
    for g, w in zip(got_b, ref_b):
        assert _rel(g, w) <= 1e-4

    def run(fn):
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*ins, seed, temp, rate)
        return [out] + list(torch.autograd.grad((out * dy).sum(), ins))

    for g, w in zip(run(atr.attention_train), run(atr.attention_train_plain)):
        assert _rel(g.detach(), w.detach()) <= 1e-4


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,d", [(16, 2048, 64), (1, 33, 64), (2, 300, 30),
                                   (16, 2048, 128), (2, 300, 192)])
def test_attention_train_kernel_chain_matches_plain_chain(dev, b, n, d, rate):
    """K5b on K5a's own m, den and out (Delta) against the twins' chain:
    dq, dk, dv within 1e-4 of the largest entry."""
    r = np.random.default_rng(n + d + 1)
    q, k, v, dy = (_randn(r, b, n, d).to(dev) for _ in range(4))
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    temp = d ** 0.5
    out, m, den = atr._fwd(q, k, v, seed, temp, rate)
    got = atr._bwd(q, k, v, seed, m, den, (dy * out).sum(-1), dy, temp, rate)
    out_p, m_p, den_p = atr._fwd_plain(q, k, v, seed, temp, rate)
    ref = atr._bwd_plain(q, k, v, seed, m_p, den_p, (dy * out_p).sum(-1), dy,
                         temp, rate)
    torch.cuda.synchronize()
    for g, w in zip(got, ref):
        assert _rel(g, w) <= 1e-4


@pytest.mark.parametrize("offset", [8, 1000])
@pytest.mark.parametrize("b,n,d", [(8, 2048, 64), (2, 300, 30),
                                   (2, 300, 192)])
def test_attention_train_kernels_at_a_batch_offset(dev, b, n, d, offset):
    """K5a and K5b at a batch_offset (a data-parallel rank's first global
    row) against their twins at that offset (out, m, den within 1e-5; dq,
    dk, dv within 1e-4 of the largest entry); the kernel's forward at the
    offset is the forward of the global batch's rows there."""
    r = np.random.default_rng(n + d + offset)
    q, k, v, dy = (_randn(r, b, n, d).to(dev) for _ in range(4))
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    temp = d ** 0.5
    got = atr._fwd(q, k, v, seed, temp, 0.1, offset)
    ref = atr._fwd_plain(q, k, v, seed, temp, 0.1, offset)
    delta = (dy * ref[0]).sum(-1)
    args = (q, k, v, seed, ref[1], ref[2], delta, dy, temp, 0.1, offset)
    got_b, ref_b = atr._bwd(*args), atr._bwd_plain(*args)
    pad = torch.zeros((offset,) + q.shape[1:], device=dev)
    whole = atr._fwd(*(torch.cat([pad, x]) for x in (q, k, v)), seed, temp,
                     0.1)[0][offset:]
    torch.cuda.synchronize()
    for g, w in zip(got, ref):
        assert _rel(g, w) <= 1e-5
    for g, w in zip(got_b, ref_b):
        assert _rel(g, w) <= 1e-4
    assert torch.equal(whole, got[0])


def test_attention_train_wrappers_refuse_what_they_cannot_take(dev):
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    a = torch.zeros((1, 16, 8), device=dev)
    with pytest.raises(ValueError, match="must all be"):
        atr.attention_train(a, a[:, :, :6].contiguous(), a, seed, 1.0, 0.1)
    with pytest.raises(TypeError, match="float32"):
        atr.attention_train(a.double(), a.double(), a.double(), seed, 1.0,
                            0.1)
    with pytest.raises(ValueError, match="contiguous"):
        t_ = a.transpose(1, 2).contiguous().transpose(1, 2)
        atr._fwd(t_, t_, t_, seed, 1.0, 0.1)
    with pytest.raises(ValueError, match="seed"):
        atr._fwd(a, a, a, seed.long(), 1.0, 0.1)
    with pytest.raises(ValueError, match="batch_offset"):
        atr._fwd(a, a, a, seed, 1.0, 0.1, -1)


def test_gwcapl_train_step_on_card_agrees_with_cpu(dev, monkeypatch):
    """One full-width GFS train step (attention dropout 0, a fixed
    fake_row) on the card and on the CPU from the same weights: loss within
    1e-4, every gradient's cosine >= 0.999 (rounding-noise pairs under 1e-5
    of the largest norm left out), running statistics within 1e-4, with
    the card's kNN graphs replayed on the CPU (see the DGCNNSeg test)."""
    from gfs3dseg_gws_tpu_torch.models import dgcnn

    graphs = []

    def record(x, btab, k):
        out = knn_with_stats(x, btab, k)
        graphs.append(out[0].cpu())
        return out

    def replay(x, btab, k):
        idx = graphs.pop(0)
        differ = (idx.sort(-1).values
                  != knn_indices_plain(x, k).sort(-1).values).any(-1)
        assert differ.float().mean() <= 1e-3
        return (idx,) + neighbor_stats_plain(idx, btab)

    cpu = GWCAPL(num_gw=150, attn_dropout=0.0).train_init(
        torch.Generator().manual_seed(1))
    gpu = GWCAPL(num_gw=150, attn_dropout=0.0, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(4)
    x = _randn(r, 4, 512, 9)
    y = torch.from_numpy(r.integers(0, 8, (4, 512)))
    gp = _randn(r, 150, 192)
    fake = torch.zeros(13)
    fake[[2, 5, 6]] = 1.0
    losses = []
    for model, device, knn in ((gpu, dev, record), (cpu, "cpu", replay)):
        monkeypatch.setattr(dgcnn, "knn_with_stats", knn)
        model.train()
        _, loss = model(x.to(device), y.to(device), gp.to(device),
                        fake_row=fake.to(device))
        loss.backward()
        losses.append(loss.item())
    assert not graphs
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[1])
    grads = [(name, pc.grad.double().flatten(),
              pg.grad.cpu().double().flatten())
             for (name, pc), (_, pg) in zip(cpu.named_parameters(),
                                            gpu.named_parameters())]
    floor = 1e-5 * max(gc.norm().item() for _, gc, _ in grads)
    for name, gc, gg in grads:
        if gc.norm() < floor and gg.norm() < floor:
            continue
        cos = (gc @ gg / (gc.norm() * gg.norm()).clamp_min(1e-300)).item()
        assert cos >= 0.999, (name, cos)
    for (name, bc), (_, bg) in zip(cpu.named_buffers(), gpu.named_buffers()):
        if name.endswith(("running_mean", "running_var")):
            assert ((bc - bg.cpu()).abs() <= 1e-4 * bc.abs().clamp_min(
                1.0)).all(), name


# --------------------------------------------------------------------------- #
# the train step replayed as a CUDA graph (parallel/steps.py)
# --------------------------------------------------------------------------- #

GRAPH_WIDTHS = {"default": [[64, 64], [64, 64], [64, 64]],
                "semseg": [[64, 64], [64, 64], [64]]}
GRAPH_STEPS = 8
# gaps after one step from one state. A parameter's gap is that of its
# update: |p_graph - p_eager| / |p_eager - p_before| (2-norms over the
# leaf), so that an update off by a factor reads as that factor less one
# (an LR that missed the schedule's halving reads 1). A moment's gap is
# over its largest value. Two eager runs part by up to 8.7e-5 in a leaf's
# update and 2.7e-6 in Adam's moments (K4b's, K5b's and K7's atomics move
# a gradient's last bits); the losses and BatchNorm statistics, which no
# atomic touches, agree bit for bit
GRAPH_TOL = 1e-3
GRAPH_MOMENTS_TOL = 1e-5
# biases whose shift a BatchNorm removes (a 1x1 conv's before its own
# BatchNorm; the base learner's last BatchNorm's before the fusion conv and
# its BatchNorm): their gradient is zero but for rounding, and Adam turns
# that noise into steps of about +-lr whose signs the atomics' order
# decides. Their Adam moments go with them.
BN_CANCELLED = ("base_learner.convs.0.0.bias", "base_learner.convs.1.0.bias",
                "base_learner.convs.1.1.bias", "fusion.0.bias")


def _exact_stats(idx, btab):
    """neighbor_stats_plain without float atomics: the adjacency counts
    (small integers, exact in any order), then one product."""
    b, n, _ = idx.shape
    cells = (idx.long() * n + torch.arange(n, device=idx.device)[
        None, :, None]).reshape(b, -1)
    adj = torch.zeros((b, n * n), device=idx.device).scatter_add_(
        1, cells, torch.ones_like(cells, dtype=torch.float32)).view(b, n, n)
    return adj.sum(-1)[:, None, :], adj @ btab


class _PinnedGraphs:
    """The kNN graphs of the steps, held fixed across runs. Without this
    two eager runs part within a few steps: the atomics' order moves the
    gradients' last bits, and a feature kNN (blocks 2 and 3) flips a
    neighbour at a near-tie, which moves the loss by ~1e-3. Each EdgeConv's
    K3 (K6) still runs; a recording run keeps its indices, and a pinning
    run copies the recorded ones of its step into them from one device
    buffer a block and batch size, refilled before each step (so that a
    replay reads them); K3's neighbour statistics are recomputed without
    atomics from the indices used. The atomics of K4b, K5b and K7 still
    add in no fixed order."""

    def __init__(self, monkeypatch, blocks):
        from gfs3dseg_gws_tpu_torch.models import dgcnn

        self.blocks, self.recorded, self.buffers = blocks, [], {}
        self.pinning, self.step, self.block = False, 0, 0
        stats, indices = dgcnn.knn_with_stats, dgcnn.knn_indices

        def with_stats(x, btab, k):
            idx = self._take(stats(x, btab, k)[0])
            return (idx,) + _exact_stats(idx, btab)

        def plain(*args, **kwargs):
            return self._take(indices(*args, **kwargs))

        monkeypatch.setattr(dgcnn, "knn_with_stats", with_stats)
        monkeypatch.setattr(dgcnn, "knn_indices", plain)

    def start(self, step):
        """Before step `step`: its recorded graphs into the buffers."""
        self.step, self.block = step, 0
        if not self.pinning:
            self.recorded.append([])
            return
        for block, idx in enumerate(self.recorded[step]):
            key = (block, idx.shape[0])
            if key in self.buffers:
                self.buffers[key].copy_(idx)
            else:
                self.buffers[key] = idx.clone()

    def _take(self, idx):
        block, self.block = self.block, (self.block + 1) % self.blocks
        if not self.pinning:
            self.recorded[self.step].append(idx.clone())
            return idx
        return idx.copy_(self.buffers[(block, idx.shape[0])])


def _graph_inputs(dev, widths, batch=16, n=2048, steps=GRAPH_STEPS):
    """Weights, batches and basis of the graph tests (seeded, on `dev`)."""
    init = GWCAPL(num_gw=150, edgeconv_widths=widths).train_init(
        torch.Generator().manual_seed(2)).state_dict()
    r = np.random.default_rng(3)
    xs = [_randn(r, batch, n, 9).to(dev) for _ in range(steps)]
    ys = [torch.from_numpy(r.integers(0, 8, (batch, n))).to(dev)
          for _ in range(steps)]
    gp = _randn(r, 150, sum(w[-1] for w in widths)).to(dev)
    return init, xs, ys, gp


class _Missed:
    """A schedule that steps `sched`, then puts the first LR back into the
    LR tensors of the groups `missed`: a graph whose LR in those groups
    misses the schedule."""

    def __init__(self, sched, opt, missed):
        self.sched = sched
        self.kept = [(opt.param_groups[i]["lr"],
                      opt.param_groups[i]["lr"].item()) for i in missed]

    def step(self):
        self.sched.step()
        for lr, first in self.kept:
            lr.fill_(first)


class _Run:
    """One model, its optimizer, schedule and generator, stepped by `step`
    (gfs_train_step, or the eager `_gfs_step`); the LR of the groups
    `missed` (0: the encoder's, 1: the rest's) misses the schedule."""

    def __init__(self, dev, widths, init, step, step_size, missed=()):
        from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer

        self.model = GWCAPL(num_gw=150, edgeconv_widths=widths, device=dev)
        self.model.load_state_dict(init)
        self.opt, self.sched = make_gfs_optimizer(self.model, 0.01, 1,
                                                  step_size, 0.5)
        if missed:
            self.sched = _Missed(self.sched, self.opt, missed)
        self.gen = torch.Generator(device=dev)
        self.step = step

    def __call__(self, i, x, y, gp):
        from gfs3dseg_gws_tpu_torch.pipelines.gfs import step_seed

        self.gen.manual_seed(step_seed(7, i))
        return self.step(self.model, self.opt, x, y, gp, self.gen,
                         self.sched)[0]

    def state(self):
        """Parameters, buffers and Adam's moments and step counts."""
        out = dict(self.model.state_dict())
        for n, p in self.model.named_parameters():
            for key, t in self.opt.state.get(p, {}).items():
                out[f"{n}.{key}"] = t
        return out

    @torch.no_grad()
    def load(self, state):
        """`state` into this run's tensors, in place (a graph reads them
        where they lie)."""
        for name, t in self.state().items():
            t.copy_(state[name])


def _eager(model, opt, x, y, gp, gen, sched):
    from gfs3dseg_gws_tpu_torch.parallel.steps import _gfs_step

    return _gfs_step(model, opt, x, y, gp, gen, sched, None, None)


def _replayed(model, opt, x, y, gp, gen, sched):
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_train_step

    return gfs_train_step(model, opt, x, y, gp, gen, sched)


def _gaps(got, ref, before, cancelled=BN_CANCELLED):
    """The gaps (GRAPH_TOL's comment) of a state `got` from `ref` after a
    step from `before`, over the floating entries but the buffers, the
    `cancelled` biases' (and their moments) and Adam's step counts; and
    whether every buffer is bit-equal."""
    def gap(name, t):
        diff = got[name].double() - t.double()
        if name.endswith(("exp_avg", "exp_avg_sq")):
            return (diff.abs().max()
                    / t.double().abs().max().clamp_min(1e-30)).item()
        change = t.double() - before[name].double()
        return (diff.norm() / change.norm().clamp_min(1e-30)).item()

    gaps = {name: gap(name, t) for name, t in ref.items()
            if t.is_floating_point() and t.dim() > 0
            and not name.startswith(cancelled) and "running" not in name}
    same = all(torch.equal(got[name], t) for name, t in ref.items()
               if "running" in name or "num_batches" in name)
    return gaps, same


def _lockstep(dev, widths, inputs, monkeypatch, step_size=5, missed=(),
              between=None):
    """An eager run E steps through `inputs`, and before each of its steps
    a second eager run E2 and a graph run G (gfs_train_step: three eager
    calls, a capture, replays) are set to E's state and take the same step
    on E's kNN graphs, so that each step is compared from one state: the
    atomics' order moves a gradient's last bits, which Adam and the
    feature kNN amplify over a run until two eager runs differ by ~1e-3 in
    their losses. `between(i, do)` may wrap G's i-th call; G's LR misses
    the schedule in the groups `missed` (_Run). Returns per
    step, for G and for E2: (loss bit-equal to E's, buffers bit-equal to
    E's, gaps of the rest of the state after the step)."""
    init, xs, ys, gp = inputs
    pins = _PinnedGraphs(monkeypatch, len(widths))
    ref = _Run(dev, widths, init, _eager, step_size)
    gauge = _Run(dev, widths, init, _eager, step_size)
    graph = _Run(dev, widths, init, _replayed, step_size, missed)
    out = []
    for i, (x, y) in enumerate(zip(xs, ys)):
        before = {n: t.clone() for n, t in ref.state().items()}
        pins.pinning = False
        pins.start(i)
        loss = ref(i, x, y, gp)
        after = ref.state()
        pins.pinning = True
        step = []
        for run in (graph, gauge):
            run.load(before)
            pins.start(i)
            do = lambda run=run: run(i, x, y, gp)   # noqa: E731
            got = between(i, do) if between and run is graph else do()
            step.append((torch.equal(got, loss),)
                        + _gaps(run.state(), after, before)[::-1])
        out.append(step)
    torch.cuda.synchronize()
    return out, graph


def _largest(steps, run, kind):
    """(gap, name, step) of the largest gap of `run` (0: G, 1: E2) over
    the steps, among the moments or the other entries (`kind`)."""
    return max((gap, name, i) for i, s in enumerate(steps)
               for name, gap in s[run][2].items()
               if name.endswith(("exp_avg", "exp_avg_sq")) == (
                   kind == "moments"))


def _graph_counts(step="train_step"):
    from gfs3dseg_gws_tpu_torch.utils.observability import snapshot

    counters = snapshot()["plain"]["counters"]
    return (counters.get(f"{step}/graph_captures", 0),
            counters.get(f"{step}/graph_replays", 0))


def _assert_as_eager(steps, label):
    """Every step's loss and BatchNorm statistics bit for bit E's, its
    Adam moments within GRAPH_MOMENTS_TOL of E's and its parameters within
    GRAPH_TOL. Prints the largest gaps, G's and E2's (pytest -s)."""
    print(f"{label}: losses and BN statistics bit-equal in "
          f"{sum(s[0][0] and s[0][1] for s in steps)} of {len(steps)} steps "
          f"(eager vs eager {sum(s[1][0] and s[1][1] for s in steps)}); "
          + "; ".join(f"largest {kind} gap {g:.3e} ({n}, step {i}), eager "
                      f"vs eager {e:.3e} ({m}, step {j})"
                      for kind in ("parameter", "moments")
                      for (g, n, i), (e, m, j) in [(_largest(steps, 0, kind),
                                                    _largest(steps, 1, kind))]))
    assert all(s[0][0] and s[0][1] for s in steps)
    assert _largest(steps, 0, "moments")[0] <= GRAPH_MOMENTS_TOL
    assert _largest(steps, 0, "parameter")[0] <= GRAPH_TOL


@pytest.mark.parametrize("config", sorted(GRAPH_WIDTHS))
def test_replayed_steps_follow_the_eager_trajectory(dev, config,
                                                    monkeypatch):
    """GRAPH_STEPS steps from the same weights, batches, per-step seeds and
    kNN graphs, eager and through gfs_train_step (three eager calls, a
    capture, replays), each from the eager run's state: the same losses,
    parameters, Adam moments and BatchNorm statistics, with StepLR halving
    the LR between two replays (before step 6); one capture and
    GRAPH_STEPS - 4 replays counted; the LR tensors hold the halved LR."""
    widths = GRAPH_WIDTHS[config]
    inputs = _graph_inputs(dev, widths)
    before = _graph_counts()
    steps, graph = _lockstep(dev, widths, inputs, monkeypatch)
    after = _graph_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (
        1, GRAPH_STEPS - 4)
    _assert_as_eager(steps, f"{config} replayed")
    assert [g["lr"].item() for g in graph.opt.param_groups] == \
        pytest.approx([0.01 * 0.1 * 0.5, 0.01 * 0.5], rel=1e-7)


@pytest.mark.parametrize("missed", [(0,), (1,), (0, 1)],
                         ids=["encoder", "rest", "both"])
def test_a_graph_whose_lr_misses_the_schedule_fails_the_check(dev, missed,
                                                              monkeypatch):
    """As the test above, with G's LR tensors of the groups `missed` held
    at the first LR (0: the encoder's, 1: the rest's): the steps before the
    halving pass the check; after it, each missed group's parameters take
    updates twice the eager ones (gaps 1 within GRAPH_TOL, the median over
    the group's leaves), the other group's stay within GRAPH_TOL, and the
    check fails."""
    widths = GRAPH_WIDTHS["default"]
    steps, _ = _lockstep(dev, widths, _graph_inputs(dev, widths),
                         monkeypatch, missed=missed)
    _assert_as_eager(steps[:5], f"missed {missed}, before the halving")

    def group(name):
        return 0 if name.startswith("encoder.") else 1

    for i, s in enumerate(steps[5:], 5):
        updates = {g: [gap for name, gap in s[0][2].items()
                       if group(name) == g
                       and not name.endswith(("exp_avg", "exp_avg_sq"))]
                   for g in (0, 1)}
        medians = {g: statistics.median(v) for g, v in updates.items()}
        print(f"missed {missed}, step {i}: median update gap by group "
              f"{medians}, largest {({g: max(v) for g, v in updates.items()})}")
        for g, gaps in updates.items():
            if g in missed:
                assert abs(medians[g] - 1.0) <= GRAPH_TOL, (i, g, medians)
            else:
                assert max(gaps) <= GRAPH_TOL, (i, g, max(gaps))
    with pytest.raises(AssertionError):
        _assert_as_eager(steps, f"missed {missed}")


def test_a_profiled_step_between_replays_keeps_the_trajectory(dev,
                                                             monkeypatch):
    """Step 6 of 8 under torch.profiler runs eagerly between replays (no
    replay counted for it), and every step still agrees with the eager
    run's."""
    from torch.profiler import ProfilerActivity, profile

    def profiled(i, do):
        if i != 5:
            return do()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            out = do()
            torch.cuda.synchronize()
        return out

    widths = GRAPH_WIDTHS["default"]
    before = _graph_counts()
    steps, _ = _lockstep(dev, widths, _graph_inputs(dev, widths),
                         monkeypatch, between=profiled)
    after = _graph_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (
        1, GRAPH_STEPS - 5)
    _assert_as_eager(steps, "profiled step 6")


def test_a_second_shape_captures_its_own_graph(dev, monkeypatch):
    """Five steps at batch 16, then five at batch 8 (a final short batch):
    each shape warms up, captures once and replays (2 captures, 1 + 1
    replays), and every step agrees with the eager run's."""
    widths = GRAPH_WIDTHS["default"]
    init, xs, ys, gp = _graph_inputs(dev, widths, steps=5)
    inputs = (init, xs + [x[:8] for x in xs], ys + [y[:8] for y in ys], gp)
    before = _graph_counts()
    steps, _ = _lockstep(dev, widths, inputs, monkeypatch)
    after = _graph_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (2, 2)
    _assert_as_eager(steps, "two shapes")


# the pre-training step replayed as a CUDA graph: the same measures and
# limits. The segmenter's second conv bias is the one whose shift a
# BatchNorm removes (BN_CANCELLED's comment)
PRETRAIN_BN_CANCELLED = ("segmenter.3.bias",)


def _pretrain_inputs(dev, widths, batch=16, n=2048, steps=GRAPH_STEPS):
    """Weights and batches of the pre-training graph tests (seeded)."""
    init = DGCNNSeg(8, edgeconv_widths=widths,
                    generator=torch.Generator().manual_seed(2)).state_dict()
    r = np.random.default_rng(3)
    xs = [_randn(r, batch, n, 9).to(dev) for _ in range(steps)]
    ys = [torch.from_numpy(r.integers(0, 8, (batch, n))).to(dev)
          for _ in range(steps)]
    return init, xs, ys


class _PretrainRun:
    """A DGCNNSeg, Adam with L2 weight decay 1e-4 and its StepLR, and a
    device generator for the dropout masks, stepped by `step`
    (pretrain_step, or the eager `_pretrain_step`); with `missed` the LR
    misses the schedule (_Missed)."""

    def __init__(self, dev, widths, init, step, step_size, missed=False):
        from gfs3dseg_gws_tpu_torch.parallel.optim import (
            make_pretrain_optimizer)

        self.model = DGCNNSeg(8, edgeconv_widths=widths, device=dev)
        self.model.load_state_dict(init)
        self.opt, self.sched = make_pretrain_optimizer(
            self.model.parameters(), 1e-3, 1, 1e-4, step_size, 0.5)
        if missed:
            self.sched = _Missed(self.sched, self.opt, (0,))
        self.gen = torch.Generator(device=dev).manual_seed(7)
        self.step = step

    def __call__(self, x, y):
        return self.step(self.model, self.opt, x, y, self.gen, self.sched)

    state = _Run.state
    load = _Run.load


def _pretrain_eager(model, opt, x, y, gen, sched):
    from gfs3dseg_gws_tpu_torch.parallel.steps import _pretrain_step

    return _pretrain_step(model, opt, x, y, gen, sched, None)


def _pretrain_replayed(model, opt, x, y, gen, sched):
    from gfs3dseg_gws_tpu_torch.parallel.steps import pretrain_step

    return pretrain_step(model, opt, x, y, gen, sched)


def _pretrain_lockstep(dev, widths, inputs, monkeypatch, step_size=5,
                       missed=False, between=None):
    """As _lockstep, for pretrain_step: an eager run E steps through
    `inputs`, its generator seeded once and moving on; before each of its
    steps a second eager run E2 and a graph run G take E's state, the
    generator's seed and offset included, and the same step on E's kNN
    graphs. Returns per step, for G and for E2: (loss bit-equal to E's,
    buffers bit-equal to E's, gaps of the rest of the state)."""
    init, xs, ys = inputs
    pins = _PinnedGraphs(monkeypatch, len(widths))
    ref = _PretrainRun(dev, widths, init, _pretrain_eager, step_size)
    gauge = _PretrainRun(dev, widths, init, _pretrain_eager, step_size)
    graph = _PretrainRun(dev, widths, init, _pretrain_replayed, step_size,
                         missed)
    out = []
    for i, (x, y) in enumerate(zip(xs, ys)):
        before = {n: t.clone() for n, t in ref.state().items()}
        drawn = ref.gen.get_state()
        pins.pinning = False
        pins.start(i)
        loss = ref(x, y)
        after = ref.state()
        pins.pinning = True
        step = []
        for run in (graph, gauge):
            run.load(before)
            run.gen.set_state(drawn)
            pins.start(i)
            do = lambda run=run: run(x, y)          # noqa: E731
            got = between(i, run, do) if between and run is graph else do()
            step.append((torch.equal(got, loss),)
                        + _gaps(run.state(), after, before,
                                PRETRAIN_BN_CANCELLED)[::-1])
        out.append(step)
    torch.cuda.synchronize()
    return out, graph


@pytest.mark.parametrize("config", sorted(GRAPH_WIDTHS))
def test_replayed_pretrain_steps_follow_the_eager_trajectory(dev, config,
                                                             monkeypatch):
    """GRAPH_STEPS pre-training steps from the same weights, batches,
    generator states and kNN graphs, eager and through pretrain_step
    (three eager calls, a capture, replays), each from the eager run's
    state: the same losses (so the same dropout masks), parameters, Adam
    moments and BatchNorm statistics, with StepLR halving the LR between
    two replays (before step 6); one capture and GRAPH_STEPS - 4 replays
    counted; the LR tensor holds the halved LR."""
    widths = GRAPH_WIDTHS[config]
    before = _graph_counts("pretrain_step")
    steps, graph = _pretrain_lockstep(
        dev, widths, _pretrain_inputs(dev, widths), monkeypatch)
    after = _graph_counts("pretrain_step")
    assert (after[0] - before[0], after[1] - before[1]) == (
        1, GRAPH_STEPS - 4)
    _assert_as_eager(steps, f"pretrain {config} replayed")
    assert graph.opt.param_groups[0]["lr"].item() == pytest.approx(
        1e-3 * 0.5, rel=1e-7)


def test_a_pretrain_graph_whose_lr_misses_the_schedule_fails_the_check(
        dev, monkeypatch):
    """As the test above, with G's LR tensor held at the first LR: the
    steps before the halving pass the check; after it every leaf takes an
    update twice the eager one (median gap 1 within GRAPH_TOL), and the
    check fails."""
    widths = GRAPH_WIDTHS["default"]
    steps, _ = _pretrain_lockstep(dev, widths,
                                  _pretrain_inputs(dev, widths), monkeypatch,
                                  missed=True)
    _assert_as_eager(steps[:5], "pretrain missed LR, before the halving")
    for i, s in enumerate(steps[5:], 5):
        gaps = [gap for name, gap in s[0][2].items()
                if not name.endswith(("exp_avg", "exp_avg_sq"))]
        median = statistics.median(gaps)
        print(f"pretrain missed LR, step {i}: median update gap {median}")
        assert abs(median - 1.0) <= GRAPH_TOL, (i, median)
    with pytest.raises(AssertionError):
        _assert_as_eager(steps, "pretrain missed LR")


def test_a_pretrain_graph_without_weight_decay_fails_the_check(dev,
                                                               monkeypatch):
    """As the first test, with G's weight decay set to 0 just before the
    call that captures its graph: the three eager steps pass the check,
    the captured and replayed ones, which leave the decay out, fail it."""
    def undecayed(i, run, do):
        if i == 3:
            for group in run.opt.param_groups:
                group["weight_decay"] = 0.0
        return do()

    widths = GRAPH_WIDTHS["default"]
    steps, _ = _pretrain_lockstep(dev, widths,
                                  _pretrain_inputs(dev, widths), monkeypatch,
                                  between=undecayed)
    _assert_as_eager(steps[:3], "pretrain, eager steps before the capture")
    for i, s in enumerate(steps[3:], 3):
        print(f"pretrain without decay, step {i}: largest gaps "
              f"{sorted(s[0][2].values())[-3:]}")
    with pytest.raises(AssertionError):
        _assert_as_eager(steps[3:], "pretrain graph without weight decay")
