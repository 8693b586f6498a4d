"""PyTorch port on the GPU: the hand-written CUDA kernels against their plain
PyTorch versions on the card, and the model on the card against the CPU.

Marked `cuda`: without a CUDA device every test skips. On the GPU host
(which has no JAX, so the repo's JAX conftest is left out):

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_port_cuda.py
"""
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
    before = fused_edgeconv_infer.launches
    got = fused_edgeconv_infer(*[a.to(dev) for a in args], k)
    torch.cuda.synchronize()
    assert fused_edgeconv_infer.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,n,d", [(2, 100, 16), (2, 2048, 64), (1, 33, 64),
                                   (3, 130, 44), (2, 100, 30), (2, 300, 128),
                                   (1, 70, 72), (16, 2048, 128),
                                   (2, 300, 192)])
def test_fused_attention_kernel_matches_plain(dev, b, n, d):
    r = np.random.default_rng(n + d)
    q, k, v = (_randn(r, b, n, d).to(dev) for _ in range(3))
    before = fused_attention.launches
    got = fused_attention(q, k, v, d ** 0.5)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    torch.testing.assert_close(got, attention_plain(q, k, v, d ** 0.5),
                               rtol=1e-4, atol=1e-5)


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
    before = knn_with_stats.launches
    idx, cnt, scb = knn_with_stats(x, btab, k)
    torch.cuda.synchronize()
    assert knn_with_stats.launches == before + 1
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

    before = (fet._gsf.launches, fet._bwd.launches)
    f_outs, f_grads = run(fet.fused_edgeconv_train, cnt=cnt, scb=scb)
    assert (fet._gsf.launches, fet._bwd.launches) == (before[0] + 1,
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

    def record_idx(x, k):
        idx = knn_indices(x, k)
        graphs.append(idx.cpu())
        return idx

    def replay_idx(x, k):
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
    before = (knn_indices.launches, scatter_bwd.launches)
    for model, device, knn, knn_idx in ((gpu, dev, record, record_idx),
                                        (cpu, "cpu", replay, replay_idx)):
        monkeypatch.setattr(dgcnn, "knn_with_stats", knn)
        monkeypatch.setattr(dgcnn, "knn_indices", knn_idx)
        loss = cross_entropy(model(x.to(device)), y.to(device))
        loss.backward()
        losses.append(loss.item())
    assert not graphs
    one_deep = sum(len(w) != 2 for w in widths)
    assert (knn_indices.launches, scatter_bwd.launches) == (
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
    before = knn_indices.launches
    idx = knn_indices(x, k)
    torch.cuda.synchronize()
    assert knn_indices.launches == before + 1
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
    before = scatter_bwd.launches
    got = scatter_bwd(idx, g)
    torch.cuda.synchronize()
    assert scatter_bwd.launches == before + 1
    ref = scatter_bwd_plain(idx, g)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    table = _randn(r, b, n, c).to(dev)
    grads = []
    for fn in (gather_neighbors, gather_neighbors_plain):
        leaf = table.clone().requires_grad_()
        out = fn(leaf, idx)
        assert torch.equal(out, gather_neighbors_plain(table, idx))
        grads.append(torch.autograd.grad(out, leaf, g)[0])
    assert scatter_bwd.launches == before + 2
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
    before = (knn_indices.launches, gather_conv.launches)
    split = fused_edgeconv_infer_split(*args, k)
    torch.cuda.synchronize()
    assert (knn_indices.launches, gather_conv.launches) == (before[0] + 1,
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
    before = knn_indices_fold.launches
    idx = knn_indices_fold(x, k, folds)
    torch.cuda.synchronize()
    assert knn_indices_fold.launches == before + 1
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
    before = (atr._fwd.launches, atr._bwd.launches)
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
    assert (atr._fwd.launches, atr._bwd.launches) == (before[0] + 1,
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
