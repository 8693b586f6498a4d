"""The plain reference against the port's CPU path (its plain twins) at
small sizes: one training pass and one evaluation pass on random points
(no near-ties, so they agree to rounding), and whole runs on synthetic
blocks, whose numbers lie within the small sizes' own bounds. The
reference imports nothing of the port or of JAX."""
import ast
import glob
import os

import numpy as np
import pytest
import torch

import weights
from reference import data as refdata
from reference import gwcapl
from tiny import MODEL, run_tiny
from tracer import HERE

CFG = dict(MODEL, pc_npts=256, attn_dropout=0.1, cosine_scale=10.0,
           eval_weight=1.2, energy=0.9, total_classes=13,
           pc_attribs="xyzrgbXYZ", cvfold=0, base_lr=0.01,
           encoder_lr_scale=0.1)


def port_model(widths):
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL

    return GWCAPL(classes=13, base_num=7, num_gw=24, main_dim=8,
                  edgeconv_widths=widths, mlp_widths=(16, 16),
                  base_widths=(8, 8), output_dim=8, k=5, attn_dropout=0.1,
                  eval_weight=1.2)


WIDTHS = [((8, 8), (8, 8), (8, 8)), ((8, 8), (8, 8), (8,))]


@pytest.mark.parametrize("widths", WIDTHS)
def test_train_pass_matches_the_port(widths):
    torch.manual_seed(0)
    m = port_model(widths)
    state = weights.train_state(m.state_dict(), 7, "cpu")
    m.load_state_dict(state)
    m.train()
    x, y = torch.rand(4, 256, 9), torch.randint(0, 8, (4, 256))
    gp = torch.randn(24, sum(w[-1] for w in widths))
    _, loss = m(x, y, gp, torch.Generator().manual_seed(5))
    loss.backward()
    cfg = dict(CFG, edgeconv_widths=[list(w) for w in widths])
    p = {k: v.clone() for k, v in state.items()}
    names = [n for n, _ in m.named_parameters()]
    for n in names:
        p[n].requires_grad_(True)
    with gwcapl.precision("fp32"):
        ref = gwcapl.train_loss(p, cfg, x, y, gp, 7,
                                torch.Generator().manual_seed(5))
    grads = torch.autograd.grad(ref, [p[n] for n in names])
    assert float(loss) == pytest.approx(float(ref.detach()), rel=1e-5)
    # the first EdgeConv's weight gradient is ill-conditioned in float32:
    # the port's own float32 and float64 passes differ by ~7e-4 of its norm
    params = dict(m.named_parameters())
    median = float(np.median([float(g.norm()) for g in grads]))
    for n, g in zip(names, grads):
        scale = max(float(g.norm()), median)
        assert float((params[n].grad - g).norm()) <= 2e-3 * scale, n


@pytest.mark.parametrize("widths", WIDTHS)
def test_eval_pass_matches_the_port(widths):
    m = port_model(widths)
    state = weights.eval_state(m.state_dict(), 11, "cpu")
    m.load_state_dict(state)
    x = torch.rand(2, 256, 9)
    gp = torch.randn(24, sum(w[-1] for w in widths))
    gened = torch.nn.functional.normalize(torch.randn(3, 13, 8), dim=-1)
    base = (torch.rand(7, 24) < 0.3).float()
    novel = (torch.rand(3, 6, 24) < 0.3).float()
    with torch.inference_mode():
        got = m.evaluate_multi(x, gp, gened, base, novel)[0]
    cfg = dict(CFG, edgeconv_widths=[list(w) for w in widths])
    codings = torch.cat([base.expand(3, 7, 24), novel], dim=1)
    with gwcapl.precision("fp32"), torch.no_grad():
        ref = gwcapl.eval_logits(state, cfg, x, gp, gened, codings, 7)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_energy_multihot_keeps_the_word_that_passes_the_threshold():
    h = np.array([0.1, 0.5, 0.3, 0.1])
    assert refdata.energy_multihot(h, 0.7).tolist() == [0, 1, 1, 0]
    assert refdata.energy_multihot(h, 0.8).tolist() == [0, 1, 1, 0]
    assert refdata.energy_multihot(h, 0.81).tolist() == [1, 1, 1, 0]


# whole runs at the small sizes: widths of 8 and k = 5 meet more kNN
# near-ties than the cells' 64 and 20 (the eval logits are not replayed
# at them), so these bounds are the small sizes' own, not the cells'
# limits; the training numbers, their graphs taken at near-ties, are at
# rounding (Adam's first steps move leaves whose gradient is round-off by
# the full learning rate, hence the change's looser bound)
TINY_BOUNDS = {"logit_miss": 0.02, "label_count_gap": 0.0,
               "loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-2,
               "grad_err_median": 1e-4, "graph_untied": 0.0,
               "loader_rows_unmatched": 0.0}


@pytest.mark.parametrize("cell", ["gwcapl_s3dis.eval_sweep",
                                  "gwcapl_s3dis_semseg.gfs_train"])
def test_whole_run_agrees_with_the_reference(cell):
    res = run_tiny(cell)
    for n, c in res["compared"].items():
        assert c["value"] <= TINY_BOUNDS[n], (n, c)


def test_the_reference_imports_nothing_of_the_programs():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top in ("torch", "numpy", "reference", "__future__",
                               "contextlib", "math", "typing", "glob", "os"), \
                    (path, name)
