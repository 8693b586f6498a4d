"""Products (2 FLOPs a multiply-add) of one n-point block through the GFS
evaluation pass, term by term from the modules it runs (models/dgcnn.py,
models/attention.py, models/capl.py::evaluate): the kNN Gram matrix of
each EdgeConv's input, its neighbour and centre tables, its further
per-edge convs, the point MLP, the base learner, attention (QKV and the
two N x N products), the word cosine, the fusion conv and the prototype
heads of one support seed. Top-k, gathers, softmaxes and maxima are not
products. At the paper's widths this is 4.94 GFLOP."""


def flops(cfg, n):
    k, mac = cfg["dgcnn_k"], 0
    widths = [list(w) for w in cfg["edgeconv_widths"]]
    cins = [len(cfg["pc_attribs"])] + [w[-1] for w in widths[:-1]]
    for cin, w in zip(cins, widths):
        mac += n * n * cin
        mac += 2 * n * cin * w[0]
        prev = w[0]
        for wi in w[1:]:
            mac += n * k * prev * wi
            prev = wi
    d_cat = sum(w[-1] for w in widths)
    prev = d_cat
    for wi in cfg["dgcnn_mlp_widths"]:
        mac += n * prev * wi
        prev = wi
    d_feat = cfg["dgcnn_mlp_widths"][-1]
    prev = d_feat
    for wi in cfg["base_widths"]:
        mac += n * prev * wi
        prev = wi
    od = cfg["output_dim"]
    mac += 3 * n * d_feat * od + 2 * n * n * od
    mac += n * d_cat * cfg["num_gw"]
    semantic = widths[0][-1] + od + cfg["base_widths"][-1]
    mac += n * (cfg["num_gw"] + semantic) * cfg["main_dim"]
    mac += 3 * n * cfg["main_dim"] * cfg["total_classes"]
    mac += n * cfg["num_gw"] * cfg["total_classes"]
    return 2.0 * mac


def knn_flops(cfg, n):
    """The kNN Gram matrices' share of `flops`: they carry no gradient."""
    widths = [list(w) for w in cfg["edgeconv_widths"]]
    cins = [len(cfg["pc_attribs"])] + [w[-1] for w in widths[:-1]]
    return 2.0 * sum(n * n * cin for cin in cins)
