"""K3, `knn_with_stats(x, btab, k)`: the kNN graph of x, each point's
in-degree and the scatter of btab over the graph. The graph's int32
indices and the (B, 1, N) counts are written once."""


def shapes(args, kwargs):
    x, btab = args[0], args[1]
    return {"batch": x.shape[0], "n": x.shape[1], "c": x.shape[2],
            "cb": btab.shape[2],
            "k": int(args[2] if len(args) > 2 else kwargs["k"])}


def count(batch, n, c, cb, k):
    fmas = batch * n * (n + 1) // 2 * c
    floats = batch * n * (c + cb) + batch * n * (k + 1 + cb)
    return fmas, 4 * floats
