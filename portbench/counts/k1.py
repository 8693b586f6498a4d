"""K1, `fused_edgeconv_infer(x, a_table, b_table, w2, bias2, k)`: the kNN
graph of x among the keys, the edge stage leaky(a[j] + b[i]) @ w2 + bias2,
leaky, max over the k neighbours."""


def shapes(args, kwargs):
    x, a, b, w2 = args[0], args[1], args[2], args[3]
    return {"batch": x.shape[0], "keys": x.shape[1], "queries": b.shape[1],
            "c": x.shape[2], "w0": w2.shape[0], "w1": w2.shape[1],
            "k": int(args[5] if len(args) > 5 else kwargs["k"])}


def count(batch, keys, queries, c, w0, w1, k):
    if queries == keys:     # the Gram matrix of x with itself, once
        gram = batch * keys * (keys + 1) // 2 * c
    else:
        gram = batch * queries * keys * c
    fmas = gram + batch * queries * k * w0 * w1
    floats = (batch * keys * (c + w0) + batch * queries * w0 + w0 * w1 + w1
              + batch * queries * w1)
    return fmas, 4 * floats
