"""K2, `fused_attention(q, k, v, temperature)`: softmax(q k^T / t) v."""


def shapes(args, kwargs):
    q, k = args[0], args[1]
    return {"batch": q.shape[0], "queries": q.shape[1], "keys": k.shape[1],
            "d": q.shape[2]}


def count(batch, queries, keys, d):
    fmas = 2 * batch * queries * keys * d
    floats = 2 * batch * queries * d + 2 * batch * keys * d
    return fmas, 4 * floats
