"""K4b, the backward of `fused_edgeconv_train(a, b, gamma1, beta1, w2,
gamma2, beta2, idx, ...)` from the shapes of its forward call: over every
edge the two products of the second layer's backward, dW2 = h1^T dz2 and
dh1 = dz2 w2^T. It reads a, b, idx, w2, the output's gradient and the
forward's selected slots (B, N, W1) once, and writes the tables'
gradients and dW2."""


CALLS_OF = "k4a"      # the forward call whose backward this is


def shapes(args, kwargs):
    a, w2, idx = args[0], args[4], args[7]
    return {"batch": a.shape[0], "n": a.shape[1], "w0": w2.shape[0],
            "w1": w2.shape[1], "k": idx.shape[2]}


def count(batch, n, w0, w1, k):
    edges = batch * n * k
    fmas = 2 * edges * w0 * w1
    floats = (2 * batch * n * w0 + edges + w0 * w1 + 2 * batch * n * w1
              + 2 * batch * n * w0 + w0 * w1)
    return fmas, 4 * floats
