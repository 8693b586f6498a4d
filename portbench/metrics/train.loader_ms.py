"""Host ms a step waiting in next() of the training feed
(`train_batches`, the native pool)."""


def read(s):
    return s.host_ms("train.loader")
