"""Host ms a batch in the eval loader (`eval_batches`: memmap slice,
label lookup, padding): the benchmark's span around each next()."""


def read(s):
    return s.host_ms("eval.loader")
