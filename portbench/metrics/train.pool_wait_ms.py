"""Host ms a batch waiting on the native C++ pool's queue (the program's
top-level span `pool.get`, around `bl_pool_get`), in the untraced loop."""
from program_spans import ms_per


def read(s):
    return ms_per("pool.get")
