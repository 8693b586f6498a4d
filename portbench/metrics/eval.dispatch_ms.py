"""Host ms a call of the eval step (`gfs_eval_multi_step`: the program's
span `sweep/eval_step`), in the untraced loop: the host's time to queue
one batch's forward, heads and confusion counts."""
from program_spans import ms_per


def read(s):
    return ms_per("sweep/eval_step")
