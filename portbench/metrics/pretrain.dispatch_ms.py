"""Host ms a call of the pre-training step (`pretrain_step`: the
program's span `pretrain_step`), in the untraced loop: the host's time to
queue one step (a replay since the graph's capture, the eager forward,
backward and optimizer before it)."""
from program_spans import ms_per


def read(s):
    return ms_per("pretrain_step")
