"""Host ms a call of the train step (`gfs_train_step`: the program's span
`train_step`), in the untraced loop: the host's time to queue one step's
forward, backward and optimizer."""
from program_spans import ms_per


def read(s):
    return ms_per("train_step")
