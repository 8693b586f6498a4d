"""Host ms a sweep after its last batch (the program's span
`sweep/sweep.tail`: the confusion counts to the host, each seed's mIoU),
in the untraced loop."""
from program_spans import ms_per


def read(s):
    return ms_per("sweep/sweep.tail")
