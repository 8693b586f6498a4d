"""Host ms of the sweep's host-to-device copies a batch: the program's
spans `sweep/h2d` (`pipelines/gfs.py::_to`: a host copy, then a pageable
`.to`) over the calls of `sweep/eval_step`, in the untraced loop."""
from program_spans import ms_per


def read(s):
    return ms_per("sweep/h2d", per="sweep/eval_step")
