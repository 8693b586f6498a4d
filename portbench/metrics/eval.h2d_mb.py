"""MB copied to the device a batch in the sweep: the program's counter
`sweep/h2d_bytes` over the calls of `sweep/eval_step`, / 1e6."""
from program_spans import counter_per


def read(s):
    v = counter_per("sweep/h2d_bytes", per="sweep/eval_step")
    return None if v is None else v / 1e6
