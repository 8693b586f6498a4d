"""Host ms a step in `loss.backward()` (the program's span
`train_step/backward`), in the untraced loop."""
from program_spans import ms_per


def read(s):
    return ms_per("train_step/backward", per="train_step")
