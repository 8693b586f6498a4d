"""Host ms a step in Adam's step and the LR schedule (the program's span
`train_step/optimizer`), in the untraced loop."""
from program_spans import ms_per


def read(s):
    return ms_per("train_step/optimizer", per="train_step")
