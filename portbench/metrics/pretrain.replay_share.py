"""Share of the pre-training step's calls (the program's span
`pretrain_step`) that replayed a captured CUDA graph (its counter
`pretrain_step/graph_replays`), in the untraced loop; None for a program
that has no such span or counter."""
from program_spans import counter_per


def read(s):
    return counter_per("pretrain_step/graph_replays", per="pretrain_step")
