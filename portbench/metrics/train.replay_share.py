"""Share of the train step's calls (the program's span `train_step`) that
replayed a captured CUDA graph (its counter `train_step/graph_replays`),
in the untraced loop; None for a program that captures none."""
from program_spans import counter_per


def read(s):
    return counter_per("train_step/graph_replays", per="train_step")
