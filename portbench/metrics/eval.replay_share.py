"""Share of the eval step's calls (the program's span `sweep/eval_step`)
whose model call replayed a captured CUDA graph (its counter
`sweep/eval_step/graph_replays`), in the untraced loop; None for a program
that captures none."""
from program_spans import counter_per


def read(s):
    return counter_per("sweep/eval_step/graph_replays", per="sweep/eval_step")
