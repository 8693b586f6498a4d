"""The device's idle share of the pre-training cell's traced stretch:
1 - the union of its operations' intervals / the stretch, in %."""


def read(s):
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 else None
