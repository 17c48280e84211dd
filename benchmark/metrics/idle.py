"""The device's idle share of the traced window, in %: the part of its wall
time in which no kernel, copy or fill ran (the profiler's trace)."""


def read(name, reading):
    tr = reading.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
