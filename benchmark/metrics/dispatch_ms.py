"""Mean host milliseconds from a ``TrainStep`` call to its return, before
any sync, over the window: the benchmark's span around each call."""


def read(name, reading):
    spans = reading.window.records.get("train_step_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
