"""Mean host milliseconds of one ``encode_batch`` call of the port's
tokenizer on a batch, from the benchmark's span around it, over the
window."""


def read(name, reading):
    spans = reading.window.records.get("tokenize_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
