"""Products a second of the set-up's catalog encode: the catalog's size
over the host seconds of ``TextEncoder.encode_resident`` from text, with a
device sync before and after."""


def read(name, reading):
    rec = reading.window.records
    if not rec.get("encode_s"):
        return None
    return rec["n_catalog"] / rec["encode_s"]
