"""Per-layer metric readers, one file each, found by the metric's name (or
by its family, the part before the first dot). Each has ``read(name,
reading)``, which returns the number, or None where the run holds nothing
to read: a share of a roofline or of a peak is never 0 for want of data."""
