"""peak_mem_gb: the most device memory allocated in the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in 1e9
bytes."""

SPANS = {}


def read(rec):
    return rec.peak_bytes / 1e9 if rec.peak_bytes else None
