"""``torch.cuda.max_memory_allocated()`` from the process's start to the
window's end, read before the reference runs, in GiB."""


def read(rec):
    return None if rec.peak_bytes is None else rec.peak_bytes / 2 ** 30
