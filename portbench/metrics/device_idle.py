"""Share of the traced window in which no operation runs on the device
(kernels, copies and fills), in percent."""


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
