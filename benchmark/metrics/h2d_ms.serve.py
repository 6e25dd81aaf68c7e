"""h2d_ms.serve: device time of the host-to-device copies a request, from
the profiler's memcpy rows in the traced window."""


def read(r):
    if r.trace is None or r.phase != "serve" or not r.units:
        return None
    copies, seconds = r.trace.copies("HtoD")
    return seconds * 1e3 / r.units if copies else None
