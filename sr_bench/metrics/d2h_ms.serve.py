"""Device milliseconds a request of the device-to-host copies (the output's
return) in the traced window."""


def read(r):
    if r.timeline is None or not r.requests:
        return None
    t = r.timeline.device_s(lambda n: "dtoh" in n.lower())
    return t * 1e3 / len(r.requests) if t > 0 else None
