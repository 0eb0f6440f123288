"""The search path's kernel entries' share of their roofline, in percent:
the least time their calls in the traced part need (``roofline.py``, from
each call's operand shapes) over the device time of the kernels those calls
launched."""


def read(obs):
    tr = obs.get("trace")
    if tr is None or tr["entry_device_s"] <= 0:
        return None
    return 100.0 * tr["entry_least_s"] / tr["entry_device_s"]
