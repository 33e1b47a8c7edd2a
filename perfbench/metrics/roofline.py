"""An op's least time (``perfbench/roofline``: its inputs read once, its outputs written once, or its
operations at the f32 rate, whichever is longer) over the device time of every non-NCCL activity
that the window's ops ran, on the rank with the most device time, in percent."""


def read(rec):
    peaks = rec.get("peaks")
    if not peaks or not rec["ops"]:
        return None
    from perfbench.roofline.counts import least_seconds

    shares = []
    for r in rec["ranks"]:
        t = r.get("trace")
        if not t or t["compute_s"] <= 0:
            return None
        least = least_seconds(r["work"]["flops"], r["work"]["bytes"], peaks)
        shares.append((t["compute_s"], 100.0 * rec["ops"] * least / t["compute_s"]))
    return max(shares)[1] if shares else None
