"""The FFD scan kernel's share of its roofline on the sweep path: the
least time the card could take for the launches of the traced sub-window
(lib/roofline.py) over the kernel's device time in the profiler's
trace. None unless the trace holds every launch the port counted (layer:
kernel)."""


def read(ctx):
    t = ctx.trace
    if ctx.entry != "sweep" or t is None or not t.get("complete"):
        return None
    if not t["scan_s"] > 0:
        return None
    ctx.log(f"ffd bound {t['bound_s']!r} s ({t['bound_by']}) against"
            f" {t['scan_s']!r} s of kernel over {t['scans']} launches")
    return 100.0 * t["bound_s"] / t["scan_s"]
