"""Streaming engine layer: host ms per tile in the ring's staging copy
(``_Ring.stage``), the wait for the slot's last upload included; the
probe's wrappers over the traced window."""


def read(ctx):
    t = ctx.traced
    n = t.probe_calls.get("stage", 0)
    return 1e3 * t.probe_seconds["stage"] / n if n else None
