"""Classifier layer: host ms per recording spent in ``analyze_samples`` /
``embed_samples`` outside ``StreamingEngine.analyze`` (building the
per-segment results); the probe's wrappers over the traced window."""


def read(ctx):
    t = ctx.traced
    n = t.probe_calls.get("classifier", 0)
    if not n or "engine" not in t.probe_seconds:
        return None
    return 1e3 * (t.probe_seconds["classifier"] - t.probe_seconds["engine"]) / n
