"""Host ms of one ``Engine.pick`` (the ray, K2.1 and the hit record back on
the host): the benchmark's span around each pick of the traced run's
window, their mean."""


def read(ctx):
    ms = ctx.get("pick_ms")
    return sum(ms) / len(ms) if ms else None
