"""Host ms a frame from the tick's start until ``render_frame`` returns,
before the watchdog's synchronise: the benchmark's span, over every frame
of the traced run's window."""


def read(ctx):
    ms = ctx.get("engine_host_ms")
    return sum(ms) / len(ms) if ms else None
