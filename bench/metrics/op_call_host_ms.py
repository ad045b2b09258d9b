"""``op_call_host_ms``: the host's time inside one call of the op layer
(``repro_torch/core/batch_ops.py``), from the harness's own clock around
each call of the window, as a mean. The calls enqueue work and return; the
time is what the host spends issuing it."""


def read(ctx):
    calls = ctx["calls"]
    if not calls:
        return None
    return 1e-6 * sum(c[3] - c[2] for c in calls) / len(calls)
