"""Traffic kinds: `traffic/<kind>.py` serves request i of a cell through
`serve(ctx, i, log)`; the harness runs them back to back (one client, a
closed loop) for the window, or a fixed number under the profiler."""
