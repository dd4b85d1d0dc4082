"""Work reckonings: `work/<name>.py` gives `work(ctx, req) -> (int32
operations, bytes)` of what one request's inputs need, whatever the
program does. A roofline share divides the bound of that work by the
device time the trace shows."""
