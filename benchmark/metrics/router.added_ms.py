"""Milliseconds between the serving backend and the client on a /stream
request's way to its first audio, which the router's hop adds to: the mean,
over the requests whose first byte came before the traced slice, of the
client's first byte − the moment the serving backend's wrapper handed the
request's first chunk to the server's HTTP layer, both on the host's
monotonic clock."""


def read(ctx):
    d = [r["first"] - r["handed"] for r in ctx.requests if r["first"] is not None and r["handed"] is not None]
    return 1e3 * sum(d) / len(d) if d else None
