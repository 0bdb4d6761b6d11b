"""Device milliseconds per bucket-64 request: the union of the device
intervals inside the benchmark's span ``generate.b64`` around each such
traced request, averaged over them."""


def read(run):
    spans = run["trace"]["spans"].get("generate.b64", [])
    return 1e3 * sum(spans) / len(spans) if spans else None
