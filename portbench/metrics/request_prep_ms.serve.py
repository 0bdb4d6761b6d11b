"""Host milliseconds per traced request inside the program's ``prepare``
spans (routing, the latent and seed, the graph lookup, the buffer fills)."""

from portbench.program_spans import per_request, summary, total_ms


def read(run):
    spans = summary()
    return per_request(run, spans, total_ms(spans, ("prepare",)))
