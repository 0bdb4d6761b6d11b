"""Host milliseconds per traced request inside the program's ``copy_out``
spans (the request's rows copied from the card to numpy; the replay before
it has synchronised)."""

from portbench.program_spans import per_request, summary, total_ms


def read(run):
    spans = summary()
    return per_request(run, spans, total_ms(spans, ("copy_out",)))
