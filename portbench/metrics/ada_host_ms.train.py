"""Host milliseconds per traced iteration inside the program's ``ada`` spans
(each ``augment_fn`` call: two in ``d_step``, one in ``g_step``)."""

from portbench.program_spans import per_iteration, summary, total_ms


def read(run):
    return per_iteration(run, total_ms(summary(), ("ada",)))
