"""Host milliseconds per traced iteration inside the program's
``optimizer`` (each ``optimizer_step``) and ``ema`` spans (the EMA update
of ``g_step``; the copy and the delta of ``g_reg_step``)."""

from portbench.program_spans import per_iteration, summary, total_ms


def read(run):
    return per_iteration(run, total_ms(summary(), ("optimizer", "ema")))
