"""Host milliseconds per traced iteration inside the program's battery
spans: ``battery`` (the whole ``_attr_losses_for_batch`` call in ``g_step``)
and each ``battery.<net>`` outside it (the nets' recompute in the
backward), so their union."""

from portbench.program_spans import per_iteration, summary


def read(run):
    spans = summary()
    nets = [s for name, s in spans.items() if name.startswith("battery.")]
    if "battery" not in spans and not nets:
        return None
    ms = spans["battery"]["total_ms"] if "battery" in spans else 0.0
    ms += sum(t for s in nets for parent, t in s["under"].items()
              if parent != "battery" and not (parent or "").startswith("battery."))
    return per_iteration(run, ms)
