"""Share of the traced part's battery calls that replayed the battery's
CUDA graph: the program's counters ``battery_graph_replays`` over it plus
``battery_eager``, in percent. A program without those counters reads
nothing."""

from portbench.program_spans import summary


def read(run):
    spans = summary()
    replays = spans.get("battery_graph_replays", {}).get("count", 0)
    eager = spans.get("battery_eager", {}).get("count", 0)
    return 100.0 * replays / (replays + eager) if replays + eager else None
