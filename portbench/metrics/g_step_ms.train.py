"""Mean ``g_step`` milliseconds of ``GeneratorTrainer.step_times`` (a device
sync around each step) over the window's ``profile_steps`` cadence."""


def read(run):
    t = run["step_times"]["g_step"]
    return sum(t) / len(t) if t else None
