"""Mean ``d_reg_step`` milliseconds of ``GeneratorTrainer.step_times`` over
the window's ``profile_steps`` cadence."""


def read(run):
    t = run["step_times"]["d_reg_step"]
    return sum(t) / len(t) if t else None
