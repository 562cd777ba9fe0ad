"""cli_frame_s: the window's wall seconds over the whole cli.main calls it
finished (load, env table, render, denoise, PNG write)."""


def read(run):
    if run.config["entry"] != "cli":
        return None
    return run.window_s / len(run.frames)
