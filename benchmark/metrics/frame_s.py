"""frame_s: the window's wall seconds over the whole render() frames it
finished (each ends with the image on the host)."""


def read(run):
    if run.config["entry"] != "render":
        return None
    return run.window_s / len(run.frames)
