"""Audio frames completed over the window: codes made and vocoded to PCM on
the host, all the window's finished requests over all its seconds (46.4 ms of
audio a frame)."""


def read(run):
    return run.win["frames_done"] / run.window_s if run.window_s > 0 else None
