"""captures_in_window: CUDA graphs captured during the window
(`Segments.captures` across it); 0 when set-up warmed every key."""


def read(run):
    return float(run.captures)
