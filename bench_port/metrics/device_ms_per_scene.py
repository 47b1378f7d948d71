"""Device time a scene: the union of device-operation intervals in the
traced part, in milliseconds, over the scenes whose fits it completed."""


def read(readings):
    window = readings.window
    if window.summary is None or window.traced_scenes == 0:
        return None
    return 1e3 * window.summary.busy_s / window.traced_scenes
