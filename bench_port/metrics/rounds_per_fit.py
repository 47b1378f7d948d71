"""Mean `Statistics.rounds_run` of the window's single-scene fits (the
entry point's own count of the rounds of the engine, with_statistics)."""


def read(readings):
    rounds = readings.window.rounds
    if not rounds:
        return None
    return sum(rounds) / len(rounds)
